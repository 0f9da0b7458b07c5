"""DSQ answers completed inside the window over the window's seconds."""


def read(run, entry):
    return run.dsq_completed_in_window() / run.seconds
