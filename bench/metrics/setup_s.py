"""Set-up: from the start of the process to the start of the window
(generation, ingest and upload, quantisation, the warm-up batch and the
first seconds of live traffic)."""


def read(run, entry):
    return run.setup_s
