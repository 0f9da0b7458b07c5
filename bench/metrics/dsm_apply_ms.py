"""Mean host time of one ``dsm_batch`` call in the maintenance hook, over
the window."""


def read(run, entry):
    calls = run.window_hook_calls()
    if not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in calls) / len(calls)
