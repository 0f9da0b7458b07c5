"""Mean admission-queue wait a request (``BatchAccounting.sched_queue_ns``
summed over the window's batches, over their requests)."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    n = sum(a.batch_size for a in accts)
    return sum(a.sched_queue_ns for a in accts) / n / 1e6 if n else None
