"""Mean host time a batch spends in the executor's copies back to the host
(``BatchAccounting.rank_wait_ns``, the ``rank.get`` phase, inside
``ann_ns``): each copy waits for the device work queued before it. A
program without the counter reports nothing."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    vals = [a.rank_wait_ns for a in accts if hasattr(a, "rank_wait_ns")]
    if not vals:
        return None
    return sum(vals) / len(vals) / 1e6
