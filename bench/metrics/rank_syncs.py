"""Mean number of the executor's copies back to the host a batch
(``BatchAccounting.rank_syncs``), each of which waits for the device. A
program without the counter reports nothing."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    vals = [a.rank_syncs for a in accts if hasattr(a, "rank_syncs")]
    if not vals:
        return None
    return sum(vals) / len(vals)
