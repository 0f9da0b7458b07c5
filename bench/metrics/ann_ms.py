"""Mean host time a batch spends ranking (``BatchAccounting.ann_ns``; the
answers are copied back to the host inside it, so it waits for the
device)."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    if not accts:
        return None
    return sum(a.ann_ns for a in accts) / len(accts) / 1e6
