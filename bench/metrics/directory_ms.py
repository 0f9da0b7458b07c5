"""Mean host time a batch spends resolving and planning its scopes
(``BatchAccounting.directory_ns``)."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    if not accts:
        return None
    return sum(a.directory_ns for a in accts) / len(accts) / 1e6
