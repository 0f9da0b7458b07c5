"""Mean number of gather groups a batch ranks with one executor call each
(``BatchAccounting.gather_alone``: int8 / PQ gather groups and those of a
tiered store; the complement of ``gather_listed``). A program without the
counter reports nothing."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    vals = [a.gather_alone for a in accts if hasattr(a, "gather_alone")]
    if not vals:
        return None
    return sum(vals) / len(vals)
