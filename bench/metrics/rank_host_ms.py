"""Mean host time a batch spends preparing, uploading and dispatching its
ranking work (``BatchAccounting.rank_host_ns``: the executor's
``rank.put`` and ``rank.run`` phases, inside ``ann_ns``). A program
without the counter reports nothing."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    vals = [a.rank_host_ns for a in accts if hasattr(a, "rank_host_ns")]
    if not vals:
        return None
    return sum(vals) / len(vals) / 1e6
