"""Mean host time a batch spends in phase 1 of the quantized plan
(``BatchAccounting.approx_ns``, the executor's ``rank.approx`` regions:
the int8 / PQ scan or gather launches and the wait for their candidates,
inside ``ann_ns``). A program without the counter reports nothing."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    vals = [a.approx_ns for a in accts if hasattr(a, "approx_ns")]
    if not vals:
        return None
    return sum(vals) / len(vals) / 1e6
