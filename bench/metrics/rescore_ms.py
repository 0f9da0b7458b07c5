"""Mean host time a batch spends in the exact fp32 rescore of the
quantized plan (``BatchAccounting.rescore_ns``, the ``rank.rescore``
regions of ``gather_rescore``, inside ``ann_ns``). A program without the
counter reports nothing."""


def read(run, entry):
    accts = [b.acct for b in run.window_batches() if b.acct is not None]
    vals = [a.rescore_ns for a in accts if hasattr(a, "rescore_ns")]
    if not vals:
        return None
    return sum(vals) / len(vals) / 1e6
