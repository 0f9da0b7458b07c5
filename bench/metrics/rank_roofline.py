"""The traced batches' roofline bound (``bench/roofline.py``, from the
reference's scope sets) over the device time of every kernel launched in
their ranking spans, in percent. Nothing to read, nothing reported."""


def read(run, entry):
    info = getattr(run, "trace_info", None)
    if info is None:
        return None
    bounds = run.batch_bounds()
    ids = [i for i in info.batch_ids if info.rank_s.get(i, 0.0) > 0.0]
    spent = sum(info.rank_s[i] for i in ids)
    if spent <= 0.0:
        return None
    return 100.0 * sum(bounds[i] for i in ids) / spent
