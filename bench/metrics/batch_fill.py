"""Mean requests per executed batch over the scheduler's ``max_batch``, in
percent (``BatchAccounting.batch_size``)."""


def read(run, entry):
    sizes = [b.acct.batch_size for b in run.window_batches()
             if b.acct is not None]
    if not sizes:
        return None
    cap = run.cfg["scheduler"]["max_batch"]
    return 100.0 * sum(sizes) / len(sizes) / cap
