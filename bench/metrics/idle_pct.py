"""Share of the traced stretch in which no kernel, copy or set ran on the
device, in percent."""


def read(run, entry):
    info = getattr(run, "trace_info", None)
    if info is None or info.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - info.busy_s / info.window_s)
