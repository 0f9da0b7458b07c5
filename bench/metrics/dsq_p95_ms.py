"""95th percentile of every DSQ request that arrived in the window, from
its scheduled arrival to its answer; a failed or shed request counts as
waiting until the drain ended."""
import numpy as np


def read(run, entry):
    lat = run.dsq_latencies()
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
