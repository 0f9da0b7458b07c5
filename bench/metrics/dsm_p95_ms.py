"""95th percentile of every DSM op that arrived in the window, from its
scheduled arrival to its acknowledgement (``dsm_batch`` returned, the
journal written)."""
import numpy as np


def read(run, entry):
    lat = run.dsm_latencies()
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
