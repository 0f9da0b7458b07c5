"""Measure one offered rate of an open-loop cell, in a process of its own.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> --rate <r>

Sets the cell up, offers ``--rate`` requests a second for ``--seconds``
(its other streams, such as DSM, run beside it as the cell states) and
prints one JSON line: the rate achieved, the p50 and p95 latency from the
scheduled arrival, the p95 of the first and the last third of the
arrivals, and ``growing``: whether the backlog grew (the last third's
median latency more than twice the first third's plus 20 ms, under 95% of
the offered rate answered inside the window, or any request shed or
failed). Run it once per rate, each in a new process, so that no rate
inherits the warm caches of another; the cell's fixed rate is 4/5 of the
highest rate that did not grow.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rate", type=float, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["USE_FLAX"] = "0"
    from bench import harness
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload,
                             harness.with_workload(args.workload))
    for s in spec["workload"]["streams"]:
        if s["kind"] == "open_loop":
            s["qps"] = args.rate
    run = harness.Run(spec, args.seed, args.seconds, False, "cuda")
    run.setup()
    run.window()
    lat = run.ok_latencies()
    n = len(lat)
    third = max(n // 3, 1)
    first, last = lat[:third], lat[-third:]
    achieved = run.dsq_completed_in_window() / run.seconds
    counts = run.counts()
    growing = bool(n == 0 or np.median(last) > 2 * np.median(first) + 0.02
                   or achieved < 0.95 * args.rate or counts["failed"] > 0)
    dsm = run.dsm_latencies()

    def p(x, q):
        return float(np.percentile(x, q) * 1e3) if len(x) else None
    print(json.dumps({
        "workload": args.workload, "rate": args.rate, "achieved": achieved,
        "growing": growing, "p50_ms": p(lat, 50), "p95_ms": p(lat, 95),
        "p95_first_ms": p(first, 95), "p95_last_ms": p(last, 95),
        "dsm_p95_ms": p(dsm, 95), "late_p99_ms": p(run.lateness, 99),
        "failed": counts["failed"], "batches": len(run.batches),
        "gc_full_s": [d for a, d in run.gc_pauses if run.in_window(a)]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
