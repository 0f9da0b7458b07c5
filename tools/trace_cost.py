#!/usr/bin/env python3
"""What a recording profiler costs the scheduled batch path on one card.

    python3 tools/trace_cost.py --label change
    python3 tools/trace_cost.py --label parent --src <other checkout>/src

Sets a benchmark cell up as ``bench/run.py`` does (its database at the
configuration's size, from ``--seed``), then pumps full batches of the
cell's query pool through its ``ScheduledDSQ`` (form, stage and execute on
this thread), in alternating rounds with no profiler and with a recording
``torch.profiler`` (CPU and CUDA activity on every thread, as a traced
benchmark run records). ``--src`` picks the ``repro_torch`` to run (this
checkout's ``src`` by default); ``bench/`` is this checkout's. Prints one
JSON line: the label, the card's name and power limit, and for each mode
the median and quartiles over the batches of ``ann_ns`` (ms), the batch's
wall time (ms) and, where the program has them, the executor's phase
counters. Compare two trees only within one call, each in its own process.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("rank_host_ns", "rank_wait_ns", "rank_syncs")


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return {"median": q2, "q1": q1, "q3": q3, "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--workload", default="wiki-fp32.dsq-sat")
    ap.add_argument("--seed", type=int, default=2700000001)
    ap.add_argument("--batch", type=int, default=168)
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from bench import devtrace, harness

    run = harness.Run(harness.cell_spec(args.workload), args.seed, 1.0,
                      False, device="cuda", out=sys.stderr)
    run.setup()
    devtrace.warm(torch, run.device)
    sdsq, pool = run.sdsq, run.pool
    nxt = [0]

    def one_batch() -> dict:
        tickets = []
        for _ in range(args.batch):
            i = int(run.order[nxt[0] % len(run.order)])
            nxt[0] += 1
            tickets.append(sdsq.submit(pool.vectors[i], pool.anchors[i],
                                       recursive=bool(pool.recursive[i])))
        t0 = time.perf_counter()
        served = sdsq.pump()
        wall = time.perf_counter() - t0
        if served != args.batch:
            raise RuntimeError(f"pumped {served} of {args.batch} requests")
        acct = tickets[0].result(timeout=60.0).batch
        rec = {"ann_ms": acct.ann_ns / 1e6, "batch_ms": wall * 1e3}
        for name in COUNTERS:
            if hasattr(acct, name):
                v = getattr(acct, name)
                if name.endswith("_ns"):
                    rec[name[:-3] + "_ms"] = v / 1e6
                else:
                    rec[name] = v
        return rec

    per_round = args.batches // args.rounds
    recs = {"off": [], "on": []}
    for r in range(args.rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            prof = None
            if mode == "on":
                prof = profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    experimental_config=_ExperimentalConfig(
                        profile_all_threads=True))
                prof.start()
            for _ in range(per_round):
                recs[mode].append(one_batch())
            if prof is not None:
                torch.cuda.synchronize()
                prof.stop()
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"label": args.label, "package": repro_torch.__file__,
           "card": limit.strip(), "batch": args.batch}
    for mode, rs in recs.items():
        out[mode] = {key: quartiles([x[key] for x in rs])
                     for key in rs[0]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
