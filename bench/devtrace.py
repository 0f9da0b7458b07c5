"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a steady
stretch of the window, read from its Chrome trace.

* busy: the union of the device's kernel, copy and set intervals inside the
  stretch, and the stretch's length (the ``bench.traced`` span);
* each batch's ranking kernels: the kernels whose launch (a runtime call
  with the kernel's correlation id) lies, on the executing thread, inside a
  ``dsq.rank`` span of that batch's ``bench.batch#<i>`` span;
* the breakdown: the device operations that took most time, and the idle
  gaps summed by the spans the host was inside;
* the kernel count against the program's own launch counters, since the
  profiler has dropped kernel events before.
"""
from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
MARK = "bench.traced"
BATCH = "bench.batch#"


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _scan_launches(counts: Dict[str, int]) -> int:
    return sum(v for k, v in counts.items()
               if k not in ("bitmap_patch", "mask_and_popcount",
                            "flash_decode"))


def warm(torch, device) -> None:
    """One short profile at set-up: the first one in a process starts the
    device tracer, which takes seconds."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()


class TraceInfo:
    def __init__(self, busy_s, window_s, ops, gaps, rank_s, launches):
        self.busy_s = busy_s
        self.window_s = window_s
        self.ops = ops                  # name -> device seconds
        self.gaps = gaps                # host spans -> idle seconds
        self.rank_s = rank_s            # batch index -> ranking kernel s
        self.launches = launches
        self.batch_ids = sorted(rank_s)
        self.start_s = 0.0

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def summary(self) -> dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "batches": len(self.batch_ids), "launches": self.launches,
                "start_s": self.start_s}


class Window:
    def __init__(self, torch, run):
        self.torch = torch
        self.run = run
        self.prof = self.mark = None

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import ops
        self.launch0 = _scan_launches(ops.launch_counts())
        # the spans open on the scheduler's threads, not on this one
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()
        self.mark = self.torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        from repro_torch.kernels import ops
        if self.run.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.launch1 = _scan_launches(ops.launch_counts())

    def read(self) -> TraceInfo:
        tmp = Path(os.environ.get("TMPDIR") or "/tmp")
        path = tmp / f"bench-trace-{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        info = parse(events, self.launch1 - self.launch0)
        info.start_s = getattr(self, "started_s", 0.0)
        return info


def parse(events: list, launched: int) -> TraceInfo:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    mark = [e for e in xs if e.get("name") == MARK
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the traced stretch's span is missing")
    w0 = float(mark[0]["ts"])
    w1 = w0 + float(mark[0]["dur"])
    dev, kern_of = [], {}
    ops: Dict[str, float] = defaultdict(float)
    pass1 = 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        corr = e.get("args", {}).get("correlation")
        if e["cat"] == "kernel" and corr is not None:
            kern_of[corr] = kern_of.get(corr, 0.0) + (b - a)
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        ops[e["name"]] += (b - a) / 1e6
        pass1 += int(e["cat"] == "kernel" and "scan_pass1" in e["name"])
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6

    ann = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") != MARK]
    runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS]
    # launches per thread, sorted by time
    launches: Dict[object, List[Tuple[float, object]]] = defaultdict(list)
    for e in runtime:
        corr = e.get("args", {}).get("correlation")
        if corr in kern_of:
            launches[e.get("tid")].append((float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    rank_spans: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
    for e in ann:
        if e["name"] == "dsq.rank":
            a = float(e["ts"])
            rank_spans[e.get("tid")].append((a, a + float(e["dur"])))
    rank_s: Dict[int, float] = {}
    for e in ann:
        if not e["name"].startswith(BATCH):
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if a < w0 or b > w1:
            continue
        tid = e.get("tid")
        total = 0.0
        seq = launches.get(tid, [])
        for ra, rb in rank_spans.get(tid, []):
            if ra < a or rb > b:
                continue
            lo = bisect.bisect_left(seq, (ra, -1))
            hi = bisect.bisect_right(seq, (rb, float("inf")))
            total += sum(kern_of[c] for _, c in seq[lo:hi])
        rank_s[int(e["name"][len(BATCH):])] = total / 1e6

    # idle gaps, each named by the spans open at its midpoint (a sweep)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = sorted((0.5 * (a + b), b - a)
                   for a, b in zip(edges[::2], edges[1::2]) if b > a)
    marks = sorted([(float(e["ts"]), 1, e["name"].split("#")[0])
                    for e in ann]
                   + [(float(e["ts"]) + float(e["dur"]), -1,
                       e["name"].split("#")[0]) for e in ann])
    active: Dict[str, int] = defaultdict(int)
    j = 0
    for mid, length in holes:
        while j < len(marks) and marks[j][0] <= mid:
            active[marks[j][2]] += marks[j][1]
            j += 1
        names = sorted(n for n, c in active.items() if c > 0)
        gaps["+".join(names) or "no span"] += length / 1e6
    return TraceInfo(busy_s, (w1 - w0) / 1e6, dict(ops), dict(gaps), rank_s,
                     {"launch_counters": launched, "trace_scan_pass1": pass1})
