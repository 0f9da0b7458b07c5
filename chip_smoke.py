#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # WIKI-Dir at its published size
    python3 chip_smoke.py --scale 0.5     # the documented cut, if needed

Phases (each prints one JSON line; any failure exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of the four CUDA kernels from ``src/repro_torch/kernels/csrc``;
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at the CPU tests' edge shapes, with its median time,
   its bound, the plain version's time and a library yardstick;
2. the main path: WIKI-Dir ingested into ``DirectoryVectorDB(device="cuda")``
   with TrieHI and the flat executor, a 64-request ``dsq_batch`` mix held
   bitwise against a loop of ``dsq``, and recall@10 against a brute force;
3. DSM: 21 structural ops through ``dsm_batch`` with a journal, patching the
   cached device scope masks, then batch == loop == uncached batch again.

The last lines are the kernels' summary, then
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TOL = 1e-5

# data-sheet peaks (NVIDIA): HBM bytes/s and non-tensor fp32 FLOP/s
CARD_PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H100": (3.35e12, 67e12)}

REPLACES = {
    "scoped_topk": "src/repro/kernels/scoped_topk.py:55",
    "multi_scope_topk": "src/repro/kernels/scoped_topk.py:87",
    "bitmap_patch": "src/repro/kernels/bitmap_ops.py:36",
    "mask_and_popcount": "src/repro/kernels/bitmap_ops.py:19",
}
SOURCES = {
    "scoped_topk": "src/repro_torch/kernels/csrc/scoped_topk.cu",
    "multi_scope_topk": "src/repro_torch/kernels/csrc/scoped_topk.cu",
    "bitmap_patch": "src/repro_torch/kernels/csrc/bitmap_ops.cu",
    "mask_and_popcount": "src/repro_torch/kernels/csrc/bitmap_ops.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- timing
def median_ms(torch, fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(torch, fn, runs: int, names=None):
    """Mean device time of one ``fn`` call from ``torch.profiler``: the
    kernels whose name contains one of ``names`` (every kernel when None).
    None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
        if names is None or any(n in e.key for n in names))
    return total_us / runs / 1e3 if total_us > 0 else None


def timed(torch, fn, runs: int, names=None) -> dict:
    """``ms``: median CUDA-event time of one call over ``runs`` calls (the
    device waits for the host's launch inside it, so a tiny kernel reads as
    its launch overhead); ``device_ms``: the profiler's device time of the
    same call (None when the profiler sees none)."""
    return {"ms": median_ms(torch, fn, runs),
            "device_ms": device_ms(torch, fn, runs, names)}


def bound(nbytes: float, flops: float, peaks) -> dict:
    bw, fl = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --------------------------------------------------------------- phase 1
def phase1(torch, ops, ref, peaks) -> dict:
    """Each kernel against its plain version, main shapes + edge shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def topk_case(label, got, want):
        err = ref.topk_disagreement(got[1].cpu().numpy(), got[0].cpu().numpy(),
                                    want[1].cpu().numpy(),
                                    want[0].cpu().numpy(), TOL)
        check(err is None, f"{label}: {err}")
        gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
        check(np.all(gv[gi < 0] == ref.NEG_INF), f"{label}: empty sentinel")
        valid = gi >= 0
        wv = want[0].cpu().numpy()
        return float(np.max(np.abs(gv[valid] - wv[valid]))) if valid.any() \
            else 0.0

    def words_of(dense):                 # (S, n) bool -> (S, ceil(n/32)) i32
        n = dense.shape[1]
        pad = (-n) % 32
        bits = torch.nn.functional.pad(dense.to(torch.int64), (0, pad))
        bits = bits.reshape(dense.shape[0], -1, 32)
        shifts = torch.arange(32, device=dense.device, dtype=torch.int64)
        w = (bits << shifts).sum(-1)
        return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)

    # edge shapes of the CPU sweep: ragged q/n, k vs scope size, ties
    edge = 0
    for q in (1, 5, 8):
        for n in (137, 1024, 2081):
            for k in (1, 10, 40):
                for metric in ("ip", "l2"):
                    d = 16 if n != 1024 else 128
                    Q = torch.randn(q, d, generator=g, device=dev)
                    X = torch.randn(n, d, generator=g, device=dev)
                    X[n // 2] = X[n // 3]                    # duplicated row
                    dense = torch.rand(3, n, generator=g, device=dev) < 0.3
                    dense[1] = False                         # empty scope
                    dense[2, : n - 5] = False                # all-masked tiles
                    sq = ref.row_sq_norms(X)
                    sid = torch.randint(0, 3, (q,), generator=g, device=dev,
                                        dtype=torch.int32)
                    W = words_of(dense)
                    mask = dense[0].to(torch.int8)
                    topk_case(f"scoped_topk q{q} n{n} k{k} {metric}",
                              ops.scoped_topk(Q, X, mask, k, metric, sq),
                              ref.scoped_topk_ref(Q, X, mask, k, metric, sq))
                    topk_case(f"multi_scope_topk q{q} n{n} k{k} {metric}",
                              ops.multi_scope_topk(Q, X, W, sid, k, metric,
                                                   sq),
                              ref.multi_scope_topk_ref(Q, X, W, sid, k, metric,
                                                       sq))
                    edge += 2
    Q = torch.randn(3, 64, generator=g, device=dev)
    X = torch.randn(100_000, 64, generator=g, device=dev)
    ones = torch.ones(100_000, dtype=torch.int8, device=dev)
    topk_case("scoped_topk k=256", ops.scoped_topk(Q, X, ones, 256),
              ref.scoped_topk_ref(Q, X, ones, 256))
    for R, W in ((1, 1), (3, 7), (5, 2049)):
        m = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, W), generator=g,
                          device=dev, dtype=torch.int32)
        dl = torch.randint(-2 ** 31, 2 ** 31 - 1, (W,), generator=g,
                           device=dev, dtype=torch.int32)
        sg = torch.tensor([(i % 3) - 1 for i in range(R)], dtype=torch.int32,
                          device=dev)
        check(torch.equal(ops.bitmap_patch(m, dl, sg),
                          ref.bitmap_patch_ref(m, dl, sg)),
              f"bitmap_patch edge {R}x{W}")
        a, b = m[0], m[-1]
        w1, c1 = ops.mask_and_popcount(a, b)
        w2, c2 = ref.mask_and_popcount_ref(a, b)
        check(torch.equal(w1, w2) and int(c1) == int(c2),
              f"mask_and_popcount edge {W}")
        edge += 2

    # main path shapes: WIKI-Dir n = 1.94M, d = 128; 64 requests, 8 scopes
    n, d, k, B, S = 1_940_000, 128, 10, 64, 8
    n_words = (n + 31) // 32
    X = torch.randn(n, d, generator=g, device=dev)
    X = X / X.norm(dim=1, keepdim=True)
    Q1 = torch.randn(1, d, generator=g, device=dev)
    QB = torch.randn(B, d, generator=g, device=dev)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    dense = torch.rand(S, n, generator=g, device=dev) < torch.linspace(
        0.2, 1.0, S, device=dev)[:, None]
    dense[-1] = True                                       # the root scope
    words = words_of(dense)
    sid = (torch.arange(B, device=dev) % S).to(torch.int32)

    # scoped_topk at q = 1 over every row (the root scan of one dsq)
    err = topk_case("scoped_topk main", ops.scoped_topk(Q1, X, ones, k),
                    ref.scoped_topk_ref(Q1, X, ones, k))
    scan_names = ("scan_pass1", "scan_pass2")
    out["scoped_topk"] = {
        "max_abs_err": err,
        **timed(torch, lambda: ops.scoped_topk(Q1, X, ones, k), 30,
                scan_names),
        "plain_ms": median_ms(
            torch, lambda: ref.scoped_topk_ref(Q1, X, ones, k), 20),
        "library_ms": median_ms(torch, lambda: torch.matmul(Q1, X.T), 30),
        **bound(n * d * 4 + n + d * 4 + k * 8, 2.0 * n * d, peaks),
        "shape": f"q=1 n={n} d={d} k={k} all rows admitted"}

    err = topk_case("multi_scope_topk main",
                    ops.multi_scope_topk(QB, X, words, sid, k),
                    ref.multi_scope_topk_ref(QB, X, words, sid, k))
    admitted = dense.sum(1)[sid.long()].sum().item()
    union = dense.any(0).sum().item()
    out["multi_scope_topk"] = {
        "max_abs_err": err,
        **timed(torch, lambda: ops.multi_scope_topk(QB, X, words, sid, k),
                30, scan_names),
        "plain_ms": median_ms(
            torch, lambda: ref.multi_scope_topk_ref(QB, X, words, sid, k),
            20),
        "library_ms": median_ms(torch, lambda: torch.matmul(QB, X.T), 30),
        **bound(union * d * 4 + S * n_words * 4 + B * (d * 4 + 4 + k * 8),
                2.0 * admitted * d, peaks),
        "shape": f"q={B} n={n} d={d} k={k} scopes={S} "
                 f"admitted_pairs={admitted}"}

    R = 16
    masks = words_of(torch.rand(R, n, generator=g, device=dev) < 0.5)
    delta = words_of(torch.rand(1, n, generator=g, device=dev) < 0.01)[0]
    signs = torch.tensor([(1, -1, 0)[i % 3] for i in range(R)],
                         dtype=torch.int32, device=dev)
    check(torch.equal(ops.bitmap_patch(masks, delta, signs),
                      ref.bitmap_patch_ref(masks, delta, signs)),
          "bitmap_patch main")
    out["bitmap_patch"] = {
        "max_abs_err": 0.0,
        **timed(torch, lambda: ops.bitmap_patch(masks, delta, signs), 50,
                ("patch_kernel",)),
        "plain_ms": median_ms(
            torch, lambda: ref.bitmap_patch_ref(masks, delta, signs), 20),
        "library_ms": None,
        **bound((2 * R * n_words + n_words + R) * 4, R * n_words, peaks),
        "shape": f"R={R} W={n_words}"}

    a, b = masks[0], masks[1]
    w1, c1 = ops.mask_and_popcount(a, b)
    w2, c2 = ref.mask_and_popcount_ref(a, b)
    check(torch.equal(w1, w2) and int(c1) == int(c2), "mask_and_popcount main")
    out["mask_and_popcount"] = {
        "max_abs_err": 0.0,
        **timed(torch, lambda: ops.mask_and_popcount(a, b), 50,
                ("and_popc_kernel", "sum_kernel")),
        "plain_ms": median_ms(
            torch, lambda: ref.mask_and_popcount_ref(a, b), 20),
        "library_ms": None,
        **bound(3 * n_words * 4 + 4, 2 * n_words, peaks),
        "shape": f"W={n_words}"}
    emit({"phase": 1, "edge_cases": edge, "kernels": out})
    return out


# --------------------------------------------------------------- phase 2
def requests(ds, B=64, n_unique=8):
    """The dsq_batch benchmark mix: B requests over 8 anchors incl. "/"."""
    rng = np.random.default_rng(0)
    anchors = list(dict.fromkeys(ds.query_anchors))[:n_unique - 1] + ["/"]
    paths = [anchors[i % len(anchors)] for i in range(B)]
    rec = [bool(i % 3) for i in range(B)]
    queries = ds.queries[rng.integers(0, len(ds.queries), size=B)]
    return queries.astype(np.float32), paths, rec


def same_results(a, b) -> bool:
    return all(np.array_equal(x.ids, y.ids) and np.array_equal(x.scores,
                                                                y.scores)
               and x.scope_size == y.scope_size for x, y in zip(a, b))


def ground_truth(torch, ds, k: int):
    """Brute force over the entries whose directory satisfies each query's
    constraint (prefix match on the path strings, independent of the scope
    index): top-k ids, the k-th score and the scope size per query."""
    index = {}
    inverse = np.fromiter((index.setdefault(p, len(index))
                           for p in ds.entry_paths), np.int64,
                          len(ds.entry_paths))
    inverse = torch.from_numpy(inverse).cuda()
    vecs = torch.from_numpy(ds.vectors).cuda()
    out = []
    for q, anchor, rec in zip(ds.queries, ds.query_anchors,
                              ds.query_recursive):
        hit = np.fromiter(((p.startswith(anchor) if rec else p == anchor)
                           for p in index), bool, len(index))
        hit_t = torch.from_numpy(hit).cuda()
        cand = torch.nonzero(hit_t[inverse]).flatten()
        if len(cand) == 0:
            out.append((np.empty(0, np.int64), -np.inf, 0))
            continue
        scores = torch.mv(vecs[cand], torch.from_numpy(q).cuda())
        top = torch.topk(scores, min(k, len(cand)))
        out.append((cand[top.indices].cpu().numpy(),
                    float(top.values[-1]), len(cand)))
    return out


def recall_at_k(res, gt, k: int) -> float:
    """Tie-tolerant recall: a returned id counts when it is in the brute
    force top-k or scores within TOL of its k-th score."""
    hits = total = 0
    for r, (ids, kth, size) in zip(res, gt):
        check(r.scope_size == size, f"scope size {r.scope_size} != {size}")
        want = min(k, size)
        got = r.ids[0][:want]
        total += want
        hits += sum(1 for i, s in zip(got, r.scores[0][:want])
                    if i in ids or s >= kth - TOL)
    return hits / max(total, 1)


def phase2(torch, args, ops, journal):
    from repro_torch.core.interface import normalize_batch
    from repro_torch.datasets import make_wiki_dir
    from repro_torch.vectordb import (DirectoryVectorDB, ScopeKey,
                                      device_popcount)

    t0 = time.perf_counter()
    ds = make_wiki_dir(scale=args.scale, dim=128, n_queries=64, seed=0)
    t1 = time.perf_counter()
    db = DirectoryVectorDB(dim=128, scope_strategy="triehi",
                           journal_path=journal, calibration=False,
                           device="cuda")
    db.ingest(ds.vectors, ds.entry_paths)
    db.build_ann("flat")
    db.store.device_vectors()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    queries, paths, rec = requests(ds)
    k = 10

    def batched():
        return db.dsq_batch(queries, paths, k=k, recursive=rec)

    def looped():
        return [db.dsq(queries[i], paths[i], k=k, recursive=rec[i])
                for i in range(len(paths))]

    ops.reset_launch_counts()
    ta = time.perf_counter()
    batch = batched()
    tb = time.perf_counter()
    per_batch = ops.launch_counts()
    loop = looped()
    tc = time.perf_counter()
    check(same_results(batch, loop), "dsq_batch != loop of dsq (bitwise)")
    plans = {r.plan for r in batch}
    check({"scan", "gather"} <= plans, f"plans {plans} lack scan or gather")
    acct = batch[0].batch
    # on-device selectivity of every scan group's cached device mask
    scan_keys = list({ScopeKey.from_spec(spec) for spec, r in zip(
        normalize_batch(paths, rec), batch) if r.plan == "scan"})
    scan_groups, _ = db.planner().resolve_scopes(
        db.namespaces["fs"], len(db.store), scan_keys)
    for key, ent in scan_groups.items():
        check(device_popcount(ent.words) == ent.scope_size,
              f"device_popcount != scope_size for {key}")
    counts = ops.launch_counts()
    check(counts["multi_scope_topk"] > 0 and counts["scoped_topk"] > 0,
          f"scan kernels not launched on the main path: {counts}")

    # warm timings (planner cache filled, kernels and allocator warm)
    td = time.perf_counter()
    batched()
    te = time.perf_counter()
    looped()
    tf = time.perf_counter()
    res = db.dsq_batch(ds.queries, ds.query_anchors, k=k,
                       recursive=[bool(r) for r in ds.query_recursive])
    gt = ground_truth(torch, ds, k)
    rec_k = recall_at_k(res, gt, k)
    check(rec_k == 1.0, f"recall@10 = {rec_k}")
    emit({"phase": 2, "scale": args.scale, "entries": len(db.store),
          "dirs": len(ds.dirs), "gen_s": t1 - t0, "ingest_s": t2 - t1,
          "plans": acct.plan_groups, "unique_scopes": acct.unique_scopes,
          "launches_per_batch": per_batch, "launches_phase": counts,
          "batch_first_ms": (tb - ta) * 1e3, "loop_first_ms": (tc - tb) * 1e3,
          "batch_warm_ms": (te - td) * 1e3, "loop_warm_ms": (tf - te) * 1e3,
          "directory_ns": acct.directory_ns, "ann_ns": acct.ann_ns,
          "scan_groups_popcount_checked": len(scan_groups),
          "recall_at_10": rec_k,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return ds, db, batched, looped, counts


# --------------------------------------------------------------- phase 3
def phase3(torch, ops, ds, db, batched, looped):
    cache = db.planner().cache
    # one op that certainly lands on a cached recursive scope's chain (a
    # scan group's, whose device words exist): move a subdirectory of its
    # anchor up to the root, alone, so no concurrent op can race its delta
    _, paths, rec = requests(ds)
    plans = [r.plan for r in batched()]
    anchors = [a for a, r, p in sorted(zip(paths, rec, plans),
                                       key=lambda t: t[2] != "scan")
               if r and a != "/"]
    target = None
    for anchor in anchors:
        sub = next((p for p in ds.entry_paths
                    if p.startswith(anchor) and p != anchor
                    and db.namespaces["fs"].has_dir(p)), None)
        if sub is not None:
            target = (sub, "/")
            break
    check(target is not None, "no anchor with a subdirectory to move")
    templates = ([("move", s, d) for s, d in ds.moves[:10]]
                 + [("merge", s, d) for s, d in ds.merges[:10]])
    before = cache.stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    db.move(*target)
    result = db.dsm_batch(templates)
    t1 = time.perf_counter()
    after_batch = batched()
    counts = ops.launch_counts()
    stats = cache.stats()
    check(counts["bitmap_patch"] > 0, f"bitmap_patch not launched: {counts}")
    check(stats["patched"] > before["patched"], f"nothing patched: {stats}")
    check(same_results(after_batch, looped()),
          "after DSM: dsq_batch != loop of dsq (bitwise)")
    db._planners.clear()
    check(same_results(after_batch, batched()),
          "after DSM: patched-cache batch != uncached batch (bitwise)")
    db.check_invariants()
    counts = ops.launch_counts()
    emit({"phase": 3, "dsm_ops": 1 + len(templates),
          "dsm_rejected": sum(e is not None for e in result.errors),
          "dsm_ms": (t1 - t0) * 1e3, "cache": stats,
          "launches_phase": counts, "targeted_op": target})
    return counts


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="WIKI-Dir scale (1.0 = published size)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the repository's src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = next((v for key, v in CARD_PEAKS.items() if key in name),
                 CARD_PEAKS["H100"])
    t0 = time.perf_counter()
    _build.library()
    regs = [line.strip() for line in _build.build_log.splitlines()
            if "registers" in line]
    emit({"phase": 0, "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_seconds, "ptxas": regs,
          "peaks": {"hbm_bytes_per_s": peaks[0], "fp32_flops": peaks[1]},
          "kernel_names": list(REPLACES)})

    measured = phase1(torch, ops, ref, peaks)
    scratch = ROOT / "build"            # ignored by git, like the kernels
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ds, db, batched, looped, c2 = phase2(torch, args, ops,
                                              str(Path(tmp) / "dsm.journal"))
        c3 = phase3(torch, ops, ds, db, batched, looped)
    launches = {key: c2[key] + c3[key] for key in c2}
    for key, n in launches.items():
        check(n > 0, f"{key} was not launched on the main path")
    emit({"kernels": [
        {"name": key, "route": "cuda", "source": SOURCES[key],
         "replaces": REPLACES[key], "launches": launches[key],
         **{f: measured[key][f] for f in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "device_ms")}}
        for key in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
