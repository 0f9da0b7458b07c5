"""Calibration microbenchmark sweep -> versioned JSON artifact, on the
device it calibrates — the port of ``repro/analysis/calibrate.py``.

Measures, on a torch device (a CUDA card, or the CPU's plain path), every
cost term :class:`repro_torch.vectordb.costmodel.CostModel` answers planner
questions from:

* linear scan cost per precision (fp32 / int8 / pq) against corpus bytes,
* gather-plan cost against candidate-set size,
* exact fp32 rescore cost against window width,
* the solved gather/scan crossover selectivity,
* the smallest rescore factor whose recall@k clears the recall gate,
* the IVF nprobe recall/latency curve and its recall-floored default,
* the fastest block shape per tunable kernel wrapper, its default among the
  candidates,
* the batch-size service-time curve the continuous scheduler sizes from.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.calibrate --device cuda \\
        --out calibration/cuda.json
    PYTHONPATH=src python -m repro_torch.analysis.calibrate --device cuda \\
        --smoke                    # reduced grid

With no ``--out`` the artifact goes to ``calibration/<backend>.json``. It
is loaded back with ``DirectoryVectorDB(calibration=path, device=...)`` or
the ``REPRO_CALIBRATION`` env var; an artifact whose ``backend`` differs
from the database's device degrades to the roofline model (measurements do
not transfer across backends).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

RECALL_GATE_RESCORE = 0.99    # two-phase recall@k floor for the factor pick
RECALL_GATE_NPROBE = 0.95     # IVF recall@k floor for the default-nprobe pick


def _clock_ns(fn, repeat: int, device=None) -> float:
    """Median ns of one call of ``fn`` and its completion. Two warm-up calls
    first (the first call may build the kernels and fill the allocator);
    on a CUDA device each call is timed by CUDA events around it after a
    synchronize, so the time is the call's work on the card and whatever
    host work delays it, not the host's enqueue alone; on the CPU by
    ``perf_counter_ns``. The median shrugs off outliers that would wreck a
    two-point linear fit."""
    dev = torch.device("cpu" if device is None else device)
    fn()
    fn()
    ts = []
    for _ in range(repeat):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e6)
        else:
            t0 = time.perf_counter_ns()
            fn()
            ts.append(float(time.perf_counter_ns() - t0))
    return float(np.median(ts))


def _linfit(xs: Sequence[float], ys: Sequence[float]) -> Tuple[float, float]:
    """(intercept a, slope) least-squares fit, both floored at >= 0 — a
    negative launch overhead or negative marginal byte cost is always
    measurement noise, and downstream crossover solving assumes
    monotonicity."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if len(xs) == 1:
        return 0.0, float(ys[0] / max(xs[0], 1.0))
    slope, a = np.polyfit(xs, ys, 1)
    return float(max(a, 0.0)), float(max(slope, 1e-9))


def _corpus(n: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


def _make_store(n: int, dim: int, seed: int, device):
    from ..vectordb.flat import FlatExecutor
    from ..vectordb.store import VectorStore
    store = VectorStore(dim, device=device)
    store.add(_corpus(n, dim, seed))
    return store, FlatExecutor(store)


# --------------------------------------------------------------- cost terms
def sweep_scan(ns: Sequence[int], dim: int, batch: int, k: int,
               repeat: int, seed: int, device=None
               ) -> Tuple[Dict, Dict, List[Dict]]:
    """Per-precision phase-1 scan terms + the exact-rescore term.

    Scan launches are timed against *pre-packed* scope words — the batch
    planner's steady state, where the epoch-validated mask cache has
    already paid for the packing — through ``FlatExecutor.search_multi``'s
    kernels (``ops.multi_scope_topk*``). The quantized scans are timed at
    their rescore window width (phase 1 only); the rescore is its own
    fitted term, which is how the model recombines them."""
    from ..kernels import ops
    from ..vectordb import flat
    from ..vectordb.quant import quantize_rows, resolve_rescore_k
    from ..vectordb.store import pack_ids_to_words
    dev = resolve_device(device)
    rows_out: List[Dict] = []
    per_prec_pts: Dict[str, List[Tuple[float, float]]] = {
        "fp32": [], "int8": [], "pq": []}
    rescore_pts: List[Tuple[int, float]] = []
    rng = np.random.default_rng(seed + 1)
    for n in ns:
        store, ex = _make_store(n, dim, seed, dev)
        q = rng.normal(size=(batch, dim)).astype(np.float32)
        words = ops.as_words(pack_ids_to_words(None, n)[None, :]).to(dev)
        sids = torch.zeros(batch, dtype=torch.int32, device=dev)
        r = resolve_rescore_k(k, None, n)
        # rescore window sweep (n-free cost; the store just supplies rows)
        for rr in sorted({k, 4 * k, 8 * k, 16 * k}):
            if rr > n:
                continue
            cand = np.stack([rng.choice(n, size=rr, replace=False)
                             for _ in range(batch)]).astype(np.int64)
            t = _clock_ns(
                lambda: flat.gather_rescore(store, q, cand, k), repeat, dev)
            rescore_pts.append((rr, t))
        qd = torch.from_numpy(q).to(dev)
        q_i8, q_s = quantize_rows(q)
        q_i8 = torch.from_numpy(q_i8).to(dev)
        q_s = torch.from_numpy(q_s).to(dev)
        rows_dev = store.device_vectors()
        qrows, qscales = store.device_q_vectors(), store.device_q_scales()
        codes = store.device_pq_codes()
        timers = {
            "fp32": lambda: ops.multi_scope_topk(qd, rows_dev, words, sids, k,
                                                 store.metric),
            "int8": lambda: ops.multi_scope_topk_i8(
                q_i8, q_s, qrows, qscales, None, words, sids, r,
                store.metric),
            # the per-query ADC LUT build is real per-call work: include it
            "pq": lambda: ops.multi_scope_topk_pq(
                torch.from_numpy(store.pq_lut(q)).to(dev), codes, words,
                sids, r),
        }
        for prec, fn in timers.items():
            t = _clock_ns(fn, repeat, dev)
            bytes_per_row = {"fp32": 4 * dim, "int8": dim + 4,
                             "pq": max(dim // 4, 1)}[prec]
            per_prec_pts[prec].append((float(n * bytes_per_row), t))
            rows_out.append({"term": "scan", "precision": prec, "n": n,
                             "ns": t})
    r_a, r_slope = _linfit([r for r, _ in rescore_pts],
                           [t for _, t in rescore_pts])
    rescore = {"a": r_a, "per_row": r_slope}
    scan: Dict[str, Dict[str, float]] = {}
    for prec, pts in per_prec_pts.items():
        a, slope = _linfit([b for b, _ in pts], [t for _, t in pts])
        scan[prec] = {"a": a, "per_byte": slope}
    return scan, rescore, rows_out


def sweep_gather(ns: Sequence[int], dim: int, batch: int, k: int,
                 repeat: int, seed: int, device=None
                 ) -> Tuple[Dict, List[Dict]]:
    """Gather-plan cost against the candidate count, through
    ``FlatExecutor.search(plan="gather")`` (kernel 1 over the gathered
    rows)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 2)
    pts: List[Tuple[int, float]] = []
    rows_out: List[Dict] = []
    n = max(ns)
    store, ex = _make_store(n, dim, seed, dev)
    q = rng.normal(size=(batch, dim)).astype(np.float32)
    for frac in (0.005, 0.02, 0.05, 0.1, 0.2):
        m = max(int(frac * n), k + 1)
        cand = np.sort(rng.choice(n, size=m, replace=False)).astype(np.uint32)
        t = _clock_ns(
            lambda: ex.search(q, k, candidate_ids=cand, plan="gather"),
            repeat, dev)
        pts.append((m, t))
        rows_out.append({"term": "gather", "m": m, "ns": t})
    a, slope = _linfit([m for m, _ in pts], [t for _, t in pts])
    return {"a": a, "per_row": slope}, rows_out


def solve_threshold(scan: Dict, gather: Dict, ns: Sequence[int],
                    dim: int) -> float:
    """Measured gather/scan crossover selectivity: the fraction m/n where
    the fitted gather cost meets the fitted fp32 scan cost, median across
    the calibrated corpus sizes (clamping to the sane band happens in the
    CostModel, not here — the artifact records the raw measurement)."""
    fracs = []
    for n in ns:
        scan_t = scan["fp32"]["a"] + scan["fp32"]["per_byte"] * n * 4 * dim
        m_star = (scan_t - gather["a"]) / max(gather["per_row"], 1e-9)
        fracs.append(max(m_star, 0.0) / n)
    return float(np.median(fracs))


# ------------------------------------------------------------- recall gates
def _recall(got: np.ndarray, want: np.ndarray, k: int) -> float:
    hits = sum(len(set(map(int, g)) & set(map(int, e)))
               for g, e in zip(got, want))
    return hits / float(want.shape[0] * k)


def sweep_rescore_recall(n: int, dim: int, k: int, seed: int,
                         device=None) -> Tuple[int, Dict[str, float]]:
    """Smallest rescore factor whose int8 two-phase recall@k clears the
    gate, plus the whole curve for the artifact. A recall: deterministic
    for a seed, whatever the device."""
    store, ex = _make_store(n, dim, seed, resolve_device(device))
    rng = np.random.default_rng(seed + 3)
    q = rng.normal(size=(32, dim)).astype(np.float32)
    allc = np.arange(n, dtype=np.uint32)
    _, exact = ex.search(q, k, candidate_ids=allc, plan="scan")
    curve: Dict[str, float] = {}
    best: Optional[int] = None
    for factor in (1, 2, 4, 8):
        _, got = ex.search(q, k, candidate_ids=allc, plan="scan",
                           precision="int8", rescore_k=factor * k)
        recall = _recall(got, exact, k)
        curve[str(factor)] = recall
        if best is None and recall >= RECALL_GATE_RESCORE:
            best = factor
    return best if best is not None else 8, curve


def sweep_nprobe(n: int, dim: int, k: int, repeat: int, seed: int,
                 device=None) -> Tuple[int, List[Dict]]:
    """IVF recall/latency curve over probe depths, through the port's IVF
    executor (kernel 9's list form); the default is the smallest depth
    clearing the recall gate against the full-probe oracle (the CostModel
    additionally floors it at the hand-set 8)."""
    from ..vectordb.ivf import IVFIndex
    dev = resolve_device(device)
    store, _ = _make_store(n, dim, seed, dev)
    n_lists = max(int(np.sqrt(n)), 8)
    ivf = IVFIndex(store, n_lists=n_lists, seed=seed)  # partitions all rows
    rng = np.random.default_rng(seed + 4)
    q = rng.normal(size=(16, dim)).astype(np.float32)
    allc = np.arange(n, dtype=np.uint32)
    _, oracle = ivf.search(q, k, candidate_ids=allc, nprobe=n_lists)
    curve: List[Dict] = []
    best: Optional[int] = None
    for nprobe in (4, 8, 16, 32):
        if nprobe > n_lists:
            break
        t = _clock_ns(lambda: ivf.search(q, k, candidate_ids=allc,
                                         nprobe=nprobe), repeat, dev)
        _, got = ivf.search(q, k, candidate_ids=allc, nprobe=nprobe)
        recall = _recall(got, oracle, k)
        curve.append({"nprobe": nprobe, "recall": recall, "ns": t})
        if best is None and recall >= RECALL_GATE_NPROBE:
            best = nprobe
    return best if best is not None else n_lists, curve


# ------------------------------------------------------------ kernel tuning
def default_blocks(name: str, nq: int, n: int, depth: int, k: int,
                   device=None) -> Tuple[int, int]:
    """The (block_q, block_n) a wrapper's default launch resolves to at one
    shape: the default query tile, and on a card the rows one block of the
    default one-wave grid sweeps (``scoped_topk.launch_geometry``). The
    plain version on the CPU ranks all ``n`` rows as one block."""
    from ..kernels.scoped_topk import TILE_Q, TILED, launch_geometry
    dev = resolve_device(device)
    block_q = TILE_Q if name in TILED else 8
    if dev.type != "cuda":
        return block_q, int(n)
    kind = ("i8" if name.endswith("_i8") else
            "pq" if name.endswith("_pq") else "f32")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    geo, _ = launch_geometry(name, kind, nq, n, depth, k, block_q, None, sms)
    return block_q, int(geo.chunk_rows)


def sweep_kernel_blocks(n: int, dim: int, batch: int, k: int, repeat: int,
                        seed: int, block_ns: Sequence[int],
                        device=None) -> Dict[str, Dict]:
    """Fastest (block_q, block_n) per tunable kernel wrapper at one shape.
    The candidates are each wrapper's default launch (its block_n as
    :func:`default_blocks` resolves it) and ``block_ns`` at the default
    query tile; the argmin is kept, so an installed artifact never runs a
    shape slower than the default at the sweep's shape. Results do not
    depend on the block shape (tiling is a performance knob only). The
    tuned-block registry is cleared while the sweep runs and restored
    after it."""
    from ..kernels import ops
    from ..vectordb.quant import quantize_rows
    from ..vectordb.store import pack_ids_to_words

    dev = resolve_device(device)
    store, _ = _make_store(n, dim, seed, dev)
    rng = np.random.default_rng(seed + 5)
    q = rng.normal(size=(batch, dim)).astype(np.float32)
    q_i8, q_s = quantize_rows(q)
    lut = torch.from_numpy(store.pq_lut(q)).to(dev)
    ids = np.sort(rng.choice(n, size=n // 2, replace=False))
    words = ops.as_words(pack_ids_to_words(ids.astype(np.uint32),
                                           n)[None, :]).to(dev)
    mask = torch.zeros(n, dtype=torch.int8, device=dev)
    mask[torch.from_numpy(ids).to(dev)] = 1
    sids = torch.zeros(batch, dtype=torch.int32, device=dev)
    qd = torch.from_numpy(q).to(dev)
    q_i8 = torch.from_numpy(q_i8).to(dev)
    q_s = torch.from_numpy(q_s).to(dev)
    rows, qrows = store.device_vectors(), store.device_q_vectors()
    qscales, codes = store.device_q_scales(), store.device_pq_codes()

    def runs(name: str, bq: Optional[int], bn: Optional[int]):
        return {
            "scoped_topk": lambda: ops.scoped_topk(
                qd, rows, mask, k=k, block_q=bq, block_n=bn),
            "scoped_topk_i8": lambda: ops.scoped_topk_i8(
                q_i8, q_s, qrows, qscales, None, mask, k=k, block_q=bq,
                block_n=bn),
            "scoped_topk_pq": lambda: ops.scoped_topk_pq(
                lut, codes, mask, k=k, block_q=bq, block_n=bn),
            "multi_scope_topk": lambda: ops.multi_scope_topk(
                qd, rows, words, sids, k=k, block_q=bq, block_n=bn),
            "multi_scope_topk_i8": lambda: ops.multi_scope_topk_i8(
                q_i8, q_s, qrows, qscales, None, words, sids, k=k,
                block_q=bq, block_n=bn),
            "multi_scope_topk_pq": lambda: ops.multi_scope_topk_pq(
                lut, codes, words, sids, k=k, block_q=bq, block_n=bn),
        }[name]

    saved = ops.get_block_overrides()
    ops.set_block_overrides({})
    best: Dict[str, Dict] = {}
    try:
        from ..vectordb.costmodel import TUNABLE_KERNELS
        for name in TUNABLE_KERNELS:
            depth = codes.shape[1] if name.endswith("_pq") else dim
            bq, bn_default = default_blocks(name, batch, n, depth, k, dev)
            cands = [(None, bn_default)] + [(bn, bn) for bn in block_ns
                                            if bn != bn_default]
            for arg, bn in cands:
                t = _clock_ns(runs(name, None if arg is None else bq, arg),
                              repeat, dev)
                if name not in best or t < best[name]["us"] * 1e3:
                    best[name] = {"block_q": int(bq), "block_n": int(bn),
                                  "us": t / 1e3,
                                  "default": arg is None}
    finally:
        ops.set_block_overrides(saved)
    for spec in best.values():
        spec.pop("default")
    return best


# --------------------------------------------------------------- scheduler
def sweep_scheduler(n: int, dim: int, k: int, repeat: int, seed: int,
                    batches: Sequence[int], device=None) -> Dict:
    """Batch-size service-time curve through the real planned dsq_batch
    path; ``max_batch`` lands at the knee (lowest us/request), and
    ``max_wait_ms`` is one service interval of that batch — waiting longer
    than one service time buys no extra batching."""
    from ..vectordb.database import DirectoryVectorDB
    dev = resolve_device(device)
    db = DirectoryVectorDB(dim=dim, calibration=False, device=dev)
    rng = np.random.default_rng(seed + 6)
    vecs = _corpus(n, dim, seed)
    paths = [f"/cal/d{i % 16}" for i in range(n)]
    db.ingest(vecs, paths)
    db.build_ann("flat")
    curve: Dict[str, float] = {}
    best_b, best_per_req = batches[0], float("inf")
    best_service_ns = 0.0
    for b in batches:
        q = rng.normal(size=(b, dim)).astype(np.float32)
        p = [f"/cal/d{i % 16}" for i in range(b)]
        t = _clock_ns(lambda: db.dsq_batch(q, p, k=k), repeat, dev)
        curve[str(b)] = t / 1e3
        if t / b < best_per_req:
            best_per_req, best_b, best_service_ns = t / b, b, t
    return {"max_batch": int(best_b),
            "max_wait_ms": float(min(max(best_service_ns / 1e6, 0.5), 8.0)),
            "service_us": curve}


# --------------------------------------------------------------------- main
def calibrate(dim: int = 64, seed: int = 0, smoke: bool = False,
              backend: Optional[str] = None,
              device=None) -> "CalibrationArtifact":
    """Run every sweep on ``device`` (``None``: ``"cuda"``) and return the
    artifact. ``backend`` defaults to the device's
    (``costmodel._current_backend``)."""
    from ..vectordb.costmodel import (SCHEMA_VERSION, CalibrationArtifact,
                                      _current_backend)
    dev = resolve_device(device)
    backend = backend or _current_backend(dev)
    k = 10
    batch = 8
    if smoke:
        ns, repeat = (2048, 6144), 5
        block_ns = (512, 1024)
        sched_batches = (1, 8, 32)
    else:
        ns, repeat = (4096, 16384, 32768), 5
        block_ns = (256, 512, 1024, 2048)
        sched_batches = (1, 8, 16, 32, 64)
    half = max(repeat // 2, 1)

    print(f"[calibrate] backend={backend} device={dev} dim={dim} ns={ns} "
          f"smoke={smoke}", file=sys.stderr)
    scan, rescore, _ = sweep_scan(ns, dim, batch, k, repeat, seed, dev)
    gather, _ = sweep_gather(ns, dim, batch, k, repeat, seed, dev)
    threshold = solve_threshold(scan, gather, ns, dim)
    print(f"[calibrate] crossover fraction {threshold:.4f}", file=sys.stderr)
    factor, recall_curve = sweep_rescore_recall(min(ns), dim, k, seed, dev)
    nprobe, nprobe_curve = sweep_nprobe(min(ns), dim, k, repeat, seed, dev)
    kernels = sweep_kernel_blocks(min(ns), dim, batch, k, half, seed,
                                  block_ns, dev)
    sched = sweep_scheduler(min(ns), dim, k, half, seed, sched_batches, dev)
    data = {
        "schema_version": SCHEMA_VERSION,
        "created": int(time.time()),
        "backend": backend,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "dim": dim,
        "batch": batch,
        "seed": seed,
        "smoke": bool(smoke),
        "terms": {
            "row_bytes": {"fp32": 4 * dim, "int8": dim + 4,
                          "pq": max(dim // 4, 1)},
            "scan_ns": scan,
            "gather_ns": gather,
            "rescore_ns": rescore,
            "gather_threshold": threshold,
            "rescore_factor": int(factor),
            "rescore_recall": recall_curve,
            "nprobe": {"default": int(nprobe), "curve": nprobe_curve},
            "kernel_blocks": kernels,
            "scheduler": sched,
        },
    }
    return CalibrationArtifact(data)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="artifact path (default calibration/<backend>.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to calibrate (cuda, cuda:1, cpu)")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid (CI-sized)")
    args = ap.parse_args(argv)
    art = calibrate(dim=args.dim, seed=args.seed, smoke=args.smoke,
                    device=args.device)
    out = args.out or f"calibration/{art.backend}.json"
    art.save(out)
    print(f"[calibrate] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
