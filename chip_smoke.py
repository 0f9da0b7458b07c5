#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # WIKI-Dir at its published size
    python3 chip_smoke.py --scale 0.5     # the documented cut, if needed

Phases (each prints one JSON line; any failure exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together);
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, at the CPU tests' edge shapes and at shapes that take the
   kernels' slow paths (k up to 10,000, d = 8192 and 32768, PQ LUTs past
   shared memory), with its median time, its bound, the plain version's
   time and a library yardstick; at the main shapes the batched scans
   (kernels 2 and 6) also bit for bit against the dense-mask scans
   (kernels 1 and 5) query by query; the IVF kernel 9 and its int8 / PQ modes
   in their list form (the main path's entry point) and their candidate
   form, held against each other, at a synthetic layout of the main path's
   rows skewed like k-means lists (64 lists, 8 probed), and again after
   phase 5 on the inputs phase 5 gave them (the real k-means layout), whose
   times the kernels line reports;
2. the main path: WIKI-Dir ingested into ``DirectoryVectorDB(device="cuda")``
   with TrieHI and the flat executor, a 64-request ``dsq_batch`` mix held
   bitwise against a loop of ``dsq``, and recall@10 against a brute force;
   then kernel 2 on the arguments the batch gave it (the real scope masks),
   against kernel 1 query by query and its plain version, timed;
3. DSM: 21 structural ops through ``dsm_batch`` with a journal, patching the
   cached device scope masks, then batch == loop == uncached batch again;
4. the int8 and PQ tiers on the same database: batch == loop bitwise at
   both, recall@10 against fp32, then a device byte budget of a third of
   the fp32 rows: the fp32 device mirror is released, fp32 batches are
   served by the PQ plan equal to an explicit PQ batch, and hot scopes'
   pins cut the rescore's host fetch; then kernel 6 on the int8 batch's
   arguments, kernel 5 on the widest of its gather-plan launches, kernel 2
   on the widest of its exact rescore's launches (``gather_rescore``'s
   block-diagonal masks), kernel 8 on the PQ batch's arguments and kernel
   7 on the widest of the PQ batch's gather-plan launches, held and timed
   as in 2;
5. the IVF executor on the same database, phase 4's budget lifted first:
   ``build_ann("ivf", n_lists=64)`` twice (bitwise equal centers), the
   64-request mix at nprobe 8 with batch == loop bitwise at fp32, int8 and
   PQ (one kernel-9 launch per precision), every list probed == flat,
   recall@10 against flat (printed at nprobe 8, gated at 48; the
   executor calls kernel 9's list form, ``ops.ivf_probe_topk*``), deletes,
   an ingest routed by ``ivf.add``, ``repartition``, and under a byte
   budget an fp32 IVF batch == an explicit PQ IVF batch (its small scopes
   ranked from host rows);
6. the RAG decode path, after the phase-2 database is freed: the full-width
   ``qwen3-0.6b`` in bf16 (random weights from ``torch.Generator`` seed 0)
   behind a ``ContextDatabase`` holding WIKI-Dir at scale 0.02 (entries
   added one by one through ``add_context``; the deployment's 0.1 is cut
   to fit the time limit, and the cut is printed), and
   ``RAGServer.answer`` on the 64-request mix (k = 10, a 512-token budget,
   one 4-token prompt, 16 new tokens), a DSM merge, and a second answer:
   448 launches of kernel 10 (``flash_decode``) per answer, finite logits,
   stats equal to a direct ``retrieve_batch``, prefill + decode against the
   full forward (bf16, tie-aware top-1), and kernel 10 against its plain
   version on the arguments of every layer's call at steps 1 and 16; then
   (7f) the second answer's batch served through ``RAGServer.start`` /
   ``submit`` (one size-flushed batch: the same tokens, stats and 448
   kernel-10 launches as ``answer``) and ``ContextDatabase.submit_retrieve``
   (== ``retrieve_batch``);
7. the serving tier and online maintenance, on phase 5's database before
   phase 6 frees it (printed before phase 6): (7a) ``ScheduledDSQ`` in
   pump mode, bitwise equal to a direct ``dsq_batch`` of the 64-request
   mix for flat fp32 / int8 / PQ and IVF nprobe 8; (7b) a batch staged,
   then a racing ``dsm_batch`` move (kernel 3 patches the staged words),
   then executed, equal to a fresh batch; (7c) 256 requests (the mix four
   times) from 4 threads at ``open_loop_arrivals(qps=2000)`` through the
   threaded scheduler (``max_batch=64``, ``max_wait_ms=2``, maintenance
   attached), each ticket bitwise equal to its direct ``dsq``, with no
   stage fault and no failed ticket; (7d) rmdirs of seeded subtrees until
   1% of the rows are tombstoned, then ``db.maintenance(
   MaintenancePolicy(tombstone_fraction=0.01)).run_all()``: the compaction
   keeps every surviving row, the batch after it equals the batch before
   it with ids mapped, the cached device words are rebuilt at the new
   length, IVF batch == loop and nprobe = n_lists == flat; (7e) a PG
   database of WIKI-Dir at scale 0.01 (the build is a host loop; the cut
   is printed) with flat and 16-list IVF: PG batch == loop at fp32 / int8
   / PQ, kernel 2 in the int8 / PQ rescore against its plain version,
   recall@10 against flat at ef 64 / 128, the scheduler over PG, a repair
   after 64 deletes, and crashes at the ``maint.apply`` seam recovered
   bitwise to an uncrashed twin;
8. the sharded tier on phase 5's database (printed between phases 5 and 7,
   so that 7d's compaction remaps it): ``build_ann("sharded",
   n_shards=4)``, four row shards on the one card (capacity 2,097,152,
   524,288 rows a shard). (8a) the 64-request mix at fp32, int8 (window
   40) and PQ (window 80): the sharded batch bitwise equal to the flat
   batch with one launch of kernel 2, 6 or 8 per shard, and a loop of
   ``dsq(executor="sharded")`` equal to a loop over flat; (8b) the batch
   again: every scan group a slot hit, no mask bytes uploaded; each
   shard's launch and the flat batch's launch over all rows held against
   their plain versions and timed; (8c) a ``dsm_batch`` of 5 moves, 5
   merges and 2 removes: slots patched, no surviving slot re-uploaded,
   sharded == flat; (8d) 8 rmdirs, the alive words patched by range;
   (8e) 1,000 rows ingested inside the capacity (no re-shard), then rows
   past it (one re-shard to twice the capacity), sharded == flat after
   both; (8f) ``ScheduledDSQ(executor="sharded")`` pumped (the staged
   pre-pin makes every execute-time pin a hit), then a fault plan at
   ``sharded.h2d``: the breaker trips to flat int8, answers equal the
   direct flat int8 batch, and sharded fp32 returns when it closes; (8g,
   after phase 7) the compaction patched every slot in place (none
   evicted, no re-shard) and sharded == flat at three precisions;
9. calibration (after 8g): ``calibrate(smoke=True, device="cuda")`` into
   a temporary file, the reference's schema with ``backend == "cuda"``, a
   fresh CUDA database loads it as ``"measured"`` with its clamps held,
   and phase 5's database under the measured model and its installed
   kernel blocks gives the mix's batch == a loop of ``dsq`` == the batch
   under the heuristic model.

10. training (after phase 6 frees its model): the full-width
   ``qwen3-0.6b`` (28 layers, bf16 parameters, fp32 AdamW moments, tied
   embeddings, ``remat="full"``) from ``torch.Generator`` seed 0, trained
   by ``launch/train.py``'s loop and step function on ``SyntheticLMData``
   at 8 x 512 tokens for 20 steps, under
   ``torch.use_deterministic_algorithms(True)``: every loss finite and the
   last 5 below the first 5; an asynchronous checkpoint at step 9 written
   while steps 10-19 run; one more step under ``torch.profiler`` (device
   time, idle share); a fresh model (seed 1) and optimizer restore step 9
   bit for bit and resume at step 10 with the uninterrupted run's losses
   and final parameters, bit for bit; ``accum_steps=2``'s first loss
   within 1e-3 of the whole batch's. It prints the step time (median),
   tokens/s, peak device memory and the checkpoint's snapshot and write
   times beside the card. The training path reaches no TPU kernel, so it
   adds no kernel and no launch to the kernels line.
11. the other LM families (after phase 6, on its context database, whose
   payload tokens lie below the smallest vocabulary served, hymba's
   32,001; before phase 10), each in bf16 from ``torch.Generator`` seed 0,
   built, driven and freed before the next, each printing its init s,
   prefill s, decode step ms, tokens/s and peak memory beside the card:
   (11a) deepseek-moe-16b at full width and depth: ``RAGServer.answer`` on
   phase 6's mix twice (equal tokens; 28 x 16 kernel-10 launches each;
   finite logits; stats == ``retrieve_batch``), the hits each layer drops
   at prefill and decode, and layer 0's routed experts on 2,048 of its
   prefill tokens with capacity_factor = E / K held against ``dense_tp``;
   (11b) hymba-1.5b: the answer (32 x 16 launches), decode against the
   forward on its contexts (phase 6's gate), a direct b = 4, 2,048-token
   prompt past the 1,024 window with its 128 meta tokens, decode against
   the forward, kernel 10 on a global and a local layer's calls against
   its plain version; (11c) mamba2-130m: the answer with no kernel-10
   launch, decode against the forward; (11d) phi-3-vision-4.2b: the
   answer, a direct prefill behind 144 stub patch embeddings with decode
   against the forward, kernel 10 at head dim 96; (11e) whisper-large-v3
   driven directly (the RAG server passes no frames): b = 16, 1,500 stub
   frames, 64-token prompts, 16 steps, 32 x 2 x 16 launches (self and
   cross), decode against the forward, the cross-attention call at
   s = 1,500 against its plain version; (11f) llama4-scout-17b-a16e at
   full width and 4 layers (one global, three chunked; the 48 layers do
   not fit one card, and the cut is printed): the answer and the MoE
   check of 11a; (11g) the full-width mamba2-130m trained by
   ``launch/train.py``'s loop at 8 x 512 tokens for 20 steps: every loss
   finite, the last 5 below the first 5. The MoE configs' decode is not
   gated against the forward: their capacity drops depend on the tokens
   in the call. Phase 11's kernel-10 launches count on the kernels line.

12. the serving launcher and the dry-run tools (after phase 11, on phase
   6's context database): ``launch/serve.py``'s ``build`` and ``serve``
   with the full-width ``qwen3-0.6b`` (bf16, ``torch.Generator`` seed 0),
   the dataset's 64 queries and anchors, each with its own 2-11-token
   prompt, offered open-loop at 4 QPS (Poisson) to the continuous-batching
   server (batch 8, 50 ms SLO, 16 new tokens, a 256-request queue): 64
   served, none shed or failed, tokens (16,) below the vocabulary, each
   request's hits and scope size equal to ``retrieve_batch`` of that
   request alone, and 28 x 16 kernel-10 launches a batch served; it prints
   the achieved QPS, p50 / p95 / p99 / max latency from each scheduled
   arrival, the batches and their occupancy. Then ``dryrun.run_cell`` over
   the 10 configs x 4 shapes (every record's bound and ``fits`` on one
   line), and ``params_specs`` / ``cache_specs`` of phase 6's model and
   decode shape against the bytes phase 6 allocated. The whole phase
   stays within 60 s.

Phase 1 also holds kernel 10 against its plain version at the reference's
sweep shapes, its edge cases, the RAG decode shape and a 32,768-position
cache, and kernel 2 at ``gather_rescore``'s shapes.

The kernels line's launch counts are the main path's: in phases 2-9, 11
and 12, the launches made around the entry points each phase drives
(``MainPath``), not those of its checks (loops held against a batch,
reference batches, warm-ups, timings, profiler sessions, the kernel
records).

The last lines are the kernels' summary, then
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
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
MAIN_ROWS = 1_940_000      # WIKI-Dir's rows at scale 1.0: the main shapes'
WIDE_ROWS = 100_000        # rows at d = 8192

# data-sheet peaks (NVIDIA): HBM bytes/s, non-tensor fp32 FLOP/s, dense
# int8 tensor-core OP/s and dense bf16 tensor-core FLOP/s of the H100
# variants other than the SXM card, whose figures the port's roofline holds
# (``peaks_of``)
CARD_PEAKS = {"H100 PCIe": (2.0e12, 51e12, 1513e12, 756e12),
              "H100 NVL": (3.9e12, 60e12, 1671e12, 835e12)}


def peaks_of(name: str) -> tuple:
    """The data-sheet peaks of the card called ``name`` (as
    ``torch.cuda.get_device_name`` gives it): a listed variant's, else the
    H100 SXM's from ``src/repro_torch/analysis/roofline.py``. That module
    is loaded from this script's tree by its path, so a tool that runs
    another tree's package (``tools/scan_ab.py``) reads the same figures."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_roofline",
        SRC / "repro_torch" / "analysis" / "roofline.py")
    rl = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rl)
    sxm = (rl.HBM_BW, rl.PEAK_FLOPS_FP32, rl.PEAK_OPS_INT8, rl.PEAK_FLOPS)
    return next((v for key, v in CARD_PEAKS.items() if key in name), sxm)

_ST = "src/repro/kernels/scoped_topk.py"
REPLACES = {
    "scoped_topk": f"{_ST}:55",
    "multi_scope_topk": f"{_ST}:87",
    "bitmap_patch": "src/repro/kernels/bitmap_ops.py:36",
    "mask_and_popcount": "src/repro/kernels/bitmap_ops.py:19",
    "scoped_topk_i8": f"{_ST}:130",
    "multi_scope_topk_i8": f"{_ST}:170",
    "scoped_topk_pq": f"{_ST}:228",
    "multi_scope_topk_pq": f"{_ST}:256",
    "ivf_gather_topk": f"{_ST}:290",
    "ivf_gather_topk_i8": "src/repro/vectordb/ivf.py:136",
    "ivf_gather_topk_pq": "src/repro/vectordb/ivf.py:170",
    "flash_decode": "src/repro/kernels/flash_decode.py:26",
}
_SCAN_CU = "src/repro_torch/kernels/csrc/scoped_topk.cu"
SOURCES = {name: _SCAN_CU for name in REPLACES}
SOURCES["bitmap_patch"] = SOURCES["mask_and_popcount"] = \
    "src/repro_torch/kernels/csrc/bitmap_ops.cu"
SOURCES["flash_decode"] = "src/repro_torch/kernels/csrc/flash_decode.cu"


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


def host_us(torch, fn, calls: int = 100, repeats: int = 5) -> float:
    """Median over ``repeats`` of the host microseconds one ``fn`` call
    takes while the card sleeps through all ``calls`` of them, so the
    launch queue never fills and no call waits on the device: the caller's
    own cost (checks, allocation, the launch), apart from device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(200_000_000)     # ~0.1 s of SM clocks
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(torch, fn, runs: int, names=None):
    """Mean device time of one ``fn`` call from ``torch.profiler``: the
    kernels whose name contains one of ``names`` (every kernel when None).
    Late in a long run the profiler has dropped kernel events (it saw 8 of
    20 calls), so a session counts only when it saw every launch: one
    ``scan_pass1`` and one or two ``scan_pass2`` (pass 2's two levels) per
    scan launch that the wrappers counted, and a multiple of ``runs`` of
    every other kernel it matched.
    A session that missed some is repeated, twice with ``runs`` calls and
    then three times with a quarter of them (smaller sessions lose fewer
    events). None when no session saw every launch, or none saw device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    def scan_launches() -> int:
        return sum(v for key, v in ops.launch_counts().items()
                   if key not in ("bitmap_patch", "mask_and_popcount",
                                  "flash_decode"))

    fn()
    torch.cuda.synchronize()
    for runs in (runs,) * 3 + (max(1, runs // 4),) * 3:
        before = scan_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        launched = scan_launches() - before
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0.0) > 0]
        pass1 = sum(e.count for e in events if "scan_pass1" in e.key)
        pass2 = sum(e.count for e in events if "scan_pass2" in e.key)
        seen = [e for e in events
                if names is None or any(n in e.key for n in names)]
        if seen and pass1 == launched and \
                launched <= pass2 <= 2 * launched and all(
                e.count % runs == 0 for e in seen if "scan_pass" not in e.key):
            return sum(e.device_time_total for e in seen) / runs / 1e3
        emit({"device_ms_rejected": {"runs": runs, "scan_launches": launched,
                                     "counts": {e.key[:60]: e.count
                                                for e in seen}}})
    return None


def timed(torch, fn, runs: int, names=None) -> dict:
    """``ms``: median CUDA-event time of one call over ``runs`` calls (the
    device waits for the host's launch inside it, so a tiny kernel reads as
    its launch overhead); ``device_ms``: the profiler's device time of the
    same call (None when the profiler sees none)."""
    return {"ms": median_ms(torch, fn, runs),
            "device_ms": device_ms(torch, fn, runs, names)}


def bound(nbytes: float, ops: float, peaks, kind: str = "fp32") -> dict:
    """The larger of bytes over HBM bandwidth and operations over the
    peak rate of their type (non-tensor fp32, int8 or bf16 tensor-core)."""
    bw, rate = peaks[0], peaks[{"fp32": 1, "int8": 2, "bf16": 3}[kind]]
    t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


_SM_CLOCK_MHZ = []


def lookup_bound(torch, lookups: float) -> dict:
    """The shared-memory bound of a PQ scan, beside its operations bound:
    each admitted (query, row) pair reads M LUT entries from shared memory,
    and an SM serves at most 32 4-byte reads a clock (one per bank) at its
    highest clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    if not _SM_CLOCK_MHZ:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[0]
        _SM_CLOCK_MHZ.append(float(out))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = _SM_CLOCK_MHZ[0]
    return {"lookup_bound_ms": lookups / (sms * 32 * mhz * 1e6) * 1e3,
            "lookups": lookups, "sm_clock_mhz": mhz}


# --------------------------------------------------------------- phase 1
def topk_case(ref, label, got, want) -> float:
    """Kernel result vs plain result within TOL (ids equal up to ties);
    returns the max abs error over filled lanes."""
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


def exact_case(torch, label, got, want) -> float:
    """int8 and PQ scores are computed in the same order by the kernel and
    its plain version: ids and values must be bit-for-bit equal."""
    check(torch.equal(got[1], want[1]), f"{label}: ids differ")
    check(torch.equal(got[0], want[0]), f"{label}: values differ")
    return 0.0


def same_as_dense(torch, label, got, one, dense, sid) -> None:
    """Kernel 2 (6) against kernel 1 (5) query by query: ``one(i, mask)``
    runs the dense-mask scan of query i on its unpacked scope row; ids and
    values must be bit-for-bit equal (dsq_batch == a loop of dsq)."""
    S = dense.shape[0]
    for i in range(sid.shape[0]):
        s = int(sid[i])
        mask = (dense[s] if 0 <= s < S else torch.zeros_like(dense[0])).to(
            torch.int8)
        v, ids = one(i, mask)
        check(torch.equal(ids, got[1][i:i + 1]), f"{label}: query {i} ids "
              f"differ from the dense-mask scan's")
        check(torch.equal(v, got[0][i:i + 1]), f"{label}: query {i} values "
              f"differ from the dense-mask scan's")


def library_int_mm(torch, q8, x8):
    """Median time of ``torch._int_mm`` of the int8 queries by the int8 rows
    (the product alone, no top-k), or None where it cannot take them."""
    x8t = x8.t()
    try:
        torch._int_mm(q8, x8t)
    except RuntimeError as exc:                # a yardstick only
        print(f"chip_smoke: torch._int_mm unavailable: {exc}",
              file=sys.stderr)
        return None
    return median_ms(torch, lambda: torch._int_mm(q8, x8t), 20)


def bound_args(ops, name, args, kw) -> dict:
    """The wrapper ``ops.name``'s arguments by name, defaults filled in."""
    import inspect
    call = inspect.signature(getattr(ops, name)).bind(*args, **kw)
    call.apply_defaults()
    return call.arguments


def dense_record(torch, ops, ref, peaks, args, kw, label) -> dict:
    """Kernel 1 on the arguments of one call: held against its plain
    version (ids tie-aware, scores within TOL), timed, and bounded by the
    rows the mask admits (each read once), the mask, the queries (and the
    admitted rows' norms for l2) and the results; ``library_ms`` is
    ``torch.matmul`` of the same queries by the same rows, without the mask
    and the top-k."""
    a = bound_args(ops, "scoped_topk", args, kw)
    queries, rows, mask, k, metric, sq = (a[key] for key in (
        "queries", "rows", "mask", "k", "metric", "sq"))
    n, d = rows.shape
    B = queries.shape[0]

    def fn():
        return ops.scoped_topk(queries, rows, mask, k, metric, sq)

    def plain():
        return ref.scoped_topk_ref(queries, rows, mask, k, metric, sq)

    err = topk_case(ref, label, fn(), plain())
    admitted = int((mask != 0).sum())
    row_bytes = d * 4 + (4 if metric == "l2" else 0)
    return {"max_abs_err": err,
            **timed(torch, fn, 30, ("scan_pass1", "scan_pass2")),
            "pass1_device_ms": device_ms(torch, fn, 30, ("scan_pass1",)),
            "plain_ms": median_ms(torch, plain, 10),
            "library_ms": median_ms(torch, lambda: torch.matmul(
                queries, rows.T), 30),
            **bound(admitted * row_bytes + n + B * (d * 4 + k * 8),
                    2.0 * B * admitted * d, peaks),
            "shape": f"q={B} n={n} d={d} k={k} {metric} "
                     f"admitted_rows={admitted}; library: torch.matmul "
                     f"({B},{d})x({d},{n})"}


def dense_i8_record(torch, ops, ref, peaks, args, kw, label) -> dict:
    """Kernel 5 on the arguments of one call: held bit for bit against its
    plain version, timed (pass 1's device time too), and bounded by the
    rows the mask admits (codes, scale and, for l2, norm, each read once),
    the mask, the queries and the results; ``library_ms`` is
    ``torch._int_mm`` of the same int8 queries by the same int8 rows
    (zero-padded to the 17 query rows and the multiple of 8 rows it
    takes), without the scales, the mask and the top-k."""
    a = bound_args(ops, "scoped_topk_i8", args, kw)
    q8, qs, x8, xs, sq, mask, k, metric = (a[key] for key in (
        "q_i8", "q_scale", "rows_i8", "row_scale", "sq", "mask", "k",
        "metric"))
    n, d = x8.shape
    B = q8.shape[0]

    def fn():
        return ops.scoped_topk_i8(q8, qs, x8, xs, sq, mask, k, metric)

    def plain():
        return ref.scoped_topk_i8_ref(q8, qs, x8, xs, sq, mask, k, metric)

    err = exact_case(torch, label, fn(), plain())
    admitted = int((mask != 0).sum())
    row_bytes = d + 4 + (4 if metric == "l2" else 0)
    qpad = torch.nn.functional.pad(q8, (0, 0, 0, max(0, 17 - B)))
    xpad = torch.nn.functional.pad(x8, (0, 0, 0, -n % 8))
    return {"max_abs_err": err,
            **timed(torch, fn, 30, ("scan_pass1", "scan_pass2")),
            "pass1_device_ms": device_ms(torch, fn, 30, ("scan_pass1",)),
            "plain_ms": median_ms(torch, plain, 10),
            "library_ms": library_int_mm(torch, qpad, xpad),
            **bound(admitted * row_bytes + n + B * (d + 4 + k * 8),
                    2.0 * B * admitted * d, peaks, "int8"),
            "shape": f"q={B} n={n} d={d} k={k} {metric} "
                     f"admitted_rows={admitted}; library: torch._int_mm "
                     f"({qpad.shape[0]},{d})x({d},{xpad.shape[0]}), zero "
                     f"rows added to the 17 queries and the multiple of 8 "
                     f"rows it takes, no top-k"}


def dense_pq_record(torch, ops, ref, peaks, args, kw, label) -> dict:
    """Kernel 7 on the arguments of one call: held bit for bit against its
    plain version, timed (pass 1's device time too), and bounded by the
    codes the mask admits (each read once), the mask, the LUTs and the
    results, beside its shared-memory bound (each admitted (query, row)
    pair reads M LUT entries, :func:`lookup_bound`). No single PyTorch call
    computes a PQ ADC scan (a gather, a sum over M, then a top-k), so
    ``library_ms`` is None."""
    a = bound_args(ops, "scoped_topk_pq", args, kw)
    lut, codes, mask, k = (a[key] for key in ("lut", "codes", "mask", "k"))
    n, M = codes.shape
    B = lut.shape[0]

    def fn():
        return ops.scoped_topk_pq(lut, codes, mask, k)

    def plain():
        return ref.scoped_topk_pq_ref(lut, codes, mask, k)

    err = exact_case(torch, label, fn(), plain())
    admitted = int((mask != 0).sum())
    return {"max_abs_err": err,
            **timed(torch, fn, 30, ("scan_pass1", "scan_pass2")),
            "pass1_device_ms": device_ms(torch, fn, 30, ("scan_pass1",)),
            "plain_ms": median_ms(torch, plain, 10),
            "library_ms": None,
            **bound(admitted * M + n + B * (M * 1024 + k * 8),
                    1.0 * B * admitted * M, peaks),
            **lookup_bound(torch, B * admitted * M),
            "shape": f"q={B} n={n} M={M} k={k} admitted_rows={admitted}; "
                     f"library: none (no single PyTorch call computes a PQ "
                     f"ADC scan)"}


def kernels_per_call(torch, fn, runs: int = 10) -> dict:
    """The device kernels ``torch.profiler`` sees per call of ``fn``, by
    name (a session that lost events, fewer than one kernel a call, is
    repeated up to twice)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count / runs for e in prof.key_averages()
                if getattr(e, "device_time_total", 0.0) > 0}
        if sum(seen.values()) >= 1:
            break
    return seen


def batch_record(torch, ops, ref, peaks, name, args, kw, label) -> dict:
    """Kernel 2, 6 or 8 (``name``) on the arguments of one call: held
    against kernel 1, 5 or 7 query by query (bitwise) and against its plain
    version, timed, and bounded by the rows its queries admit (each such
    row read once, with the scope words and the query side); kernel 8 also
    by its shared-memory LUT lookups (:func:`lookup_bound`).
    ``library_ms`` is one product of the same queries by the same rows
    (``torch.matmul`` at fp32, ``torch._int_mm`` at int8), without the
    top-k; PQ has none."""
    from repro_torch.kernels.common import unpack_words
    a = bound_args(ops, name, args, kw)
    i8 = name == "multi_scope_topk_i8"
    pq = name == "multi_scope_topk_pq"
    queries, rows = ((a["q_i8"], a["rows_i8"]) if i8 else
                     (a["lut"], a["codes"]) if pq else
                     (a["queries"], a["rows"]))
    sids, k = a["scope_ids"], a["k"]
    metric, sq = (None, None) if pq else (a["metric"], a["sq"])
    n, d = rows.shape
    words = ops.as_words(a["mask_words"])
    S, n_words = words.shape
    dense = unpack_words(words, n)
    if dense.shape[1] < n:
        dense = torch.nn.functional.pad(dense, (0, n - dense.shape[1]))
    B = queries.shape[0]
    if i8:
        qs, xs = a["q_scale"], a["row_scale"]

        def fn():
            return ops.multi_scope_topk_i8(queries, qs, rows, xs, sq, words,
                                           sids, k, metric)

        def plain():
            return ref.multi_scope_topk_i8_ref(queries, qs, rows, xs, sq,
                                               words, sids, k, metric)

        def one(i, m):
            return ops.scoped_topk_i8(queries[i:i + 1], qs[i:i + 1], rows,
                                      xs, sq, m, k, metric)
    elif pq:
        def fn():
            return ops.multi_scope_topk_pq(queries, rows, words, sids, k)

        def plain():
            return ref.multi_scope_topk_pq_ref(queries, rows, words, sids, k)

        def one(i, m):
            return ops.scoped_topk_pq(queries[i:i + 1], rows, m, k)
    else:
        def fn():
            return ops.multi_scope_topk(queries, rows, words, sids, k,
                                        metric, sq)

        def plain():
            return ref.multi_scope_topk_ref(queries, rows, words, sids, k,
                                            metric, sq)

        def one(i, m):
            return ops.scoped_topk(queries[i:i + 1], rows, m, k, metric, sq)

    got = fn()
    err = (exact_case(torch, label, got, plain()) if i8 or pq
           else topk_case(ref, label, got, plain()))
    same_as_dense(torch, f"{label} vs the dense-mask scan", got, one, dense,
                  sids)
    del got
    ok = (sids >= 0) & (sids < S)
    live = sids[ok].long()
    pairs = int(dense.sum(1)[live].sum())
    union = int(dense[live.unique()].any(0).sum()) if len(live) else 0
    norm = 4 if metric == "l2" else 0
    row_bytes = (d + 4 if i8 else d if pq else d * 4) + norm
    q_bytes = (d + 8 if i8 else d * 1024 + 4 if pq else d * 4 + 4) + k * 8
    if pq:
        lib, library = "none", None
    elif i8:
        lib, library = "torch._int_mm", library_int_mm(torch, queries, rows)
    else:
        lib, library = "torch.matmul", median_ms(
            torch, lambda: torch.matmul(queries, rows.T), 30)
    rec = {"max_abs_err": err,
           **timed(torch, fn, 10, ("scan_pass1", "scan_pass2")),
           "plain_ms": median_ms(torch, plain, 5),
           "library_ms": library,
           **bound(union * row_bytes + S * n_words * 4 + B * q_bytes,
                   (1.0 if pq else 2.0) * pairs * d, peaks,
                   "int8" if i8 else "fp32"),
           "shape": f"q={B} n={n} {'M' if pq else 'd'}={d} k={k}"
                    f"{'' if pq else ' ' + metric} scopes={S} "
                    f"admitted_pairs={pairs} "
                    f"union_rows={union}; library: {lib}"
                    + ("" if pq else f" ({B},{d})x({d},{n})")}
    if pq:
        rec.update(lookup_bound(torch, pairs * d))
        rec["pass1_device_ms"] = device_ms(torch, fn, 10, ("scan_pass1",))
    return rec


def words_of(torch, dense):              # (S, n) bool -> (S, ceil(n/32)) i32
    n = dense.shape[1]
    pad = (-n) % 32
    bits = torch.nn.functional.pad(dense.to(torch.int64), (0, pad))
    bits = bits.reshape(dense.shape[0], -1, 32)
    shifts = torch.arange(32, device=dense.device, dtype=torch.int64)
    w = (bits << shifts).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unit(torch, x):
    return x / x.norm(dim=1, keepdim=True)


def quantize(torch, x):
    """Symmetric per-row int8 codes and scales (quant.quantize_rows's rule)
    on the device: the kernels' inputs, made fast at 1.94M rows."""
    scale = x.abs().amax(1) / 127
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def i8_case(torch, g, q, n, d, dev):
    Q = torch.randn(q, d, generator=g, device=dev)
    X = torch.randn(n, d, generator=g, device=dev)
    X[n // 2] = X[n // 3]                                    # duplicated row
    q8, qs = quantize(torch, Q)
    x8, xs = quantize(torch, X)
    sq = (x8.float() ** 2).sum(1) * xs * xs
    return q8, qs, x8, xs, sq


def pq_case(torch, g, q, n, m, dev):
    lut = torch.randn(q, m, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    codes[n // 2] = codes[n // 3]                            # ties
    return lut, codes


def phase1(torch, ops, ref, peaks) -> dict:
    """Each kernel against its plain version, main shapes + edge shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

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
                    W = words_of(torch, dense)
                    mask = dense[0].to(torch.int8)
                    topk_case(ref, f"scoped_topk q{q} n{n} k{k} {metric}",
                              ops.scoped_topk(Q, X, mask, k, metric, sq),
                              ref.scoped_topk_ref(Q, X, mask, k, metric, sq))
                    topk_case(ref, f"multi_scope_topk q{q} n{n} k{k} {metric}",
                              ops.multi_scope_topk(Q, X, W, sid, k, metric,
                                                   sq),
                              ref.multi_scope_topk_ref(Q, X, W, sid, k, metric,
                                                       sq))
                    edge += 2
    Q = torch.randn(3, 64, generator=g, device=dev)
    X = torch.randn(100_000, 64, generator=g, device=dev)
    ones = torch.ones(100_000, dtype=torch.int8, device=dev)
    topk_case(ref, "scoped_topk k=256", ops.scoped_topk(Q, X, ones, 256),
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
    n, d, k, B, S = MAIN_ROWS, 128, 10, 64, 8
    n_words = (n + 31) // 32
    X = unit(torch, torch.randn(n, d, generator=g, device=dev))
    Q1 = torch.randn(1, d, generator=g, device=dev)
    QB = torch.randn(B, d, generator=g, device=dev)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    dense = torch.rand(S, n, generator=g, device=dev) < torch.linspace(
        0.2, 1.0, S, device=dev)[:, None]
    dense[-1] = True                                       # the root scope
    words = words_of(torch, dense)
    sid = (torch.arange(B, device=dev) % S).to(torch.int32)

    # scoped_topk at q = 1 over every row (the root scan of one dsq), and
    # over a gather plan's few thousand gathered rows (an all-ones mask)
    out["scoped_topk"] = dense_record(torch, ops, ref, peaks,
                                      (Q1, X, ones, k), {},
                                      "scoped_topk main")
    rows_g = X[torch.randperm(n, generator=g, device=dev)[:4000]]
    out["scoped_topk"]["gather_synthetic"] = dense_record(
        torch, ops, ref, peaks,
        (Q1, rows_g, torch.ones(4000, dtype=torch.int8, device=dev), k), {},
        "scoped_topk gather (synthetic)")
    scan_names = ("scan_pass1", "scan_pass2")

    got = ops.multi_scope_topk(QB, X, words, sid, k)
    err = topk_case(ref, "multi_scope_topk main", got,
                    ref.multi_scope_topk_ref(QB, X, words, sid, k))
    same_as_dense(torch, "multi_scope_topk main vs scoped_topk", got,
                  lambda i, m: ops.scoped_topk(QB[i:i + 1], X, m, k), dense,
                  sid)
    del got
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
    # gather_rescore's launches (the int8 / PQ plans' exact rescore): query
    # b admits only its own PQ_RESCORE_K candidates of the B * R gathered
    # rows, at B = 64 (one scan group) and B = 1 (one gather group)
    R = PQ_RESCORE_K
    for b in (B, 1):
        cand = torch.randperm(n, generator=g, device=dev)[:b * R]
        block = torch.zeros(b, b * R, dtype=torch.bool, device=dev)
        block[torch.arange(b * R, device=dev) // R,
              torch.arange(b * R, device=dev)] = True
        out["multi_scope_topk"][f"rescore_q{b}_synthetic"] = batch_record(
            torch, ops, ref, peaks, "multi_scope_topk",
            (QB[:b], X[cand].contiguous(), words_of(torch, block),
             torch.arange(b, dtype=torch.int32, device=dev), k), {},
            f"multi_scope_topk rescore q={b} (synthetic)")

    R = 16
    masks = words_of(torch, torch.rand(R, n, generator=g, device=dev) < 0.5)
    delta = words_of(torch, torch.rand(1, n, generator=g, device=dev)
                     < 0.01)[0]
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
    per_call = kernels_per_call(torch, lambda: ops.mask_and_popcount(a, b))
    check(len(per_call) == 1 and all(
        "and_popc_kernel" in key and v == 1.0 for key, v in per_call.items()),
        f"mask_and_popcount: not one kernel a call: {per_call}")
    out["mask_and_popcount"] = {
        "max_abs_err": 0.0,
        **timed(torch, lambda: ops.mask_and_popcount(a, b), 50,
                ("and_popc_kernel",)),
        "plain_ms": median_ms(
            torch, lambda: ref.mask_and_popcount_ref(a, b), 20),
        "library_ms": None,
        **bound(3 * n_words * 4 + 4, 2 * n_words, peaks),
        "kernels_per_call": per_call,
        "shape": f"W={n_words}; library: none (no torch op counts bits)"}
    edge += phase1_limits(torch, ops, ref, peaks, g, out)
    edge += phase1_tiers(torch, ops, ref, peaks, g, out, X, dense, words,
                         sid)
    edge += phase1_ivf(torch, ops, ref, peaks, g, out, X, words, sid)
    edge += phase1_flash(torch, ops, ref, peaks, g, out)
    emit({"phase": 1, "edge_cases": edge, "kernels": out})
    return out


def phase1_limits(torch, ops, ref, peaks, g, out) -> int:
    """The lifted k and depth limits: k past the old 256 (shared-memory
    lists with a smaller query tile, and device-memory lists past 8192),
    d staged in slices, PQ LUTs that do not fit shared memory; and the fp32
    scans' times at k = 320 and d = 8192."""
    dev = torch.device("cuda")
    cases = 0
    for kind, q, n, depth, k in (
            ("f32", 5, 20_000, 64, 257), ("f32", 5, 20_000, 64, 320),
            ("f32", 5, 20_000, 64, 4096), ("f32", 3, 30_000, 64, 10_000),
            ("f32", 8, 20_000, 8192, 10), ("i8", 5, 20_000, 64, 257),
            ("i8", 5, 20_000, 64, 320), ("i8", 5, 20_000, 64, 4096),
            ("i8", 3, 30_000, 64, 10_000), ("i8", 8, 20_000, 8192, 10),
            ("i8", 8, 4_000, 32768, 10), ("pq", 5, 20_000, 16, 257),
            ("pq", 5, 20_000, 16, 320), ("pq", 5, 20_000, 16, 4096),
            ("pq", 3, 30_000, 16, 10_000), ("pq", 8, 20_000, 32, 10),
            ("pq", 8, 20_000, 256, 10)):
        dense = torch.rand(2, n, generator=g, device=dev) < 0.6
        mask, words = dense[0].to(torch.int8), words_of(torch, dense)
        sid = (torch.arange(q, device=dev) % 2).to(torch.int32)
        label = f"{kind} q={q} n={n} depth={depth} k={k}"
        if kind == "f32":
            Q = torch.randn(q, depth, generator=g, device=dev)
            X = unit(torch, torch.randn(n, depth, generator=g, device=dev))
            sq = ref.row_sq_norms(X)
            topk_case(ref, f"scoped_topk {label}",
                      ops.scoped_topk(Q, X, mask, k, "l2", sq),
                      ref.scoped_topk_ref(Q, X, mask, k, "l2", sq))
            topk_case(ref, f"multi_scope_topk {label}",
                      ops.multi_scope_topk(Q, X, words, sid, k),
                      ref.multi_scope_topk_ref(Q, X, words, sid, k))
        elif kind == "i8":
            q8, qs, x8, xs, sq = i8_case(torch, g, q, n, depth, dev)
            exact_case(torch, f"scoped_topk_i8 {label}",
                       ops.scoped_topk_i8(q8, qs, x8, xs, sq, mask, k, "l2"),
                       ref.scoped_topk_i8_ref(q8, qs, x8, xs, sq, mask, k,
                                              "l2"))
            exact_case(torch, f"multi_scope_topk_i8 {label}",
                       ops.multi_scope_topk_i8(q8, qs, x8, xs, None, words,
                                               sid, k),
                       ref.multi_scope_topk_i8_ref(q8, qs, x8, xs, None,
                                                   words, sid, k))
        else:
            lut, codes = pq_case(torch, g, q, n, depth, dev)
            exact_case(torch, f"scoped_topk_pq {label}",
                       ops.scoped_topk_pq(lut, codes, mask, k),
                       ref.scoped_topk_pq_ref(lut, codes, mask, k))
            exact_case(torch, f"multi_scope_topk_pq {label}",
                       ops.multi_scope_topk_pq(lut, codes, words, sid, k),
                       ref.multi_scope_topk_pq_ref(lut, codes, words, sid,
                                                   k))
        cases += 2

    # fp32 scan times at a rescore window of 320 (main shape) and d = 8192,
    # on unit rows as the main path's (scores near 1: a 1e-5 tie tolerance
    # means what it says)
    n, d, B, S = MAIN_ROWS, 128, 64, 8
    X = unit(torch, torch.randn(n, d, generator=g, device=dev))
    Q1 = torch.randn(1, d, generator=g, device=dev)
    QB = torch.randn(B, d, generator=g, device=dev)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    words = words_of(torch, torch.ones(S, n, dtype=torch.bool, device=dev))
    sid = (torch.arange(B, device=dev) % S).to(torch.int32)
    names = ("scan_pass1", "scan_pass2")
    extra = {}
    for label, fn, plain, nbytes, flops in (
            ("scoped_topk k=320", lambda: ops.scoped_topk(Q1, X, ones, 320),
             lambda: ref.scoped_topk_ref(Q1, X, ones, 320),
             n * d * 4 + n, 2.0 * n * d),
            ("multi_scope_topk k=320",
             lambda: ops.multi_scope_topk(QB, X, words, sid, 320),
             lambda: ref.multi_scope_topk_ref(QB, X, words, sid, 320),
             n * d * 4 + S * words.shape[1] * 4, 2.0 * B * n * d)):
        topk_case(ref, label, fn(), plain())
        extra[label] = {**timed(torch, fn, 10, names),
                        "plain_ms": median_ms(torch, plain, 3),
                        **bound(nbytes, flops, peaks)}
    del X
    n, d = WIDE_ROWS, 8192
    X = unit(torch, torch.randn(n, d, generator=g, device=dev))
    Q1 = torch.randn(1, d, generator=g, device=dev)
    QB = torch.randn(B, d, generator=g, device=dev)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    words = words_of(torch, torch.ones(S, n, dtype=torch.bool, device=dev))
    for label, fn, plain, nbytes, flops in (
            ("scoped_topk d=8192", lambda: ops.scoped_topk(Q1, X, ones, 10),
             lambda: ref.scoped_topk_ref(Q1, X, ones, 10),
             n * d * 4 + n, 2.0 * n * d),
            ("multi_scope_topk d=8192",
             lambda: ops.multi_scope_topk(QB, X, words, sid, 10),
             lambda: ref.multi_scope_topk_ref(QB, X, words, sid, 10),
             n * d * 4 + S * words.shape[1] * 4, 2.0 * B * n * d)):
        topk_case(ref, label, fn(), plain())
        extra[label] = {**timed(torch, fn, 10, names),
                        "plain_ms": median_ms(torch, plain, 3),
                        **bound(nbytes, flops, peaks),
                        "library_ms": median_ms(
                            torch, lambda: torch.matmul(
                                QB if "multi" in label else Q1, X.T), 10)}
    del X
    out["scoped_topk"]["slow_paths"] = {
        key: v for key, v in extra.items() if key.startswith("scoped")}
    out["multi_scope_topk"]["slow_paths"] = {
        key: v for key, v in extra.items() if key.startswith("multi")}
    return cases


def phase1_tiers(torch, ops, ref, peaks, g, out, X, dense, words,
                 sid) -> int:
    """The int8 and PQ scans: the CPU tests' edge shapes, then the main
    path's shapes (WIKI-Dir n = 1.94M, d = 128, M = 32; k = r = 40 at
    q = 1 and 80 at q = 64), timed."""
    dev = torch.device("cuda")
    cases = 0
    for q in (1, 5, 16):
        for n in (137, 2081):
            for k in (1, 10, 40):
                for metric in ("ip", "l2"):
                    # n = 2081 takes the scalar loads (d % 16, M % 4 != 0)
                    d, m = (16, 4) if n == 137 else (13, 3)
                    q8, qs, x8, xs, sq = i8_case(torch, g, q, n, d, dev)
                    lut, codes = pq_case(torch, g, q, n, m, dev)
                    dn = torch.rand(3, n, generator=g, device=dev) < 0.3
                    dn[1] = False                            # empty scope
                    dn[2, : n - 5] = False                   # all-masked tiles
                    W = words_of(torch, dn)
                    m1 = dn[0].to(torch.int8)
                    s1 = torch.randint(0, 3, (q,), generator=g, device=dev,
                                       dtype=torch.int32)
                    label = f"q{q} n{n} k{k} {metric}"
                    exact_case(torch, f"scoped_topk_i8 {label}",
                               ops.scoped_topk_i8(q8, qs, x8, xs, sq, m1, k,
                                                  metric),
                               ref.scoped_topk_i8_ref(q8, qs, x8, xs, sq, m1,
                                                      k, metric))
                    exact_case(torch, f"multi_scope_topk_i8 {label}",
                               ops.multi_scope_topk_i8(q8, qs, x8, xs, sq, W,
                                                       s1, k, metric),
                               ref.multi_scope_topk_i8_ref(
                                   q8, qs, x8, xs, sq, W, s1, k, metric))
                    exact_case(torch, f"scoped_topk_pq {label}",
                               ops.scoped_topk_pq(lut, codes, m1, k),
                               ref.scoped_topk_pq_ref(lut, codes, m1, k))
                    exact_case(torch, f"multi_scope_topk_pq {label}",
                               ops.multi_scope_topk_pq(lut, codes, W, s1, k),
                               ref.multi_scope_topk_pq_ref(lut, codes, W, s1,
                                                           k))
                    cases += 4

    n, d, M, B = X.shape[0], X.shape[1], 32, sid.shape[0]
    S, n_words = words.shape
    x8, xs = quantize(torch, X)
    sq = (x8.float() ** 2).sum(1) * xs * xs
    Q1 = torch.randn(1, d, generator=g, device=dev)
    QB = torch.randn(B, d, generator=g, device=dev)
    (q1, s1), (qb, sb) = quantize(torch, Q1), quantize(torch, QB)
    lut1 = torch.randn(1, M, 256, generator=g, device=dev)
    lutb = torch.randn(B, M, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n, M), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    admitted = dense.sum(1)[sid.long()].sum().item()
    union = dense.any(0).sum().item()
    names = ("scan_pass1", "scan_pass2")
    for metric, k1, kb in (("l2", 80, 40), ("ip", 40, 80)):
        # both windows at both batch sizes are checked; the second (the
        # main path's r = 40 at q = 1 and r = 80 at q = 64, ip) is timed
        exact_case(torch, f"scoped_topk_i8 main {metric}",
                   ops.scoped_topk_i8(q1, s1, x8, xs, sq, ones, k1, metric),
                   ref.scoped_topk_i8_ref(q1, s1, x8, xs, sq, ones, k1,
                                          metric))
        got = ops.multi_scope_topk_i8(qb, sb, x8, xs, sq, words, sid, kb,
                                      metric)
        exact_case(torch, f"multi_scope_topk_i8 main {metric}", got,
                   ref.multi_scope_topk_i8_ref(qb, sb, x8, xs, sq, words,
                                               sid, kb, metric))
        same_as_dense(torch, f"multi_scope_topk_i8 main {metric} vs "
                      f"scoped_topk_i8", got,
                      lambda i, m: ops.scoped_topk_i8(
                          qb[i:i + 1], sb[i:i + 1], x8, xs, sq, m, kb,
                          metric), dense, sid)
        del got
        exact_case(torch, f"scoped_topk_pq main k={k1}",
                   ops.scoped_topk_pq(lut1, codes, ones, k1),
                   ref.scoped_topk_pq_ref(lut1, codes, ones, k1))
        got = ops.multi_scope_topk_pq(lutb, codes, words, sid, kb)
        exact_case(torch, f"multi_scope_topk_pq main k={kb}", got,
                   ref.multi_scope_topk_pq_ref(lutb, codes, words, sid, kb))
        same_as_dense(torch, f"multi_scope_topk_pq main k={kb} vs "
                      f"scoped_topk_pq", got,
                      lambda i, m: ops.scoped_topk_pq(lutb[i:i + 1], codes,
                                                      m, kb), dense, sid)
        del got
        cases += 4

    out["scoped_topk_i8"] = dense_i8_record(
        torch, ops, ref, peaks, (q1, s1, x8, xs, None, ones, 40), {},
        "scoped_topk_i8 main k=40")
    out["multi_scope_topk_i8"] = {
        "max_abs_err": 0.0,
        **timed(torch, lambda: ops.multi_scope_topk_i8(
            qb, sb, x8, xs, None, words, sid, 80), 30, names),
        "plain_ms": median_ms(torch, lambda: ref.multi_scope_topk_i8_ref(
            qb, sb, x8, xs, None, words, sid, 80), 5),
        "library_ms": library_int_mm(torch, qb, x8),
        **bound(union * (d + 4) + S * n_words * 4 + B * (d + 8 + 80 * 8),
                2.0 * admitted * d, peaks, "int8"),
        "shape": f"q={B} n={n} d={d} k=80 ip scopes={S} "
                 f"admitted_pairs={admitted}; library: torch._int_mm "
                 f"({B},{d})x({d},{n})"}
    out["scoped_topk_pq"] = dense_pq_record(
        torch, ops, ref, peaks, (lut1, codes, ones, 40), {},
        "scoped_topk_pq main k=40")
    out["multi_scope_topk_pq"] = {
        "max_abs_err": 0.0,
        **timed(torch, lambda: ops.multi_scope_topk_pq(
            lutb, codes, words, sid, 80), 30, names),
        "plain_ms": median_ms(torch, lambda: ref.multi_scope_topk_pq_ref(
            lutb, codes, words, sid, 80), 5),
        "library_ms": None,
        **bound(union * M + S * n_words * 4 + B * (M * 256 * 4 + 4 + 80 * 8),
                1.0 * admitted * M, peaks),
        **lookup_bound(torch, admitted * M),
        "pass1_device_ms": device_ms(torch, lambda: ops.multi_scope_topk_pq(
            lutb, codes, words, sid, 80), 10, ("scan_pass1",)),
        "shape": f"q={B} n={n} M={M} k=80 scopes={S} "
                 f"admitted_pairs={admitted}; "
                 f"shared-memory LUT lookups {admitted * M}"}
    # a diagnostic of kernel 8's limiter: the same scan over codes whose
    # 32 consecutive rows fall on 32 distinct banks at every m, so a warp's
    # LUT reads never conflict (random codes conflict several ways)
    r = torch.arange(n, device=dev)[:, None]
    spread = ((r % 32) + 32 * ((r // 32 + torch.arange(M, device=dev)) % 8)
              ).to(torch.uint8)
    exact_case(torch, "multi_scope_topk_pq conflict-free codes",
               ops.multi_scope_topk_pq(lutb, spread, words, sid, 80),
               ref.multi_scope_topk_pq_ref(lutb, spread, words, sid, 80))
    out["multi_scope_topk_pq"]["conflict_free_codes"] = {
        **timed(torch, lambda: ops.multi_scope_topk_pq(
            lutb, spread, words, sid, 80), 30, names),
        "shape": f"as the main shape, codes (r % 32) + 32 ((r // 32 + m) "
                 f"% 8): no bank conflicts among a warp's rows"}
    del spread
    cases += 1
    return cases


IVF_LISTS = 64     # benchmarks/bench_ivf_batch.py: min(64, n / 64) lists
IVF_NPROBE = 8     # ... probed per query
# synthetic list weights (1 + i)^-IVF_SKEW: the widest list ~2.4x the mean,
# as in phase 5's k-means layout (70,240 aligned rows against 30,312)
IVF_SKEW = 0.3


def synthetic_layout(torch, g, n, B, dev):
    """A padded-CSR layout of n rows skewed like phase 5's k-means lists:
    IVF_LISTS lists of weight (1 + i)^-IVF_SKEW in random order, random
    rows in ascending id order within a list, each padded with -1 to a
    multiple of 32; IVF_NPROBE distinct lists per query, drawn in
    proportion to the lists' sizes (wide lists draw more queries). Returns
    ((offsets, aligned, flat_ids, max_aligned), probe (B, IVF_NPROBE)
    int32): the list-form arguments of kernel 9."""
    w = (1.0 + torch.arange(IVF_LISTS, device=dev,
                            dtype=torch.float64)) ** -IVF_SKEW
    w = w[torch.randperm(IVF_LISTS, generator=g, device=dev)]
    sizes = torch.floor(w / w.sum() * n).long()
    sizes[0] += n - int(sizes.sum())
    perm = torch.randperm(n, generator=g, device=dev)
    aligned = (sizes + 31) // 32 * 32
    offsets = torch.cumsum(aligned, 0) - aligned
    starts = torch.cumsum(sizes, 0) - sizes
    flat = torch.full((int(aligned.sum()) + 1,), -1, dtype=torch.int32,
                      device=dev)
    for c in range(IVF_LISTS):
        o, s0, ln = int(offsets[c]), int(starts[c]), int(sizes[c])
        flat[o:o + ln] = perm[s0:s0 + ln].sort().values.to(torch.int32)
    probe = torch.multinomial(sizes.double().repeat(B, 1), IVF_NPROBE,
                              replacement=False, generator=g)
    return (offsets, aligned, flat, int(aligned.max())), \
        probe.to(torch.int32)


def expand(torch, layout, probe):
    """The (B, nprobe * max_aligned) candidate matrix of a layout's probes:
    probed list p's ids at positions p * max_aligned + o, -1 past its
    region (the IVF executor's expansion, which its card path never
    builds)."""
    offsets, aligned, flat, max_aligned = layout
    within = torch.arange(max_aligned, device=flat.device)
    p = probe.long()
    inside = within < aligned[p][..., None]
    idx = torch.where(inside, offsets[p][..., None] + within, 0)
    cand = torch.where(inside, flat[idx], -1)
    return cand.reshape(probe.shape[0], -1)


def phase1_ivf(torch, ops, ref, peaks, g, out, X, words, sid) -> int:
    """Kernel 9 and its int8 / PQ modes: edge shapes (all padding, k past
    the admitted candidates, C = 1, C not a multiple of 256, d = 3 and
    8192, position ties, ip and l2, short words, a scope id out of range),
    then the main shape: B = 64 over a synthetic layout of the main path's
    rows (64 lists, 8 probed: C = 242,688), k = 10 and 80, timed, and
    the int8 mode at k = 80 in both forms (phase5_kernels repeats the main
    shape on the real layout)."""
    dev = torch.device("cuda")
    cases = 0
    for b, c, n, d, m, k, pad, short in (
            (3, 96, 400, 16, 4, 5, 1.0, False),        # all padding
            (5, 37, 300, 16, 4, 40, 0.5, False),       # k > admitted
            (2, 1, 64, 8, 4, 3, 0.0, False),           # C = 1
            (4, 300, 2000, 3, 3, 10, 0.2, False),      # d = 3, C % 256
            (3, 700, 5000, 8192, 64, 10, 0.1, False),  # d = 8192, sliced
            (6, 513, 3000, 32, 8, 17, 0.2, True)):     # short words
        Q = torch.randn(b, d, generator=g, device=dev)
        Xe = torch.randn(n, d, generator=g, device=dev)
        Xe[n - 2] = Xe[n - 1]                      # equal rows ...
        cand = torch.stack([torch.randperm(n, generator=g, device=dev)[:c]
                            for _ in range(b)]).to(torch.int32)
        cand[torch.rand(b, c, generator=g, device=dev) < pad] = -1
        if c >= 4 and pad < 1.0:                   # ... at positions 1, 3
            cand[0, 1], cand[0, 3] = n - 1, n - 2
        dn = torch.rand(3, n, generator=g, device=dev) < 0.6
        dn[:, n - 2:] = True
        dn[1] = False                              # an empty scope
        W = words_of(torch, dn)
        s1 = torch.randint(0, 3, (b,), generator=g, device=dev,
                           dtype=torch.int32)
        if b > 2:
            s1[-1] = 3                             # a scope out of range
        if short:                                  # rows past them: out
            W = W[:, : W.shape[1] // 2]
        Wk = W
        W = torch.nn.functional.pad(W, (0, (n + 31) // 32 - W.shape[1]))
        q8, qs = quantize(torch, Q)
        x8, xs = quantize(torch, Xe)
        sq8 = (x8.float() ** 2).sum(1) * xs * xs
        lut, codes = pq_case(torch, g, b, n, m, dev)
        codes[n - 2] = codes[n - 1]
        sq = ref.row_sq_norms(Xe)
        label = f"b{b} C{c} n{n} d{d} k{k} pad{pad}" + (" short" if short
                                                        else "")
        for metric in ("ip", "l2"):
            topk_case(ref, f"ivf_gather_topk {label} {metric}",
                      ops.ivf_gather_topk(Q, Xe, cand, Wk, s1, k, metric,
                                          sq),
                      ref.ivf_gather_topk_ref(Q, Xe, cand, W, s1, k, metric,
                                              sq))
            exact_case(torch, f"ivf_gather_topk_i8 {label} {metric}",
                       ops.ivf_gather_topk_i8(q8, qs, x8, xs, sq8, cand, Wk,
                                              s1, k, metric),
                       ref.ivf_gather_topk_i8_ref(q8, qs, x8, xs, sq8, cand,
                                                  W, s1, k, metric))
            cases += 2
        exact_case(torch, f"ivf_gather_topk_pq {label}",
                   ops.ivf_gather_topk_pq(lut, codes, cand, Wk, s1, k),
                   ref.ivf_gather_topk_pq_ref(lut, codes, cand, W, s1, k))
        cases += 1

    # main shape: WIKI-Dir's rows and the phase-1 scopes, 8 of 64 skewed
    # lists, the list form (the main path's) and the candidate form
    n, d, M, B = X.shape[0], X.shape[1], 32, sid.shape[0]
    layout, probe = synthetic_layout(torch, g, n, B, dev)
    QB = torch.randn(B, d, generator=g, device=dev)
    qb, sb = quantize(torch, QB)
    x8, xs = quantize(torch, X)
    lut = torch.randn(B, M, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n, M), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    note = (f" (synthetic: n={n}, {IVF_LISTS} lists of weights "
            f"(1 + i)^-{IVF_SKEW}, {IVF_NPROBE} probed)")
    listed = (*layout, probe, words, sid)
    rec = ivf_record(torch, ops, ref, peaks, "ivf_gather_topk",
                     (QB, X, *listed, 10), {})
    rec["k80"] = ivf_record(torch, ops, ref, peaks, "ivf_gather_topk",
                            (QB, X, *listed, 80), {}, runs=10)
    rec["library_ms"], lib = library_bmm(torch, X, expand(torch, layout, probe),
                                         QB)
    rec["shape"] += f"{note}; library: {lib}"
    out["ivf_gather_topk"] = rec
    cand = expand(torch, layout, probe)
    exact_case(torch, "ivf_probe_topk_i8 main k=80",
               ops.ivf_probe_topk_i8(qb, sb, x8, xs, None, *listed, 80),
               ref.ivf_probe_topk_i8_ref(qb, sb, x8, xs, None, *listed, 80))
    exact_case(torch, "ivf_gather_topk_i8 main k=80",
               ops.ivf_gather_topk_i8(qb, sb, x8, xs, None, cand, words,
                                      sid, 80),
               ref.ivf_gather_topk_i8_ref(qb, sb, x8, xs, None, cand, words,
                                          sid, 80))
    del cand
    for name, args in (
            ("ivf_gather_topk_i8", (qb, sb, x8, xs, None, *listed, 40)),
            ("ivf_gather_topk_pq", (lut, codes, *listed, 80))):
        out[name] = ivf_record(torch, ops, ref, peaks, name, args, {})
        out[name]["shape"] += note
    return cases + 6


IVF_KERNELS = ("ivf_gather_topk", "ivf_gather_topk_i8", "ivf_gather_topk_pq")
IVF_KIND = dict(zip(IVF_KERNELS, ("f32", "i8", "pq")))
# each kernel-9 mode's list-form wrapper (the main path's entry point)
IVF_LIST = {name: name.replace("gather", "probe") for name in IVF_KERNELS}
_LAYOUT = ("offsets", "aligned", "flat_ids", "max_aligned", "probe")


def ivf_admitted(torch, cand, words, sids):
    """(admitted (query, candidate) pairs, distinct admitted rows, the
    (B, C) admission mask): the work kernel 9 must do on these inputs."""
    S = words.shape[0]
    ok = (sids >= 0) & (sids < S)
    qwords = words[sids.long().clamp(0, S - 1)]
    safe = cand.clamp(min=0).long()
    bit = (torch.gather(qwords, 1, safe >> 5).long() >> (safe & 31)) & 1
    adm = (cand >= 0) & (bit != 0) & ok[:, None]
    return int(adm.sum()), int(torch.unique(cand[adm]).numel()), adm


def ivf_tiles(torch, cand, adm, probe, max_aligned, qt) -> dict:
    """What the list form's query tiles of ``qt`` stage: each list's
    probing queries in ascending order (the wrapper's stable sort), cut
    into tiles of qt; a block stages each row that some query of its tile
    admits. ``tile_rows`` counts those rows over all tiles (the distinct
    admitted rows when no list has more than qt queries), beside the
    probed lists with more queries than one tile holds and the distinct
    admitted rows of those lists."""
    B, nprobe = probe.shape
    lists = probe.reshape(-1).long()
    by_list, order = torch.sort(lists, stable=True)
    first = torch.searchsorted(by_list, by_list)
    rank = torch.empty_like(lists)
    rank[order] = torch.arange(lists.numel(), device=lists.device) - first
    per_list = torch.bincount(lists)
    T = (B + qt - 1) // qt
    tile = (lists * T + rank // qt).reshape(B, nprobe)
    slot = torch.arange(cand.shape[1], device=cand.device) // max_aligned
    b, c = adm.nonzero(as_tuple=True)
    rows = cand[b, c].long()
    key = tile[b, slot[c]] * (int(rows.max()) + 1 if rows.numel() else 1) \
        + rows
    wide = per_list[probe.long()[b, slot[c]]] > qt
    return {"qt": qt, "tile_rows": int(torch.unique(key).numel()),
            "max_list_queries": int(per_list.max()),
            "lists_past_tile": int((per_list > qt).sum()),
            "rows_in_lists_past_tile": int(torch.unique(rows[wide]).numel())}


def ivf_record(torch, ops, ref, peaks, mode, args, kw, runs=20) -> dict:
    """Kernel 9 in ``mode`` (fp32, int8 or PQ: a name of IVF_KERNELS) on
    the list-form arguments ``args`` / ``kw`` (those of its
    ``ivf_probe_topk*`` wrapper): the list form (the main path's) and the
    candidate form on the expanded (B, nprobe * max_aligned) matrix, held
    bit for bit against each other and against the plain version (fp32
    within TOL up to ties, int8 and PQ bit for bit), both timed. Each is
    bounded by what it must read: the list form the probes, each probed
    list's offset, length and ids once, the candidate form its (B, C) ids;
    both the scope words, each distinct admitted row once and the queries
    and results; and by the operations of every admitted (query,
    candidate) pair. The record is the list form's, with what its query
    tiles stage under "tiles" (:func:`ivf_tiles`) and the candidate form's
    record under "cand_form"."""
    lname = IVF_LIST[mode]
    a = bound_args(ops, lname, args, kw)
    layout = tuple(a[key] for key in _LAYOUT[:4])
    probe = a["probe"]
    cand = expand(torch, layout, probe)
    forms = {"list": (lname, dict(a)),
             "cand": (mode, {**{key: v for key, v in a.items()
                                if key not in _LAYOUT + ("per_list",)},
                             "cand_ids": cand})}
    words, sids, k = a["mask_words"], a["scope_ids"], a["k"]
    metric = a.get("metric", "ip")
    rows = a["codes"] if mode == "ivf_gather_topk_pq" else a.get(
        "rows", a.get("rows_i8"))
    B, C = cand.shape
    S, n_words = ops.as_words(words).shape
    pairs, uniq, adm = ivf_admitted(torch, cand, ops.as_words(words), sids)
    depth = rows.shape[1]
    if mode == "ivf_gather_topk_pq":     # codes, LUTs; one add per byte
        row_bytes, q_bytes = depth, B * depth * 256 * 4
        ops_, kind = 1.0 * pairs * depth, "fp32"
    elif mode == "ivf_gather_topk_i8":   # codes + scale; int8 dots
        row_bytes, q_bytes = depth + 4, B * (depth + 4)
        ops_, kind = 2.0 * pairs * depth, "int8"
    else:
        row_bytes, q_bytes = depth * 4, B * depth * 4
        ops_, kind = 2.0 * pairs * depth, "fp32"
    if metric == "l2":
        row_bytes += 4                   # the row's squared norm
    probed = probe.long().unique()
    id_bytes = {"list": probe.numel() * 4 + probed.numel() * 16
                + int(layout[1][probed].sum()) * 4,
                "cand": B * C * 4}
    shape = (f"B={B} nprobe={probe.shape[1]} C={C} k={k} "
             f"admitted_pairs={pairs} unique_rows={uniq}")
    got = {}
    recs = {}
    for form, (name, call) in forms.items():
        kernel = getattr(ops, name)
        plain = getattr(ref, name + "_ref")
        plain_kw = {key: v for key, v in call.items()
                    if key not in ("check_ids", "per_list")}
        got[form] = kernel(**call)
        want = plain(**plain_kw)
        label = f"{name} {shape}"
        err = (topk_case(ref, label, got[form], want)
               if mode == "ivf_gather_topk"
               else exact_case(torch, label, got[form], want))
        del want
        recs[form] = {
            "max_abs_err": err,
            **timed(torch, lambda: kernel(**call), runs,
                    ("scan_pass1", "scan_pass2")),
            "plain_ms": median_ms(torch, lambda: plain(**plain_kw), 3),
            "library_ms": None,
            **bound(id_bytes[form] + S * n_words * 4 + q_bytes + B * k * 8
                    + uniq * row_bytes, ops_, peaks, kind),
            "pair_bytes": pairs * row_bytes,
            "shape": f"{shape} depth={depth} {metric}"}
        if mode == "ivf_gather_topk_pq":
            recs[form].update(lookup_bound(torch, pairs * depth))
    check(torch.equal(got["list"][0], got["cand"][0])
          and torch.equal(got["list"][1], got["cand"][1]),
          f"{mode} {shape}: the list form != the candidate form")
    import importlib                     # (the package exports a function
    st = importlib.import_module(        # of the module's name)
        "repro_torch.kernels.scoped_topk")
    qt = min(B, a.get("per_list") or B, st.LIST_Q)
    if rows.is_cuda:                     # the plan's tile (smaller at big k)
        qt = st.list_plan(IVF_KIND[mode], qt, depth, k).qt
    tiles = ivf_tiles(torch, cand, adm, probe, layout[3], qt)
    tiles["tile_bytes"] = tiles["tile_rows"] * row_bytes
    return {**recs["list"], "tiles": tiles, "cand_form": recs["cand"]}


def library_bmm(torch, rows, cand, queries):
    """The library yardstick of kernel 9: scores only, over a pre-gathered
    (B, C, d) block (the reference's shape, which the port never builds),
    on as many queries as fit in free device memory."""
    B, C = cand.shape
    d = rows.shape[1]
    free = torch.cuda.mem_get_info(rows.device)[0]
    bl = B
    while bl > 1 and bl * C * d * 4 * 1.5 > free:
        bl //= 2
    block = rows[cand[:bl].clamp(min=0).long()]
    qcol = queries[:bl, :, None].float()
    ms = median_ms(torch, lambda: torch.bmm(block, qcol), 10)
    del block
    return ms, f"torch.bmm ({bl},{C},{d})x({bl},{d},1), no mask, no top-k"


# kernel 10 against its plain version. fp32: tests/test_kernels.py's
# rtol = atol form, |got - want| <= 3e-4 (1 + |want|) (sums in another
# order). bf16: the kernel rounds each weight p to bf16 before the PV
# product (relative error <= 2^-9), which moves an output by at most
# 2^-9 A, A = sum p |v| / l (the plain version on |v|); both round their
# outputs to bf16, one ulp <= 2^-7 |value|. So |got - want| <= 2^-7
# (|want| + A), which also holds an empty row (A = 0) to exact zeros.
FLASH_TOL_F32 = 3e-4
FLASH_REL_BF16 = 2.0 ** -7
RAG_SHAPE = (64, 16, 8, 532, 128)   # b, h, kv, cache positions, d
LONG_S = 32_768                     # configs/__init__.py's decode_32k
# phase 11's kernel-10 calls, timed in phase 1 on synthetic inputs: label ->
# (b, h, kv, cache positions, d, sliding window or 0, shortest length)
FAMILY_FLASH = {
    "hymba_b64": (64, 25, 5, 661, 64, 0, 646),
    "hymba_b4": (4, 25, 5, 2_193, 64, 1_024, 2_178),
    "phi3_b4": (4, 32, 32, 224, 96, 0, 209),
    "whisper_xattn": (16, 20, 20, 1_500, 64, 0, 1_500),
}
# kernel 10's split kernel and its combine: both are one call's device time
FLASH_KERNELS = ("flash_decode_kernel", "flash_decode_combine")


def flash_case(torch, ops, ref, label, q, k, v, mask, fn=None):
    """Kernel 10 (``fn``, else ``ops.flash_decode``) vs its plain version
    on the same inputs, within FLASH_TOL_F32 / FLASH_REL_BF16; a row that
    admits nothing must give zeros. Returns the largest absolute difference
    and the plain value where it occurs."""
    got = (fn or ops.flash_decode)(q, k, v, mask)
    want = ref.flash_decode_ref(q, k, v, mask)
    check(got.dtype == q.dtype and bool(torch.isfinite(got.float()).all()),
          f"{label}: dtype or non-finite output")
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    if q.dtype == torch.bfloat16:
        spread = ref.flash_decode_ref(q.float(), k.float(), v.float().abs(),
                                      mask)
        limit = FLASH_REL_BF16 * (mag + spread)
    else:
        limit = FLASH_TOL_F32 * (1 + mag)
    err = float(diff.max()) if got.numel() else 0.0
    at = float(want.float().flatten()[diff.argmax()]) if got.numel() \
        else 0.0
    check(bool((diff <= limit).all()),
          f"{label}: beyond tolerance, max abs err {err} at value {at}")
    empty = mask.sum(1) == 0
    check(bool((got[empty] == 0).all()), f"{label}: empty row not zero")
    return err, at


def flash_inputs(torch, g, b, h, kv, s, d, dtype, lo=1, window=0):
    """Random q, k, v and a ragged (b, s) int8 mask (lengths in [lo, s]),
    admitting only the last ``window`` positions of each row if > 0."""
    dev = g.device
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, kv, s, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, kv, s, d, generator=g, device=dev).to(dtype)
    lens = torch.randint(lo, s + 1, (b,), generator=g, device=dev)
    pos = torch.arange(s, device=dev)[None]
    mask = pos < lens[:, None]
    if window:
        mask &= pos >= lens[:, None] - window
    return q, k, v, mask.to(torch.int8)


def flash_record(torch, ops, ref, peaks, q, k, v, mask, runs=30) -> dict:
    """Kernel 10 on (q, k, v, mask): held against its plain version, timed
    (with ``host_us``, the wrapper's host cost alone) beside it and beside
    one ``scaled_dot_product_attention`` call on the same inputs (a
    yardstick the port never calls), and bounded by the
    bytes it must move (q, the mask, K and V rows at admitted positions,
    the output) and its 4 h d operations per admitted position."""
    import torch.nn.functional as F
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    label = f"flash_decode b={b} h={h} kv={kv} s={s} d={d} {q.dtype}"
    err, at = flash_case(torch, ops, ref, label, q, k, v, mask)
    admitted = int(mask.sum())
    elem = q.element_size()
    nbytes = 2 * q.numel() * elem + mask.numel() + 2 * admitted * kv * d * elem
    attn_mask = mask.bool()[:, None, None, :]
    kind = "bf16" if q.dtype == torch.bfloat16 else "fp32"
    plan = getattr(ops._fd, "split_plan", None)
    splits = {} if plan is None else {"n_split": plan(
        b, kv, s, h // kv, q.dtype,
        torch.cuda.get_device_properties(q.device).multi_processor_count)}
    return {"max_abs_err": err, "err_at_value": at, **splits,
            **timed(torch, lambda: ops.flash_decode(q, k, v, mask), runs,
                    FLASH_KERNELS),
            "host_us": host_us(torch, lambda: ops.flash_decode(q, k, v,
                                                               mask)),
            "plain_ms": median_ms(
                torch, lambda: ref.flash_decode_ref(q, k, v, mask), 10),
            "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=attn_mask, enable_gqa=True),
                runs),
            **bound(nbytes, 4.0 * h * d * admitted, peaks, kind),
            "shape": f"{label} admitted={admitted}; library: "
                     "scaled_dot_product_attention(bool mask, enable_gqa)"}


def phase1_flash(torch, ops, ref, peaks, g, out) -> int:
    """Kernel 10 against its plain version: the reference sweep
    (tests/test_kernels.py:340-346), the CPU tests' edge cases (s = 1, a
    ragged tail at s = 532, groups 1 / 3 / 8 / 40, d = 256, an odd d,
    holes, rows that admit nothing), each also with the cache forced into
    one split per 64-position tile (the launch wrapper's ``n_split``), then
    timed at the RAG decode shape, at a 32,768-position cache and at phase
    11's four family shapes (``FAMILY_FLASH``)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = 0
    for b, h, kv, s, d, dt in (
            (2, 8, 2, 1000, 64, f32), (1, 4, 4, 512, 128, f32),
            (3, 16, 8, 700, 32, f32), (2, 8, 8, 256, 64, f32),
            (2, 8, 2, 512, 64, bf16), (2, 4, 2, 1, 32, f32),
            (3, 16, 8, 532, 128, f32), (3, 16, 8, 532, 128, bf16),
            (2, 4, 4, 200, 64, bf16), (2, 6, 2, 257, 48, f32),
            (2, 16, 2, 130, 64, bf16), (2, 8, 1, 300, 256, f32),
            (3, 4, 2, 99, 13, bf16), (3, 4, 2, 99, 13, f32),
            (3, 80, 2, 300, 64, bf16), (3, 8, 1, 300, 256, bf16)):
        q, k, v, mask = flash_inputs(torch, g, b, h, kv, s, d, dt)
        if b > 2:
            mask[0] &= (torch.arange(s, device=g.device) % 7 < 5).to(
                torch.int8)                                   # holes
            mask[-1] = 0                                      # admits nothing
        label = f"flash_decode edge {b, h, kv, s, d} {dt}"
        flash_case(torch, ops, ref, label, q, k, v, mask)
        tiles = -(-s // ops._fd.SPLIT_TILE)
        if tiles > 1:
            flash_case(torch, ops, ref, f"{label} n_split={tiles}", q, k, v,
                       mask, lambda *a: ops._fd.flash_decode(
                           *a, n_split=tiles))
        cases += 1
    b, h, kv, s, d = RAG_SHAPE
    q, k, v, mask = flash_inputs(torch, g, b, h, kv, s, d, bf16, lo=s - 15)
    rec = flash_record(torch, ops, ref, peaks, q, k, v, mask)
    del q, k, v, mask
    q, k, v, mask = flash_inputs(torch, g, 1, h, kv, LONG_S, d, bf16,
                                 lo=LONG_S)
    rec["long"] = flash_record(torch, ops, ref, peaks, q, k, v, mask, 10)
    del q, k, v, mask
    for label, (b, h, kv, s, d, window, lo) in FAMILY_FLASH.items():
        q, k, v, mask = flash_inputs(torch, g, b, h, kv, s, d, bf16, lo=lo,
                                     window=window)
        rec[label] = flash_record(torch, ops, ref, peaks, q, k, v, mask)
        del q, k, v, mask
    out["flash_decode"] = rec
    return cases + 2 + len(FAMILY_FLASH)


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
    path = MainPath(ops)
    captured, gathers = {}, []
    ta = time.perf_counter()
    with path.counted(), first_calls(
            ops, ("multi_scope_topk", "ivf_probe_topk"), captured):
        batch = batched()
    tb = time.perf_counter()
    per_batch = dict(path.counts)
    with recorded_calls(ops, "scoped_topk", range(1 << 30), gathers):
        loop = looped()
    tc = time.perf_counter()
    # kernel 1's widest gather-plan launch in the loop of dsq (a scan-plan
    # dsq passes every row of the store)
    gathers = [call for call in gathers
               if call[1][1].shape[0] < len(db.store)]
    if gathers:
        widest = max(gathers, key=lambda call: call[1][1].shape[0])
        captured["scoped_topk"] = widest[1:]
    del gathers
    check(same_results(batch, loop), "dsq_batch != loop of dsq (bitwise)")
    plans = {r.plan for r in batch}
    check({"scan", "gather"} <= plans, f"plans {plans} lack scan or gather")
    acct = batch[0].batch
    # the batch's gather scopes: one kernel-9 list launch, no kernel 1
    check(per_batch["ivf_gather_topk"] == 1 and per_batch["scoped_topk"] == 0
          and acct.gather_listed == acct.plan_groups["gather"],
          f"gather scopes not in one list launch: {per_batch}, "
          f"{acct.gather_listed} of {acct.plan_groups['gather']} listed")
    # on-device selectivity of every scan group's cached device mask
    scan_keys = list({ScopeKey.from_spec(spec) for spec, r in zip(
        normalize_batch(paths, rec), batch) if r.plan == "scan"})
    scan_groups, _ = db.planner().resolve_scopes(
        db.namespaces["fs"], len(db.store), scan_keys)
    for key, ent in scan_groups.items():
        with path.counted():               # the selectivity entry point
            size = device_popcount(ent.words)
        check(size == ent.scope_size,
              f"device_popcount != scope_size for {key}")
    # the single-request path: dsq ranks both plans through kernel 1
    with path.counted():
        for plan in ("gather", "scan"):
            i = next(j for j, r in enumerate(batch) if r.plan == plan)
            db.dsq(queries[i], paths[i], k=k, recursive=rec[i])
    counts = dict(path.counts)
    check(counts["multi_scope_topk"] > 0 and counts["scoped_topk"] > 0
          and counts["ivf_gather_topk"] > 0,
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
          "launches_per_batch": per_batch, "launches_main_path": counts,
          "launches_phase": ops.launch_counts(),
          "batch_first_ms": (tb - ta) * 1e3, "loop_first_ms": (tc - tb) * 1e3,
          "batch_warm_ms": (te - td) * 1e3, "loop_warm_ms": (tf - te) * 1e3,
          "directory_ns": acct.directory_ns, "ann_ns": acct.ann_ns,
          "gather_listed": acct.gather_listed,
          "scan_groups_popcount_checked": len(scan_groups),
          "recall_at_10": rec_k,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return ds, db, batched, looped, counts, captured


def phase2_kernels(torch, ops, ref, peaks, captured, measured) -> None:
    """Kernel 2 on the arguments phase 2's flat batch gave it (the scan
    plan's group on WIKI-Dir's real scope masks), by :func:`batch_record`;
    kernel 9 on the batch's one list launch over its gather-plan scopes
    (each scope's id list, every row admitted), by :func:`ivf_record`; and
    kernel 1 on the widest gather-plan launch of the loop of dsq (the
    scope's gathered rows under an all-ones mask), by :func:`dense_record`.
    Recorded beside phase 1's main shapes under "flat_batch",
    "flat_batch_gather" and "dsq_gather"; launches here are not the main
    path's."""
    for name in ("multi_scope_topk", "ivf_probe_topk", "scoped_topk"):
        check(name in captured, f"phase 2 recorded no {name} launch")
    args, kw = captured["multi_scope_topk"]
    rec = batch_record(torch, ops, ref, peaks, "multi_scope_topk", args, kw,
                       "multi_scope_topk flat batch")
    measured["multi_scope_topk"]["flat_batch"] = rec
    args, kw = captured["ivf_probe_topk"]
    listed = ivf_record(torch, ops, ref, peaks, "ivf_gather_topk", args, kw)
    measured["ivf_gather_topk"]["flat_batch_gather"] = listed
    args, kw = captured["scoped_topk"]
    gather = dense_record(torch, ops, ref, peaks, args, kw,
                          "scoped_topk dsq gather")
    measured["scoped_topk"]["dsq_gather"] = gather
    emit({"phase": "2-kernels", "multi_scope_topk": rec,
          "ivf_gather_topk": listed, "scoped_topk": gather})


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
    path = MainPath(ops)
    with path.counted():
        t0 = time.perf_counter()
        db.move(*target)
        result = db.dsm_batch(templates)
        t1 = time.perf_counter()
        after_batch = batched()             # patches the cached masks
    counts = dict(path.counts)
    stats = cache.stats()
    check(counts["bitmap_patch"] > 0, f"bitmap_patch not launched: {counts}")
    check(stats["patched"] > before["patched"], f"nothing patched: {stats}")
    check(same_results(after_batch, looped()),
          "after DSM: dsq_batch != loop of dsq (bitwise)")
    db._planners.clear()
    check(same_results(after_batch, batched()),
          "after DSM: patched-cache batch != uncached batch (bitwise)")
    db.check_invariants()
    emit({"phase": 3, "dsm_ops": 1 + len(templates),
          "dsm_rejected": sum(e is not None for e in result.errors),
          "dsm_ms": (t1 - t0) * 1e3, "cache": stats,
          "launches_main_path": counts, "launches_phase": ops.launch_counts(),
          "targeted_op": target})
    return counts


# --------------------------------------------------------------- phase 4
PQ_RESCORE_K = 80          # benchmarks/bench_pq.py's RESCORE_K (8 k)
PQ_WIDE_RESCORE_K = 320    # benchmarks/bench_pq.py's SCAN_RESCORE_K
INT8_RECALL = 0.99         # benchmarks/bench_quantized.py's gate
PQ_RECALL = 0.95           # benchmarks/bench_pq.py's gate


def set_recall(base, other) -> float:
    """recall@k of ``other`` against ``base`` as the reference benches
    count it: the share of base's ids that other returns."""
    hits = total = 0
    for a, b in zip(base, other):
        want = set(int(x) for x in a.ids[0] if x >= 0)
        got = set(int(x) for x in b.ids[0] if x >= 0)
        hits += len(want & got)
        total += len(want)
    return hits / max(total, 1)


def phase4(torch, ops, ds, db, batched):
    """int8 and PQ on the phase-2 database (after phase 3's DSM), then
    tiered storage. Every failed check is collected and reported at once.
    Returns the main path's launch counts, the arguments of the int8
    batch's kernel-6 launch, of its widest kernel-5 gather-plan launch, of
    the PQ batch's kernel-8 launch and of its widest kernel-7 gather-plan
    launch, and of every kernel-2 launch the int8 batch's exact rescore
    (``gather_rescore``) made."""
    _, paths, rec = requests(ds)
    queries = requests(ds)[0]
    k = 10
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    dev = db.device
    store = db.store
    n, d = len(store), store.dim
    fp = batched()                                    # the fp32 answers
    t0 = time.perf_counter()
    store.device_q_vectors(), store.device_q_scales()
    t1 = time.perf_counter()
    store.device_pq_codes()
    t2 = time.perf_counter()
    ops.reset_launch_counts()
    path = MainPath(ops)
    info = {"phase": 4, "int8_setup_s": t1 - t0, "pq_setup_s": t2 - t1,
            "pq_m": store.pq_codebook.m}
    results, captured, rescores, gathers, pq_gathers = {}, {}, [], [], []
    for prec, rk in (("int8", None), ("pq", PQ_RESCORE_K)):
        def batch():
            return db.dsq_batch(queries, paths, k=k, recursive=rec,
                                precision=prec, rescore_k=rk)
        ta = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(path.counted())
            if prec == "int8":
                stack.enter_context(first_calls(
                    ops, ("multi_scope_topk_i8",), captured))
                stack.enter_context(recorded_calls(
                    ops, "multi_scope_topk", range(1 << 30), rescores))
                stack.enter_context(recorded_calls(
                    ops, "scoped_topk_i8", range(1 << 30), gathers))
            else:
                stack.enter_context(first_calls(
                    ops, ("multi_scope_topk_pq",), captured))
                stack.enter_context(recorded_calls(
                    ops, "scoped_topk_pq", range(1 << 30), pq_gathers))
            b = batch()
        tb = time.perf_counter()
        loop = [db.dsq(queries[i], paths[i], k=k, recursive=rec[i],
                       precision=prec, rescore_k=rk)
                for i in range(len(paths))]
        tc = time.perf_counter()
        batch()
        td = time.perf_counter()
        gate(same_results(b, loop), f"{prec}: dsq_batch != loop of dsq")
        acct = b[0].batch
        results[prec] = b
        info[prec] = {
            "rescore_k": rk, "batch_first_ms": (tb - ta) * 1e3,
            "loop_ms": (tc - tb) * 1e3, "batch_warm_ms": (td - tc) * 1e3,
            "precision_groups": acct.precision_groups,
            "rescore_candidates": acct.rescore_candidates,
            "db_bytes_fp32": acct.db_bytes_fp32,
            f"db_bytes_{prec}": getattr(acct, f"db_bytes_{prec}"),
            "recall_at_10": set_recall(fp, b)}
    gate(info["int8"]["recall_at_10"] >= INT8_RECALL,
         f"int8 recall@10 {info['int8']['recall_at_10']} < {INT8_RECALL}")
    gate(info["pq"]["recall_at_10"] >= PQ_RECALL,
         f"pq recall@10 {info['pq']['recall_at_10']} < {PQ_RECALL}")
    # recall at a fixed window falls as scopes grow; reported at
    # benchmarks/bench_pq.py's scan window too
    info["pq"]["recall_at_10_r320"] = set_recall(fp, db.dsq_batch(
        queries, paths, k=k, recursive=rec, precision="pq",
        rescore_k=PQ_WIDE_RESCORE_K))

    # tiered: a device byte budget of a third of the fp32 rows
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    store.set_device_budget(store.alive_nbytes() // 3)
    torch.cuda.synchronize()
    freed = mem0 - torch.cuda.memory_allocated(dev)
    gate(store.tiered_active(), "budget set but the store is not tiered")
    gate(freed >= n * d * 4,
         f"fp32 mirror not released: {freed} B freed < {n * d * 4}")

    def tiered():
        return db.dsq_batch(queries, paths, k=k, recursive=rec,
                            rescore_k=PQ_RESCORE_K)
    with path.counted():
        ta = time.perf_counter()
        first = tiered()
        tb = time.perf_counter()
        second = tiered()
        tc = time.perf_counter()
    a1, a2 = first[0].batch, second[0].batch
    gate(a1.precision_groups.get("pq", 0) > 0,
         f"fp32 batch did not take the PQ plan: {a1.precision_groups}")
    gate(a1.tiered and a1.rescore_fetch_bytes > 0,
         f"no rescore fetch: {a1.rescore_fetch_bytes}")
    gate(a2.rows_device_pinned > 0
         and a2.rescore_fetch_bytes < a1.rescore_fetch_bytes,
         f"pins did not cut the fetch: {a1.rescore_fetch_bytes} -> "
         f"{a2.rescore_fetch_bytes} ({a2.rows_device_pinned} pinned)")
    gate(same_results(first, results["pq"]),
         "tiered batch != explicit PQ batch (bitwise)")
    gate(same_results(second, results["pq"]),
         "tiered batch with pins != explicit PQ batch (bitwise)")
    loop = [db.dsq(queries[i], paths[i], k=k, recursive=rec[i],
                   rescore_k=PQ_RESCORE_K) for i in range(len(paths))]
    gate(same_results(second, loop), "tiered: dsq_batch != loop of dsq")
    tiered_recall = set_recall(fp, second)
    gate(tiered_recall >= PQ_RECALL,
         f"tiered recall@10 {tiered_recall} < {PQ_RECALL}")
    counts = dict(path.counts)
    info["tiered"] = {
        "budget_bytes": store.device_budget, "fp32_mirror_freed": freed,
        "precision_groups": a1.precision_groups,
        "fetch_bytes_first": a1.rescore_fetch_bytes,
        "fetch_bytes_second": a2.rescore_fetch_bytes,
        "rows_device_pinned": a2.rows_device_pinned,
        "rows_host": a2.rows_host, "batch_first_ms": (tb - ta) * 1e3,
        "batch_second_ms": (tc - tb) * 1e3, "recall_at_10": tiered_recall}
    info["launches_main_path"] = counts
    info["launches_phase"] = ops.launch_counts()
    info["int8_rescore_launches"] = sorted(
        int(args[0].shape[0]) for _, args, _ in rescores)
    info["int8_gather_launches"] = sorted(
        int(args[2].shape[0]) for _, args, _ in gathers)
    if gathers:                 # kernel 5's widest gather-plan launch
        widest = max(gathers, key=lambda call: call[1][2].shape[0])
        captured["scoped_topk_i8"] = widest[1:]
    # kernel 7's gather-plan launches: (queries, gathered rows) each
    info["pq"]["pq_gather_launches"] = sorted(
        (int(args[0].shape[0]), int(args[1].shape[0]))
        for _, args, _ in pq_gathers)
    if pq_gathers:              # kernel 7's widest gather-plan launch
        widest = max(pq_gathers, key=lambda call: call[1][1].shape[0])
        captured["scoped_topk_pq"] = widest[1:]
    del gathers, pq_gathers
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return counts, captured, rescores


def phase4_kernels(torch, ops, ref, peaks, captured, rescores,
                   measured) -> None:
    """Kernels 6 and 8 on the arguments of phase 4's int8 and PQ batches
    (their scan groups on the real scope masks, int8 rows and PQ codes),
    and kernel 2 on the widest launch that the int8 batch's exact rescore
    made (``gather_rescore``'s block-diagonal masks over the gathered
    candidates), by :func:`batch_record`; kernel 5 on the widest of the
    int8 batch's gather-plan launches (the scope's gathered int8 rows
    under an all-ones mask), by :func:`dense_i8_record`, and kernel 7 on
    the widest of the PQ batch's (its gathered codes), by
    :func:`dense_pq_record`. Recorded beside phase 1's main shapes;
    launches here are not the main path's."""
    for name in ("multi_scope_topk_i8", "multi_scope_topk_pq",
                 "scoped_topk_i8", "scoped_topk_pq"):
        check(name in captured, f"phase 4 recorded no {name} launch")
    check(len(rescores) > 0, "phase 4 recorded no rescore launch")
    recs = {}
    for name, label in (("multi_scope_topk_i8", "int8 batch"),
                        ("multi_scope_topk_pq", "PQ batch")):
        args, kw = captured[name]
        recs[name] = batch_record(torch, ops, ref, peaks, name, args, kw,
                                  f"{name} {label}")
        measured[name]["flat_batch"] = recs[name]
    _, args, kw = max(rescores, key=lambda call: call[1][0].shape[0])
    recs["rescore"] = batch_record(torch, ops, ref, peaks, "multi_scope_topk",
                                   args, kw, "multi_scope_topk rescore")
    measured["multi_scope_topk"]["rescore"] = recs["rescore"]
    args, kw = captured["scoped_topk_i8"]
    recs["scoped_topk_i8"] = dense_i8_record(
        torch, ops, ref, peaks, args, kw, "scoped_topk_i8 int8 batch gather")
    measured["scoped_topk_i8"]["flat_batch_gather"] = recs["scoped_topk_i8"]
    args, kw = captured["scoped_topk_pq"]
    recs["scoped_topk_pq"] = dense_pq_record(
        torch, ops, ref, peaks, args, kw, "scoped_topk_pq PQ batch gather")
    measured["scoped_topk_pq"]["pq_batch_gather"] = recs["scoped_topk_pq"]
    emit({"phase": "4-kernels", **recs})


# --------------------------------------------------------------- phase 5
IVF_RECALL = 0.6           # tests/test_ivf_batch.py's floor at 12 of 16
IVF_RECALL_NPROBE = 48     # ... lists probed: 48 of 64 here
IVF_INGEST = 1000


@contextlib.contextmanager
def first_calls(ops, names, into: dict):
    """While open, ``ops``' wrappers ``names`` record the arguments of
    their first call into ``into`` (name -> (args, kwargs)) and launch as
    usual: the inputs the main path gives each kernel."""
    saved = {name: getattr(ops, name) for name in names}

    def recorder(name):
        def call(*args, **kw):
            into.setdefault(name, (args, kw))
            return saved[name](*args, **kw)
        return call

    for name in names:
        setattr(ops, name, recorder(name))
    try:
        yield into
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


class MainPath:
    """A phase's main-path launch counts: the launches made inside its
    ``with path.counted():`` windows, around the entry points it drives.
    The checks' own launches (loops held against a batch, reference
    batches, timings, profiler sessions) are made outside them."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = dict.fromkeys(ops.launch_counts(), 0)

    @contextlib.contextmanager
    def counted(self):
        before = self.ops.launch_counts()
        yield
        after = self.ops.launch_counts()
        for key in self.counts:
            self.counts[key] += after[key] - before[key]


def phase5(torch, ops, ref, ds, db):
    """The IVF executor on the phase-2 database (after phases 3 and 4; the
    phase-4 byte budget is lifted first). Every failed check is collected
    and reported at once. Returns the main path's launch counts (the build,
    the first batch of each precision, the deletes, the ingest, the
    repartition and the tiered batch; not the checks' batches, loops and
    timings) and the arguments of the first kernel-9 launch of each
    precision in the nprobe-8 mix."""
    from repro_torch.vectordb import IVFIndex
    _, paths, rec = requests(ds)
    queries = requests(ds)[0]
    k, B = 10, len(paths)
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    def sync_s(t0: float) -> float:
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    store = db.store
    store.set_device_budget(None)
    store.device_vectors()
    gate(not store.tiered_active(), "budget lifted but still tiered")
    ops.reset_launch_counts()
    path = MainPath(ops)
    info = {"phase": 5, "budget_lifted": True, "entries": len(store)}

    # 1-2: build (timed), twice: k-means repeats bit for bit
    with path.counted():
        t0 = time.perf_counter()
        db.build_ann("ivf", n_lists=IVF_LISTS, seed=0)
        info["build_s"] = sync_s(t0)
    ivf = db.executors["ivf"]
    t0 = time.perf_counter()
    twin = IVFIndex(store, n_lists=IVF_LISTS, seed=0)
    info["rebuild_s"] = sync_s(t0)
    gate(np.array_equal(ivf.centers, twin.centers)
         and all(np.array_equal(a, b) for a, b in zip(ivf.lists,
                                                      twin.lists)),
         "two k-means builds differ")
    del twin
    with path.counted():
        t0 = time.perf_counter()
        ivf.layout()
        info["layout_s"] = sync_s(t0)
    info["partition_stats"] = ivf.partition_stats()

    # 3: the 64-request mix at nprobe 8, batch == loop at every precision
    fp = db.dsq_batch(queries, paths, k=k, recursive=rec)     # flat fp32
    results, captured = {}, {}
    for prec, rk in (("fp32", None), ("int8", None), ("pq", PQ_RESCORE_K)):
        kw = dict(k=k, executor="ivf", nprobe=IVF_NPROBE, precision=prec,
                  rescore_k=rk)
        before = ops.launch_counts()
        ta = time.perf_counter()
        with path.counted(), first_calls(ops, IVF_LIST.values(), captured):
            b = db.dsq_batch(queries, paths, recursive=rec, **kw)
        tb = time.perf_counter()
        after = ops.launch_counts()
        loop = [db.dsq(queries[i], paths[i], recursive=rec[i], **kw)
                for i in range(B)]
        tc = time.perf_counter()
        db.dsq_batch(queries, paths, recursive=rec, **kw)
        td = time.perf_counter()
        gate(same_results(b, loop), f"ivf {prec}: dsq_batch != loop of dsq")
        acct = b[0].batch
        per_kernel = {key: after[key] - before[key] for key in after
                      if key.startswith("ivf_gather_topk")
                      and after[key] > before[key]}
        gate(acct.launches == len(acct.precision_groups)
             and all(v == 1 for v in per_kernel.values()),
             f"ivf {prec}: not one launch per precision: {acct.launches} "
             f"{acct.precision_groups} {per_kernel}")
        gate({r.plan for r in b} <= {"ivf", "empty"},
             f"ivf {prec}: plans {sorted({r.plan for r in b})}")
        results[prec] = b
        info[prec] = {"batch_first_ms": (tb - ta) * 1e3,
                      "loop_ms": (tc - tb) * 1e3,
                      "batch_warm_ms": (td - tc) * 1e3,
                      "launches": acct.launches,
                      "kernel_launches": per_kernel,
                      "precision_groups": acct.precision_groups,
                      "rescore_candidates": acct.rescore_candidates,
                      "recall_at_10_vs_flat": set_recall(fp, b)}

    # 4: probing every list is an exact scoped search
    sub = slice(0, 8)
    full = db.dsq_batch(queries[sub], paths[sub], k=k, recursive=rec[sub],
                        executor="ivf", nprobe=IVF_LISTS)
    for i, (a, f) in enumerate(zip(full, fp[sub])):
        err = ref.topk_disagreement(a.ids, a.scores, f.ids, f.scores, TOL)
        gate(err is None and a.scope_size == f.scope_size,
             f"nprobe={IVF_LISTS} request {i} != flat: {err}")

    # 5: recall@10 against flat fp32 (printed at 8, gated at 48)
    wide = db.dsq_batch(queries, paths, k=k, recursive=rec, executor="ivf",
                        nprobe=IVF_RECALL_NPROBE)
    info["recall_at_10"] = {str(IVF_NPROBE): set_recall(fp, results["fp32"]),
                            str(IVF_RECALL_NPROBE): set_recall(fp, wide)}
    gate(info["recall_at_10"][str(IVF_RECALL_NPROBE)] >= IVF_RECALL,
         f"recall@10 at nprobe {IVF_RECALL_NPROBE} "
         f"{info['recall_at_10'][str(IVF_RECALL_NPROBE)]} < {IVF_RECALL}")

    # 10: device time of the fp32 launch at B = 64 beside the flat batch's
    names = ("scan_pass1", "scan_pass2")

    def ivf_batch():
        return db.dsq_batch(queries, paths, k=k, recursive=rec,
                            executor="ivf", nprobe=IVF_NPROBE)

    def flat_batch():
        return db.dsq_batch(queries, paths, k=k, recursive=rec)

    info["device_ms"] = {"ivf_batch": device_ms(torch, ivf_batch, 5, names),
                         "flat_batch": device_ms(torch, flat_batch, 5,
                                                 names)}
    warm = {"flat": [], "ivf": []}
    for label in ("flat", "ivf", "ivf", "flat"):    # in turns
        t0 = time.perf_counter()
        (flat_batch if label == "flat" else ivf_batch)()
        warm[label].append(sync_s(t0) * 1e3)
    info["batch_warm_ms"] = warm

    # 6: deleted ids never come back
    victims = sorted({int(r.ids[0][0]) for r in results["fp32"][:16]
                      if r.ids[0][0] >= 0})[:5]
    with path.counted():
        for v in victims:
            db.delete(v)
    for prec, rk in (("fp32", None), ("int8", None), ("pq", PQ_RESCORE_K)):
        got = db.dsq_batch(queries, paths, k=k, recursive=rec,
                           executor="ivf", nprobe=IVF_NPROBE, precision=prec,
                           rescore_k=rk)
        seen = {int(x) for r in got for x in r.ids[0] if x >= 0}
        gate(not (seen & set(victims)), f"ivf {prec}: deleted ids returned")
    info["deleted"] = victims

    # 7: ingest; ivf.add routes the rows, the layout follows the store
    rng = np.random.default_rng(5)
    pick = rng.integers(0, len(ds.vectors), size=IVF_INGEST)
    new = ds.vectors[pick] + rng.normal(
        size=(IVF_INGEST, store.dim)).astype(np.float32) * 0.01
    with path.counted():
        t0 = time.perf_counter()
        ids = db.ingest(new.astype(np.float32),
                        [ds.entry_paths[i] for i in pick])
        info["ingest_s"] = sync_s(t0)
    members = np.concatenate(ivf.lists)
    gate(len(members) == len(store) and np.isin(ids, members).all(),
         f"ivf.add: {len(members)} members for {len(store)} rows")
    gate(ivf.layout().n == len(store), "layout does not follow the store")
    gate(same_results(ivf_batch(), [
        db.dsq(queries[i], paths[i], k=k, recursive=rec[i], executor="ivf",
               nprobe=IVF_NPROBE) for i in range(B)]),
         "after ingest: ivf dsq_batch != loop")

    # 8: repartition, then batch == loop again
    with path.counted():
        t0 = time.perf_counter()
        info["repartition"] = ivf.repartition(seed=0)
        info["repartition_s"] = sync_s(t0)
    info["partition_stats_after"] = ivf.partition_stats()
    gate(same_results(ivf_batch(), [
        db.dsq(queries[i], paths[i], k=k, recursive=rec[i], executor="ivf",
               nprobe=IVF_NPROBE) for i in range(B)]),
         "after repartition: ivf dsq_batch != loop")

    # 9: under a device budget fp32 IVF batches take the PQ plan; scopes
    # within the rescore window stay fp32 and rank their admitted
    # candidates' host rows (the tiered fork of search_multi), equal to
    # kernel 9's fp32 result in the explicit batch
    kw = dict(k=k, recursive=rec, executor="ivf", nprobe=IVF_NPROBE,
              rescore_k=PQ_RESCORE_K)
    explicit = db.dsq_batch(queries, paths, precision="pq", **kw)
    store.set_device_budget(store.alive_nbytes() // 3)
    gate(store.tiered_active(), "budget set but the store is not tiered")
    before = ops.launch_counts()
    with path.counted():
        tiered = db.dsq_batch(queries, paths, **kw)
    after = ops.launch_counts()
    gate(same_results(tiered, explicit),
         "tiered ivf batch != explicit PQ ivf batch (bitwise)")
    groups = tiered[0].batch.precision_groups
    info["tiered"] = {
        "precision_groups": groups,
        "explicit_precision_groups": explicit[0].batch.precision_groups,
        "kernel_launches": {key: after[key] - before[key] for key in after
                            if after[key] > before[key]}}
    gate(tiered[0].batch.tiered and groups.get("pq", 0) > 0
         and groups.get("fp32", 0) > 0
         and info["tiered"]["kernel_launches"].get("ivf_gather_topk", 0) == 0,
         f"tiered ivf batch took no host-row fp32 group: {info['tiered']}")
    counts = dict(path.counts)
    info["launches_main_path"] = counts
    info["launches_phase"] = ops.launch_counts()
    info["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return counts, captured


def phase5_kernels(torch, ops, ref, peaks, captured, measured) -> None:
    """Kernel 9 and its int8 / PQ modes on the inputs phase 5's main path
    gave their list form (the real k-means layout and probes), by
    :func:`ivf_record`: the list form and the candidate form on the
    expanded matrix (C = 8 * max_aligned, padding and all), each held
    against the other and against the plain version, and timed. These
    records take the place of phase 1's synthetic-layout ones, which stay
    beside them under "synthetic". Launches here are not the main
    path's."""
    real = {}
    for mode in IVF_KERNELS:
        name = IVF_LIST[mode]
        check(name in captured, f"{name}: phase 5 recorded no launch")
        args, kw = captured[name]
        rec = ivf_record(torch, ops, ref, peaks, mode, args, kw)
        if mode == "ivf_gather_topk":
            a = bound_args(ops, name, args, kw)
            rec["library_ms"], lib = library_bmm(
                torch, a["rows"], expand(
                    torch, tuple(a[key] for key in _LAYOUT[:4]), a["probe"]),
                a["queries"])
            rec["shape"] += f"; library: {lib}"
        real[mode] = rec
        prev = measured[mode]
        kept = {key: prev.pop(key) for key in ("flat_batch_gather",)
                if key in prev}
        measured[mode] = {**rec, **kept, "synthetic": prev}
    emit({"phase": "5-kernels", **real})


# --------------------------------------------------------------- phase 8
SHARDS = 4                 # row shards of phase 8's executor, on one card
SHARD_PRECISIONS = (("fp32", None), ("int8", None), ("pq", PQ_RESCORE_K))
SHARD_SCAN = {"fp32": "multi_scope_topk", "int8": "multi_scope_topk_i8",
              "pq": "multi_scope_topk_pq"}
SHARD_SMALL_INGEST = 1000  # 8e: rows that stay inside the capacity


def shard_record(torch, ops, ref, name, args, kw, label) -> dict:
    """One launch of kernel 2, 6 or 8 (``name``) on the arguments the main
    path gave it (a shard's rows and words, or the flat batch's over all
    rows): held against its plain version (fp32 ids tie-aware within TOL,
    int8 / PQ bit for bit) and timed."""
    def fn():
        return getattr(ops, name)(*args, **kw)

    def plain():
        return getattr(ref, name + "_ref")(*args, **kw)

    got = fn()
    err = (topk_case(ref, label, got, plain()) if name == "multi_scope_topk"
           else exact_case(torch, label, got, plain()))
    del got
    a = bound_args(ops, name, args, kw)
    rows = a.get("rows", a.get("rows_i8", a.get("codes")))
    scopes = ops.as_words(a["mask_words"]).shape[0]
    return {"max_abs_err": err,
            **timed(torch, fn, 10, ("scan_pass1", "scan_pass2")),
            "plain_ms": median_ms(torch, plain, 3),
            "shape": f"q={a['scope_ids'].shape[0]} n={rows.shape[0]} "
                     f"k={a['k']} scopes={scopes}"}


def phase8(torch, ops, ref, args, ds, db, card: str):
    """The sharded tier (module docstring, phase 8) on phase 5's database.
    Every failed check is collected and reported at once. Returns the main
    path's launch counts (the build, the first sharded batch of each
    precision, the DSM, the rmdirs, the ingests, the scheduled batches; not
    the flat batches, loops and records they are held against) and the
    state 8g reads after phase 7's compaction."""
    from repro_torch import faults
    from repro_torch.serving import ScheduledDSQ, SchedulerConfig
    from repro_torch.vectordb import model_of
    t_phase = time.perf_counter()
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    def sync_s(t0: float) -> float:
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    queries, paths, rec = requests(ds)
    k, B = 10, len(paths)
    store = db.store
    store.set_device_budget(None)           # phase 5 left a byte budget
    store.device_vectors()
    ops.reset_launch_counts()
    path = MainPath(ops)
    info = {"phase": 8, "card": card, "entries": len(store),
            "shards": SHARDS}

    def batch(executor, prec, rk, **kw):
        return db.dsq_batch(queries, paths, k=k, recursive=rec,
                            executor=executor, precision=prec, rescore_k=rk,
                            **kw)

    def both_equal(label):
        for prec, rk in SHARD_PRECISIONS:
            gate(same_results(batch("sharded", prec, rk),
                              batch("flat", prec, rk)),
                 f"{label} {prec}: sharded batch != flat batch (bitwise)")

    with path.counted():
        t0 = time.perf_counter()
        db.build_ann("sharded", n_shards=SHARDS)
        info["build_s"] = sync_s(t0)
    ex = db.executors["sharded"]
    gate(len(ex.mesh) == SHARDS
         and all(d.type == db.device.type for d in ex.mesh),
         f"8: mesh {ex.mesh}")

    # 8a-8b: the mix at three precisions; the shards' launches recorded
    shard_calls, whole_calls, a_info = {}, {}, {}
    for prec, rk in SHARD_PRECISIONS:
        name = SHARD_SCAN[prec]
        with first_calls(ops, (name,), whole_calls):
            flat = batch("flat", prec, rk)
        calls = []
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with path.counted(), recorded_calls(ops, name, range(1 << 30),
                                            calls):
            first = batch("sharded", prec, rk)
        first_s = sync_s(t0)
        launched = new_launches(before, ops.launch_counts())
        shard_calls[prec] = calls
        gate(same_results(first, flat),
             f"8a {prec}: sharded batch != flat batch (bitwise)")
        gate(launched.get(name, 0) == SHARDS and len(calls) == SHARDS,
             f"8a {prec}: {launched} launches, want {SHARDS} of {name}")
        kw = dict(k=k, precision=prec, rescore_k=rk)
        loop_s = [db.dsq(queries[i], paths[i], recursive=rec[i],
                         executor="sharded", **kw) for i in range(B)]
        loop_f = [db.dsq(queries[i], paths[i], recursive=rec[i], **kw)
                  for i in range(B)]
        gate(same_results(loop_s, loop_f),
             f"8a {prec}: loop of sharded dsq != loop of flat dsq")
        m0 = ex.mask_bytes_uploaded
        again = batch("sharded", prec, rk)
        acct = again[0].batch
        gate(same_results(again, flat), f"8b {prec}: second batch differs")
        gate(acct.shard_mask_hits == acct.plan_groups.get("scan", 0) > 0
             and acct.shard_mask_bytes == 0 and ex.mask_bytes_uploaded == m0,
             f"8b {prec}: hits {acct.shard_mask_hits} of "
             f"{acct.plan_groups} scan groups, "
             f"{acct.shard_mask_bytes} mask bytes")
        walls = {"flat": [], "sharded": []}
        for label in ("flat", "sharded", "sharded", "flat"):   # in turns
            t0 = time.perf_counter()
            batch(label, prec, rk)
            walls[label].append(sync_s(t0) * 1e3)
        names = ("scan_pass1", "scan_pass2")
        a_info[prec] = {
            "first_batch_s": first_s, "launches": launched,
            "batch_wall_ms": walls,
            "device_ms": {
                "flat": device_ms(torch, lambda: batch("flat", prec, rk), 3,
                                  names),
                "sharded": device_ms(torch,
                                     lambda: batch("sharded", prec, rk), 3,
                                     names)},
            "scan_groups": acct.plan_groups.get("scan", 0),
            "shard_mask_hits": acct.shard_mask_hits,
            "collective_bytes": acct.collective_bytes,
            "shard_db_bytes_first": first[0].batch.shard_db_bytes,
            "rescore_candidates": acct.rescore_candidates}
    info["8a"] = a_info
    emit({"phase": "8a", "card": card, **a_info})

    # the shards' launches of kernels 2, 6 and 8 against one launch of the
    # same kernel over all rows (the flat batch's)
    kernels = {}
    for prec, _ in SHARD_PRECISIONS:
        name = SHARD_SCAN[prec]
        recs = [shard_record(torch, ops, ref, name, a, kw,
                             f"8 {name} shard {s}")
                for s, (_, a, kw) in enumerate(shard_calls[prec])]
        whole = shard_record(torch, ops, ref, name, *whole_calls[name],
                             f"8 {name} all rows")
        dev = [r["device_ms"] for r in recs]
        kernels[name] = {
            "shards": recs, "all_rows": whole,
            "shard_device_ms_sum": (sum(dev) if None not in dev else None)}
    shard_calls.clear()
    whole_calls.clear()
    info["kernels"] = kernels
    emit({"phase": "8-kernels", "card": card, **kernels})

    # 8c: DSM of phase 3's kinds of templates (moves, merges and removes
    # not yet applied); surviving slots patch, the batch stays flat's
    idx = db.namespaces["fs"]
    rng = np.random.default_rng(args.seed + 8)
    templates = ([("move", s, d) for s, d in ds.moves[10:15]]
                 + [("merge", s, d) for s, d in ds.merges[10:15]])
    touched = [p for op in templates for p in op[1:]]

    def small_dirs(n):
        """``n`` seeded directories holding one entry each, off the mix's
        anchors' and the templates' chains: an rmdir of one tombstones one
        row."""
        out = []
        for j in rng.permutation(len(dirs)):
            d = dirs[j]
            if d == "/" or any(a.startswith(d) or d.startswith(a)
                               for a in touched + out) or any(
                    a.startswith(d) for a in paths):
                continue
            if len(idx.resolve(d)) == 1:
                out.append(d)
            if len(out) == n:
                break
        return out

    dirs = dir_strings(idx)
    templates += [("remove", d) for d in small_dirs(2)]
    st0 = ex.stats()
    with path.counted():
        t0 = time.perf_counter()
        res = db.dsm_batch(templates)
        dsm_s = time.perf_counter() - t0
    st1 = ex.stats()
    m0 = ex.mask_bytes_uploaded
    after = batch("sharded", "fp32", None)
    acct = after[0].batch
    misses = acct.plan_groups.get("scan", 0) - acct.shard_mask_hits
    gate(st1["masks_patched"] > st0["masks_patched"],
         f"8c: no slot patched: {st0} -> {st1}")
    gate(ex.mask_bytes_uploaded - m0 == misses * ex.view.n_words * 4,
         f"8c: a surviving slot re-uploaded ({misses} misses, "
         f"{ex.mask_bytes_uploaded - m0} bytes)")
    both_equal("8c")
    info["8c"] = {"ops": len(templates),
                  "rejected": sum(e is not None for e in res.errors),
                  "dsm_s": dsm_s, "stats_before": st0, "stats_after": st1,
                  "misses_after": misses}
    emit({"phase": "8c", **info["8c"]})

    # 8d: rmdirs, a batch after each; the alive words patch by range
    dirs = dir_strings(idx)
    touched = []
    victims = small_dirs(8)
    a0, dead0 = ex.view.alive_bytes_uploaded, store.n_deleted
    with path.counted():
        for d in victims:
            db.rmdir(d)
            batch("sharded", "fp32", None)
    grown = ex.view.alive_bytes_uploaded - a0
    gate(store.n_deleted - dead0 == len(victims) > 0
         and 0 < grown < ex.view.n_words * 4,
         f"8d: {len(victims)} rmdirs, alive words grew {grown} bytes of "
         f"{ex.view.n_words * 4}")
    both_equal("8d")
    info["8d"] = {"rmdirs": len(victims), "tombstones": store.n_deleted,
                  "alive_bytes": grown, "alive_full_bytes":
                  ex.view.n_words * 4}
    emit({"phase": "8d", **info["8d"]})

    # 8e: ingest inside the capacity, then past it
    cap0, r0 = ex.view.cap, ex.view.reshards

    def ingest(n_new):
        pick = rng.integers(0, len(ds.vectors), size=n_new)
        new = ds.vectors[pick] + rng.normal(
            size=(n_new, store.dim)).astype(np.float32) * 0.01
        with path.counted():
            t0 = time.perf_counter()
            db.ingest(new.astype(np.float32),
                      [ds.entry_paths[i] for i in pick])
            batch("sharded", "fp32", None)
            return sync_s(t0)

    small_s = ingest(SHARD_SMALL_INGEST)  # with the sharded batch after it
    gate(ex.view.reshards == r0 and ex.view.cap == cap0,
         f"8e: {SHARD_SMALL_INGEST} rows re-sharded ({r0} -> "
         f"{ex.view.reshards})")
    grow = cap0 - len(store) + SHARD_SMALL_INGEST
    big_s = ingest(grow)
    gate(ex.view.reshards == r0 + 1 and ex.view.cap == 2 * cap0,
         f"8e: past the capacity: reshards {r0} -> {ex.view.reshards}, cap "
         f"{cap0} -> {ex.view.cap}")
    both_equal("8e")
    info["8e"] = {"cap": [cap0, ex.view.cap], "n_loc": ex.view.n_loc,
                  "ingested": [SHARD_SMALL_INGEST, grow],
                  "ingest_and_batch_s": [small_s, big_s],
                  "entries": len(store),
                  "reshards": ex.view.reshards}
    emit({"phase": "8e", **info["8e"]})

    # 8f: the scheduler; the stage pre-pins, then the sharded.h2d rung
    with ex._lock:
        ex._reset_table()                   # every slot pinned anew
    direct = batch("sharded", "fp32", None)
    with ex._lock:
        ex._reset_table()
    sdsq = ScheduledDSQ(db, k=k, executor="sharded", cfg=SchedulerConfig(
        max_batch=B, max_wait_ms=1e4))
    served, got = sched_batch(sdsq, path, queries, paths, rec)
    acct = got[0].batch
    gate(served == B and same_results(got, direct),
         "8f: scheduled sharded batch != direct batch (bitwise)")
    gate(acct.shard_mask_hits == acct.plan_groups.get("scan", 0) > 0
         and acct.shard_mask_bytes == 0
         and sdsq.scheduler.stage_faults == 0,
         f"8f: execute-time pins {acct.shard_mask_hits} hits of "
         f"{acct.plan_groups}, {acct.shard_mask_bytes} bytes")
    sdsq = ScheduledDSQ(db, k=k, executor="sharded", stage=False,
                        cfg=SchedulerConfig(max_batch=B,
                                            breaker_trip_after=2,
                                            breaker_reset_after=2))
    plan = faults.FaultPlan().add("sharded.h2d", kind="error", count=2)
    tripped = []
    with faults.FaultInjector(plan):
        for _ in range(2):
            t = sdsq.submit(queries[0], "/")
            with path.counted():
                sdsq.pump()
            try:
                t.result(WAIT_S)
            except faults.FaultError:
                tripped.append(True)
    down = (sdsq.health, sdsq.executor, sdsq.precision)
    gate(len(tripped) == 2 and down == ("degraded", "flat", "int8"),
         f"8f: breaker: {len(tripped)} failed batches, {down}")
    want = db.dsq_batch(queries, paths, k=k, recursive=rec,
                        precision="int8", rescore_k=sdsq.rescore_k)
    for _ in range(2):              # two successes close the breaker
        _, got = sched_batch(sdsq, path, queries, paths, rec)
        gate(same_results(got, want),
             "8f: degraded batch != direct flat int8 batch (bitwise)")
    up = (sdsq.health, sdsq.executor, sdsq.precision)
    _, got = sched_batch(sdsq, path, queries, paths, rec)
    gate(up == ("healthy", "sharded", "fp32")
         and same_results(got, direct),
         f"8f: after the breaker closed: {up}")
    gate(sdsq.rescore_k is None or sdsq.rescore_k == model_of(
        store).pick_rescore_k(k, None, len(store)),
         f"8f: rescore_k {sdsq.rescore_k}")
    snap = sdsq.metrics.snapshot()
    info["8f"] = {"pump_hits": acct.shard_mask_hits, "degraded": down,
                  "restored": up, "degrades": snap["degrades"],
                  "recoveries": snap["recoveries"],
                  "failed": snap["failed"]}
    emit({"phase": "8f", **info["8f"]})

    # 8g's evidence: phase 7d's compaction goes through apply_remap
    remapped = {}
    apply_remap = ex.apply_remap

    def recorded_remap(mapping):
        remapped.update(slots=len(ex._slots), evicted=ex.masks_evicted,
                        cap=ex.view.cap, reshards=ex.view.reshards)
        t0 = time.perf_counter()
        remapped["patched"] = apply_remap(mapping)
        remapped["s"] = time.perf_counter() - t0
        remapped["evicted_after"] = ex.masks_evicted
        return remapped["patched"]

    ex.apply_remap = recorded_remap
    info["stats"] = ex.stats()
    info["launches_main_path"] = counts = dict(path.counts)
    info["launches_phase"] = ops.launch_counts()
    info["phase_s"] = time.perf_counter() - t_phase
    info["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return counts, remapped


def phase8_compacted(torch, ops, ds, db, remapped, card: str) -> dict:
    """8g, after phase 7d's compaction: the slots pinned when it began
    (7d re-pins them, after its concurrent rmdirs, with a sharded batch
    held to the flat one) were patched through the remap (none evicted,
    no re-shard), and the sharded batch equals the flat one at three
    precisions (7d holds the flat batch after the compaction to the one
    before it, ids mapped)."""
    queries, paths, rec = requests(ds)
    ops.reset_launch_counts()
    path = MainPath(ops)
    ex = db.executors["sharded"]
    failed = []
    r = dict(remapped)
    if not r:
        failed.append("8g: the compaction did not reach apply_remap")
    elif not (r["patched"] == r["slots"] > 0
              and r["evicted_after"] == r["evicted"]
              and ex.view.cap == r["cap"]
              and ex.view.reshards == r["reshards"]):
        failed.append(f"8g: slots not patched in place: {r}")
    for prec, rk in SHARD_PRECISIONS:
        kw = dict(k=10, recursive=rec, precision=prec, rescore_k=rk)
        with path.counted():
            got = db.dsq_batch(queries, paths, executor="sharded", **kw)
        if not same_results(got, db.dsq_batch(queries, paths, **kw)):
            failed.append(f"8g {prec}: sharded != flat after compaction")
    info = {"phase": "8g", "card": card, "remap": r, "stats": ex.stats(),
            "launches_main_path": dict(path.counts), "failed": failed}
    emit(info)
    check(not failed, "; ".join(failed))
    return dict(path.counts)


# --------------------------------------------------------------- phase 9
def phase9(torch, ops, ds, db, tmp: str, card: str) -> dict:
    """Calibration on the card: ``calibrate(smoke=True, device="cuda")``
    into a temporary file, its schema and backend, the measured model's
    clamps on a fresh CUDA database, then phase 5's database under the
    measured model and its installed kernel blocks: the mix's batch equals
    a loop of ``dsq`` and the batch under the heuristic model."""
    from repro_torch.analysis.calibrate import calibrate
    from repro_torch.vectordb import (CalibrationArtifact, DirectoryVectorDB,
                                      model_of, resolve_calibration)
    from repro_torch.vectordb.costmodel import (NPROBE_FLOOR,
                                                THRESHOLD_BOUNDS,
                                                install_kernel_tuning)
    from repro_torch.vectordb.quant import DEFAULT_RESCORE_FACTOR
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    t0 = time.perf_counter()
    art = calibrate(smoke=True, device=db.device)
    cal_s = time.perf_counter() - t0
    out = str(Path(tmp) / "cuda.json")
    art.save(out)
    data = CalibrationArtifact.load(out).data
    want = json.loads((ROOT / "calibration" / "cpu.json").read_text())
    gate(sorted(data) == sorted(want)
         and sorted(data["terms"]) == sorted(want["terms"]),
         f"9: artifact keys {sorted(data)} / {sorted(data['terms'])}")
    gate(data["backend"] == db.device.type == "cuda"
         and data["device_kind"] == torch.cuda.get_device_name(0),
         f"9: backend {data['backend']} on {data['device_kind']}")
    fresh = DirectoryVectorDB(dim=data["dim"], calibration=out,
                              device=db.device)
    model = model_of(fresh.store)
    lo, hi = THRESHOLD_BOUNDS
    clamps = {"source": model.source,
              "gather_threshold": model.gather_threshold(len(db.store), 10),
              "rescore_k": model.pick_rescore_k(10, None, len(db.store)),
              "nprobe": model.default_nprobe(IVF_LISTS)}
    gate(model.source == "measured", f"9: source {model.source}")
    gate(lo <= clamps["gather_threshold"] <= hi
         and clamps["rescore_k"] >= DEFAULT_RESCORE_FACTOR * 10
         and clamps["nprobe"] >= NPROBE_FLOOR, f"9: clamps {clamps}")
    del fresh
    queries, paths, rec = requests(ds)
    ops.reset_launch_counts()
    path = MainPath(ops)
    store = db.store
    before = db.dsq_batch(queries, paths, k=10, recursive=rec)
    heuristic = store.cost_model
    store.cost_model = resolve_calibration(out, db.device)
    install_kernel_tuning(store.cost_model)
    db._planners.clear()                    # planners read the new model
    try:
        with path.counted():
            got = db.dsq_batch(queries, paths, k=10, recursive=rec)
        loop = [db.dsq(queries[i], paths[i], k=10, recursive=rec[i])
                for i in range(len(paths))]
        blocks = ops.get_block_overrides()
        gate(blocks == model.kernel_blocks() and len(blocks) == 6,
             f"9: installed blocks {blocks}")
        gate(same_results(got, loop),
             "9: calibrated dsq_batch != loop of dsq (bitwise)")
        gate(same_results(got, before),
             "9: calibrated batch != heuristic batch (bitwise)")
        plans = got[0].batch.plan_groups
    finally:
        store.cost_model = heuristic
        ops.set_block_overrides({})
        db._planners.clear()
    info = {"phase": 9, "card": card, "calibrate_s": cal_s,
            "terms": data["terms"], "clamps": clamps,
            "plans_measured": plans,
            "plans_heuristic": before[0].batch.plan_groups,
            "launches_main_path": dict(path.counts), "failed": failed}
    emit(info)
    check(not failed, "; ".join(failed))
    return dict(path.counts)


# --------------------------------------------------------------- phase 7
SCHED_BATCH = 64           # SchedulerConfig(max_batch=64): the mix's size
SCHED_QPS = 2000.0         # 7c's open-loop arrival rate
SCHED_REQUESTS = 256       # the 64-request mix four times over
SCHED_THREADS = 4
SCHED_WAIT_MS = 2.0
WAIT_S = 300.0             # every ticket's result() waits at most this
# the reference policy's knob, lowered from 0.25 only so that compaction
# comes due at 7d's churn of at least 1% of the rows
MAINT_TOMBSTONE_FRACTION = 0.01
# 7e: WIKI-Dir cut to a hundredth (19,400 entries): the PG build is a host
# loop of one beam per node in both packages (~35 s for these 19,400 rows
# on the H100 machine's host, printed as build_s, and more than linear in
# the rows), so the full scale would take hours
PG_SCALE = 0.01
PG_PARAMS = {"max_degree": 16, "ef_construction": 64}  # bench_maintenance
PG_IVF_LISTS = 16
PG_EF = (64, 128)
PG_DELETES = 64


def planned_precision(db, res, precision: str, k: int, rescore_k) -> str:
    """The precision ``dsq_batch`` ran a request's scope group at: the
    planner serves a gather-plan scope that fits the rescore window at
    exact fp32 (``BatchPlanner.plan``, as in the reference), so a loop
    request is held against the batch at that precision."""
    from repro_torch.vectordb.quant import resolve_rescore_k
    if precision == "fp32":
        return "fp32"
    plan = db.planner().choose_plan(res.scope_size, len(db.store), k)
    window = resolve_rescore_k(k, rescore_k, res.scope_size)
    return precision if plan == "scan" or res.scope_size > window \
        else "fp32"


def record_remap(mgr, into: dict) -> None:
    """Wrap ``mgr``'s compaction and remap: ``into`` gets the mapping and
    the seconds of ``store.compact`` and of ``_propagate_remap``."""
    store = mgr.db.store
    compact, propagate = store.compact, mgr._propagate_remap

    def timed_compact():
        t0 = time.perf_counter()
        out = compact()
        into["compact_s"] = time.perf_counter() - t0
        return out

    def timed_propagate(mapping):
        into["mapping"] = np.array(mapping)
        t0 = time.perf_counter()
        out = propagate(mapping)
        into["remap_s"] = time.perf_counter() - t0
        return out

    store.compact, mgr._propagate_remap = timed_compact, timed_propagate


def clone_pg(pg, store):
    """A twin of a built ``PGIndex`` over another store holding the same
    rows: its arrays and RNG state copied (a second build of the same rows
    gives the same graph, at a minute of host time)."""
    import copy
    twin = copy.copy(pg)
    twin.store = store
    for name in ("neighbors", "_n_edges", "_visit_gen"):
        setattr(twin, name, getattr(pg, name).copy())
    twin._pending_relink = list(pg._pending_relink)
    twin._rng = copy.deepcopy(pg._rng)
    return twin


def sched_batch(sdsq, path, queries, paths, rec):
    """Submit the requests to ``sdsq`` and ``pump()`` once inside the
    main-path window; returns (served count, the tickets' results)."""
    tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
               for i in range(len(paths))]
    with path.counted():
        served = sdsq.pump()
    return served, [t.result(WAIT_S) for t in tickets]


def new_launches(before: dict, after: dict) -> dict:
    return {key: after[key] - before[key] for key in after
            if after[key] > before[key]}


def dir_strings(idx):
    from repro_torch.core import paths as P
    return [P.to_str(d) for d in idx.list_dirs()]


def phase7(torch, ops, ref, ds, db, tmp: str):
    """The serving tier and online maintenance (module docstring, phase 7):
    7a-7d on phase 5's database, 7e on a PG database of its own. Every
    failed check is collected and reported at once. Returns the main
    path's launch counts (the scheduled batches, the racing DSM, the
    threaded run, the rmdirs, the maintenance ops and 7e's entry points;
    not the direct batches and loops they are held against)."""
    import dataclasses
    import threading

    from repro_torch.serving import (ScheduledDSQ, SchedulerConfig,
                                     open_loop_arrivals)
    from repro_torch.vectordb import MaintenancePolicy
    t_phase = time.perf_counter()
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    queries, paths, rec = requests(ds)
    k, B = 10, len(paths)
    store = db.store
    store.set_device_budget(None)          # phase 5 left a byte budget
    store.device_vectors()
    ops.reset_launch_counts()
    path = MainPath(ops)
    info = {"phase": 7, "entries": len(store)}

    # 7a: pump mode, bitwise equal to a direct batch of the same requests
    scheds = {}
    for label, kw in (("flat_fp32", {}), ("flat_int8", {"precision": "int8"}),
                      ("flat_pq", {"precision": "pq",
                                   "rescore_k": PQ_RESCORE_K}),
                      ("ivf_fp32", {"executor": "ivf",
                                    "nprobe": IVF_NPROBE})):
        direct = db.dsq_batch(queries, paths, k=k, recursive=rec, **kw)
        sdsq = ScheduledDSQ(db, k=k, cfg=SchedulerConfig(
            max_batch=SCHED_BATCH, max_wait_ms=1e4), **kw)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        served, got = sched_batch(sdsq, path, queries, paths, rec)
        dt = time.perf_counter() - t0
        gate(served == B and same_results(got, direct),
             f"7a {label}: scheduled batch != direct dsq_batch (bitwise)")
        gate(sdsq.scheduler.stage_faults == 0 and sdsq._stream is not None,
             f"7a {label}: staging failed or did not reach the card")
        scheds[label] = {"wall_ms": dt * 1e3, "launches": new_launches(
            before, ops.launch_counts())}
    info["7a"] = scheds
    emit({"phase": "7a", **scheds})

    # 7b: a DSM lands between stage and execute (tests/test_serving.py's
    # racing-DSM case): the move vacates a scan group's chain, whose staged
    # device words the delta patches with kernel 3
    plans = [r.plan for r in db.dsq_batch(queries, paths, k=k,
                                          recursive=rec)]
    idx = db.namespaces["fs"]
    dirs = dir_strings(idx)
    target = None
    for anchor, r, p in sorted(zip(paths, rec, plans),
                               key=lambda t: t[2] != "scan"):
        if not r or anchor == "/":
            continue
        sub = next((d for d in dirs if d.startswith(anchor)
                    and d != anchor), None)
        if sub is not None:
            target = (sub, "/")
            break
    gate(target is not None, "7b: no anchor with a subdirectory to move")
    sdsq = ScheduledDSQ(db, k=k, cfg=SchedulerConfig(max_batch=SCHED_BATCH,
                                                     max_wait_ms=1e4))
    sched = sdsq.scheduler
    tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
               for i in range(B)]
    with sched._cond:
        batch = sched._form_batch()
    before = ops.launch_counts()
    with path.counted():
        staged, stage_s = sched._do_stage(batch)
        if target is not None:
            db.dsm_batch([("move",) + target])
        sched._run_batch(batch, staged, stage_s, "racing-dsm")
    launched = new_launches(before, ops.launch_counts())
    got = [t.result(WAIT_S) for t in tickets]
    fresh = db.dsq_batch(queries, paths, k=k, recursive=rec)
    gate(same_results(got, fresh),
         "7b: batch staged before a DSM != a fresh batch after it")
    gate(type(staged).__name__ == "StagedQueries"
         and torch.equal(staged.host, torch.from_numpy(queries))
         and sched.stage_faults == 0,
         "7b: the staged query matrix is not the batch's")
    gate(launched.get("bitmap_patch", 0) > 0,
         "7b: the racing DSM patched no staged device mask")
    info["7b"] = {"move": target, "launches": launched}
    emit({"phase": "7b", **info["7b"]})

    # 7c: threaded, open loop, maintenance attached
    direct = [db.dsq(queries[i], paths[i], k=k, recursive=rec[i])
              for i in range(B)]
    arrivals = open_loop_arrivals(qps=SCHED_QPS, n=SCHED_REQUESTS, seed=0)
    sdsq = ScheduledDSQ(db, k=k, maintenance=True, cfg=SchedulerConfig(
        max_batch=SCHED_BATCH, max_wait_ms=SCHED_WAIT_MS))
    tickets = [None] * SCHED_REQUESTS
    clock = sdsq.scheduler.clock

    def client(j, t0):
        for i in range(j, SCHED_REQUESTS, SCHED_THREADS):
            due = t0 + arrivals[i]
            while clock() < due:
                time.sleep(max(0.0, min(due - clock(), 1e-3)))
            r = i % B
            tickets[i] = sdsq.submit(queries[r], paths[r], recursive=rec[r],
                                     t_arrival=due)

    with path.counted():
        sdsq.start()
        try:
            t0 = clock()
            threads = [threading.Thread(target=client, args=(j, t0))
                       for j in range(SCHED_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            results = [t.result(WAIT_S) for t in tickets]
            wall = clock() - t0
        finally:
            sdsq.stop()
    gate(all(same_results([res], [direct[i % B]])
             for i, res in enumerate(results)),
         "7c: a threaded ticket != its direct dsq (bitwise)")
    snap = sdsq.metrics.snapshot()
    acct = snap["accounting"]
    stage_ns, service_ns = acct["sched_stage_ns"], acct["sched_service_ns"]
    c = {"requests": SCHED_REQUESTS, "qps_offered": SCHED_QPS,
         "threads": SCHED_THREADS, "max_wait_ms": SCHED_WAIT_MS,
         "wall_s": wall, "qps": SCHED_REQUESTS / wall,
         "completed": snap["completed"], "failed": snap["failed"],
         "batches": snap["batches"], "mean_batch": snap["mean_batch"],
         "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
         "queue_p99_ms": snap["queue_p99_ms"],
         "stage_share": stage_ns / max(stage_ns + service_ns, 1),
         "stage_faults": sdsq.scheduler.stage_faults,
         "maintenance_steps": sdsq.scheduler.maintenance_steps,
         "maintenance_error": repr(sdsq.scheduler.maintenance_error),
         "health": sdsq.health}
    gate(c["completed"] == SCHED_REQUESTS and c["failed"] == 0
         and c["stage_faults"] == 0 and c["health"] == "healthy"
         and sdsq.scheduler.maintenance_error is None,
         f"7c: threaded serving unhealthy: {c}")
    info["7c"] = c
    emit({"phase": "7c", **c})

    # 7d: online maintenance at full scale: rmdir seeded subtrees (none
    # holding an anchor of the mix) until at least 1% of the rows are
    # tombstoned, then every due op
    rng = np.random.default_rng(7)
    dirs = [d for d in dir_strings(idx) if d != "/"]
    chosen, dead = [], 0
    want = int(np.ceil(0.01 * len(store)))
    for j in rng.permutation(len(dirs)):
        d = dirs[j]
        if any(a.startswith(d) for a in paths) or any(
                d.startswith(c) or c.startswith(d) for c in chosen):
            continue
        chosen.append(d)
        dead += len(idx.resolve(d))
        if dead >= want:
            break
    n_before = len(store)
    with path.counted():
        t0 = time.perf_counter()
        res = db.dsm_batch([("remove", d) for d in chosen])
        rmdir_s = time.perf_counter() - t0
    tomb = store.n_deleted
    gate(not any(res.errors) and tomb >= want,
         f"7d: {tomb} tombstones from {len(chosen)} rmdirs, want {want}")
    pre = db.dsq_batch(queries, paths, k=k, recursive=rec)
    if "sharded" in db.executors:
        # re-pin phase 8's slots: the concurrent rmdirs above may have
        # evicted them (delta events arrive out of epoch order), and 8g
        # checks that the compaction patches the pinned ones in place
        gate(same_results(db.dsq_batch(queries, paths, k=k, recursive=rec,
                                       executor="sharded"), pre),
             "7d: sharded batch before the compaction != flat (bitwise)")
    old_vectors = store.vectors.copy()
    alive = ~store.deleted_mask()
    cache = db.planner().cache
    patched0 = cache.stats()["patched"]
    n_cached = len(cache._entries)
    policy = MaintenancePolicy(tombstone_fraction=MAINT_TOMBSTONE_FRACTION)
    mgr = db.maintenance(policy=policy)
    remap = {}
    record_remap(mgr, remap)
    with path.counted():
        t0 = time.perf_counter()
        ran = mgr.run_all()
        maint_s = time.perf_counter() - t0
    kinds = [r["kind"] for r in ran]
    new_n = len(store)
    gate("maint_compact" in kinds and new_n == n_before - tomb
         and store.n_deleted == 0,
         f"7d: compaction {kinds}: {n_before} -> {new_n} rows, {tomb} dead")
    mapping = remap.get("mapping")
    gate(mapping is not None
         and np.array_equal(store.vectors, old_vectors[alive])
         and np.array_equal(mapping[alive], np.arange(new_n)),
         "7d: surviving rows moved or changed")
    del old_vectors
    entries = list(cache._entries.values())
    gate(len(entries) == n_cached
         and cache.stats()["patched"] - patched0 == n_cached
         and all(e._words is None and e.n == new_n for e in entries),
         "7d: cached scopes were not rebuilt for the compacted store")
    gate(all(e.words.shape[0] == (new_n + 31) // 32 for e in entries),
         "7d: rebuilt device words of the wrong length")
    post = db.dsq_batch(queries, paths, k=k, recursive=rec)
    if mapping is not None:
        gate(all(np.array_equal(a.ids, np.where(
            b.ids >= 0, mapping[np.maximum(b.ids, 0)], -1))
            and np.array_equal(a.scores, b.scores)
            for a, b in zip(post, pre)),
            "7d: batch after compaction != batch before it, ids mapped")
    ivf_kw = dict(k=k, executor="ivf", nprobe=IVF_NPROBE)
    gate(same_results(
        db.dsq_batch(queries, paths, recursive=rec, **ivf_kw),
        [db.dsq(queries[i], paths[i], recursive=rec[i], **ivf_kw)
         for i in range(B)]), "7d: after the remap ivf dsq_batch != loop")
    sub = slice(0, 8)
    full = db.dsq_batch(queries[sub], paths[sub], k=k, recursive=rec[sub],
                        executor="ivf", nprobe=IVF_LISTS)
    for i, (a, f) in enumerate(zip(full, post[sub])):
        err = ref.topk_disagreement(a.ids, a.scores, f.ids, f.scores, TOL)
        gate(err is None and a.scope_size == f.scope_size,
             f"7d: after the remap nprobe={IVF_LISTS} request {i} != flat: "
             f"{err}")
    info["7d"] = {"policy": dataclasses.asdict(policy),
                  "rmdirs": len(chosen), "rmdir_s": rmdir_s,
                  "tombstones": tomb, "rows": [n_before, new_n],
                  "ops": kinds, "op_us": {r["kind"]: r["us"] for r in ran},
                  "maintenance_s": maint_s,
                  "compact_s": remap.get("compact_s"),
                  "remap_s": remap.get("remap_s"),
                  "cached_scopes_rebuilt": n_cached,
                  "words": (new_n + 31) // 32}
    emit({"phase": "7d", **info["7d"]})
    info["7e"] = phase7_pg(torch, ops, ref, path, gate, tmp)
    info["launches_main_path"] = counts = dict(path.counts)
    info["launches_phase"] = ops.launch_counts()
    info["phase_s"] = time.perf_counter() - t_phase
    info["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return counts


def phase7_pg(torch, ops, ref, path, gate, tmp: str) -> dict:
    """7e: the PG executor on a WIKI-Dir database of its own (PG_SCALE),
    with flat and 16-list IVF beside it: batch == loop at three precisions,
    kernel 2 inside the int8 / PQ rescore against its plain version, recall
    against flat, the scheduler over PG, a repair after deletes, and
    crashes at the ``maint.apply`` seam recovered to an uncrashed twin."""
    from repro_torch import faults
    from repro_torch.datasets import make_wiki_dir
    from repro_torch.serving import ScheduledDSQ, SchedulerConfig
    from repro_torch.vectordb import DirectoryVectorDB
    out = {"scale": PG_SCALE, "scale_planned": 1.0, "cut": True,
           "params": PG_PARAMS, "ivf_lists": PG_IVF_LISTS}
    ds = make_wiki_dir(scale=PG_SCALE, dim=128, n_queries=64, seed=0)
    queries, paths, rec = requests(ds)
    k, B = 10, len(paths)

    def new_db(tag):
        db = DirectoryVectorDB(dim=128, scope_strategy="triehi",
                               calibration=False, device="cuda",
                               journal_path=str(Path(tmp) / f"pg.{tag}"))
        db.ingest(ds.vectors, ds.entry_paths)
        db.build_ann("flat")
        return db

    db = new_db("a")
    out["entries"] = len(db.store)
    with path.counted():
        db.build_ann("ivf", n_lists=PG_IVF_LISTS, seed=0)
        t0 = time.perf_counter()
        db.build_ann("pg", **PG_PARAMS)
        out["build_s"] = time.perf_counter() - t0
    emit({"phase": "7e-build", **out})
    twin = new_db("b")
    twin.executors["pg"] = clone_pg(db.executors["pg"], twin.store)
    fp = db.dsq_batch(queries, paths, k=k, recursive=rec)        # flat
    rescores, checked = [], {}
    for prec, rk in (("fp32", None), ("int8", None), ("pq", PQ_RESCORE_K)):
        kw = dict(k=k, executor="pg", precision=prec, rescore_k=rk,
                  ef_search=PG_EF[1])
        calls = []
        t0 = time.perf_counter()
        with path.counted(), recorded_calls(ops, "multi_scope_topk",
                                            range(1 << 30), calls):
            b = db.dsq_batch(queries, paths, recursive=rec, **kw)
        tb = time.perf_counter() - t0
        loop = [db.dsq(queries[i], paths[i], recursive=rec[i],
                       **{**kw, "precision": planned_precision(
                           db, b[i], prec, k, rk)}) for i in range(B)]
        gate(same_results(b, loop), f"7e pg {prec}: dsq_batch != loop")
        gate(prec == "fp32" or len(calls) > 0,
             f"7e pg {prec}: the rescore launched no kernel 2")
        rescores += calls
        checked[prec] = {"batch_ms": tb * 1e3, "rescore_launches": len(calls),
                         "precision_groups": b[0].batch.precision_groups,
                         "recall_at_10_vs_flat": set_recall(fp, b)}
    errs = []
    for _, args, kw in rescores:
        a = bound_args(ops, "multi_scope_topk", args, kw)
        plain = ref.multi_scope_topk_ref(
            a["queries"], a["rows"], a["mask_words"], a["scope_ids"],
            a["k"], a["metric"], a["sq"])
        errs.append(topk_case(ref, "7e kernel 2 in the PG rescore",
                              ops.multi_scope_topk(*args, **kw), plain))
    out["rescore_kernel2"] = {"calls_checked": len(errs),
                              "max_abs_err": max(errs, default=0.0)}
    out["precisions"] = checked
    out["recall_at_10_vs_flat"] = {
        str(ef): set_recall(fp, db.dsq_batch(
            queries, paths, k=k, recursive=rec, executor="pg",
            ef_search=ef)) for ef in PG_EF}
    sdsq = ScheduledDSQ(db, k=k, executor="pg", ef_search=PG_EF[1],
                        cfg=SchedulerConfig(max_batch=SCHED_BATCH,
                                            max_wait_ms=1e4))
    served, got = sched_batch(sdsq, path, queries, paths, rec)
    direct = db.dsq_batch(queries, paths, k=k, recursive=rec, executor="pg",
                          ef_search=PG_EF[1])
    gate(served == B and same_results(got, direct)
         and sdsq.scheduler.stage_faults == 0,
         "7e: scheduled pg batch != direct (bitwise)")
    # deletes, then the repair: run as is on db, crashed at maint.apply
    # and recovered on the twin; then the same for a compaction
    victims = np.random.default_rng(11).choice(len(db.store), PG_DELETES,
                                               replace=False)
    for d in (db, twin):
        for v in np.sort(victims):
            d.delete(int(v))
    pg, tpg = db.executors["pg"], twin.executors["pg"]
    dead_before = pg.audit()["dead"]
    mgr, tmgr = db.maintenance(), twin.maintenance()
    with path.counted():
        t0 = time.perf_counter()
        step = mgr.step()
        out["repair_s"] = time.perf_counter() - t0
    audit = pg.audit()
    gate(step is not None and step["kind"] == "maint_pg_repair"
         and audit["dead"] == 0 and pg.repair_gen == 1,
         f"7e: repair {step and step['kind']}: audit {audit}, "
         f"repair_gen {pg.repair_gen}")
    out["repair"] = {"dead_before": dead_before, "audit": audit,
                     "result": step and step["result"]}
    crashes = {}
    for kind in ("maint_pg_repair", "maint_compact"):
        if kind == "maint_compact":
            with path.counted():
                mgr._run(kind)
        plan = faults.FaultPlan().add("maint.apply", kind="crash")
        try:
            with faults.FaultInjector(plan):
                tmgr._run(kind)
            crashes[kind] = "no crash"
        except faults.InjectedCrash:
            crashes[kind] = [o.kind for o in twin.recover()["fs"]]
    gate(crashes == {"maint_pg_repair": ["maint_pg_repair"],
                     "maint_compact": ["maint_compact"]},
         f"7e: crash recovery replayed {crashes}")
    gate(np.array_equal(pg.neighbors, tpg.neighbors)
         and np.array_equal(pg._n_edges, tpg._n_edges)
         and pg._entry == tpg._entry and pg.repair_gen == tpg.repair_gen
         and np.array_equal(db.store.vectors, twin.store.vectors),
         "7e: the recovered twin's graph or store != the uncrashed one")
    for ex in ("flat", "pg"):
        gate(same_results(
            db.dsq_batch(queries, paths, k=k, recursive=rec, executor=ex),
            twin.dsq_batch(queries, paths, k=k, recursive=rec, executor=ex)),
             f"7e: the recovered twin's {ex} batch != the uncrashed one")
    out["crash_recovery"] = crashes
    out["rows_after_compact"] = len(db.store)
    emit({"phase": "7e", **out})
    return out


# --------------------------------------------------------------- phase 6
# WIKI-Dir at a tenth (194,000 context entries) is the deployment's scale;
# ``add_context`` one entry at a time takes 1.4-2.1 ms on the H100 host, so
# that ingest would take 270-410 s and the scale is cut to 0.02 (38,800
# entries, 55-85 s; 0.04 until phase 11 joined the script's time limit),
# fixed so that every run serves the same database
RAG_SCALE_PLANNED = 0.1
RAG_SCALE = 0.02
RAG_STEPS = 16             # max_new_tokens
RAG_PROMPT = 4
# bf16 logits of two independent paths over 28 layers (full-sequence
# prefill GEMMs against one-token decode GEMVs and kernel 10): each layer's
# activations round to bf16 (2^-8 relative) on each path, and logits up to
# ~3.3 are bf16 themselves (ulp 2^-6 at 2-4). Gated: the largest difference,
# the mean difference, and each path's top-1 token within LOGIT_TOL of the
# other path's best.
LOGIT_TOL = 0.25
LOGIT_MEAN_TOL = 0.05
_TIMING_KEYS = ("directory_us", "ann_us", "predicted_ann_us")


@contextlib.contextmanager
def recorded_calls(module, name: str, keep, into: list):
    """While open, ``module.name`` records ``(index, args, kwargs)`` of the
    calls whose running index is in ``keep`` and calls through."""
    saved = getattr(module, name)
    count = [0]

    def call(*args, **kw):
        if count[0] in keep:
            into.append((count[0], args, kw))
        count[0] += 1
        return saved(*args, **kw)

    setattr(module, name, call)
    try:
        yield into
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def finite_logits(torch, rag, into: list):
    """While open, the RAG server's ``prefill`` / ``decode_step`` append a
    device flag "every logit finite" per call to ``into`` (no sync)."""
    saved = {n: getattr(rag, n) for n in ("prefill", "decode_step")}

    def wrap(fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            into.append(torch.isfinite(logits).all())
            return logits, cache
        return call

    for n, fn in saved.items():
        setattr(rag, n, wrap(fn))
    try:
        yield into
    finally:
        for n, fn in saved.items():
            setattr(rag, n, fn)


def trace(torch, fn, kernel: str, want: int, top: int = 0) -> dict:
    """One ``fn`` call under ``torch.profiler`` (device activity only):
    wall time (synced, profiler on), summed kernel device time, kernel
    count, the share of ``kernel``, and the device's idle share of the
    wall time. None for the device numbers when the session did not see
    ``want`` launches of ``kernel`` (it lost events); ``kernel=""`` with
    ``want=None`` checks no count. ``top`` > 0 adds the ``top`` kernels by
    device time (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0.0) > 0]
    mine = [e for e in events if kernel in e.key]
    if want is not None and sum(e.count for e in mine) != want:
        return {"wall_ms": wall, "device_ms": None,
                "seen": sum(e.count for e in mine), "want": want}
    dev = sum(e.device_time_total for e in events) / 1e3
    out = {}
    if top:
        out["top_kernels"] = [
            (e.key[:90], e.device_time_total / 1e3, e.count)
            for e in sorted(events, key=lambda e: -e.device_time_total)[:top]]
    return {**out, "wall_ms": wall, "device_ms": dev,
            "kernels": sum(e.count for e in events),
            f"{kernel}_ms": sum(e.device_time_total for e in mine) / 1e3,
            "idle_share": max(0.0, 1.0 - dev / wall)}


def rag_ingest(ds, ctx, vocab: int, scale: float) -> dict:
    """All of the dataset's entries through ``add_context`` one at a time
    (tiers ``i % 3``, 64 (1 + i % 3) payload tokens from a seeded
    generator); the record names the scale cut (RAG_SCALE_PLANNED to
    ``scale``) and the per-entry time."""
    from repro_torch.serving.rag import TIERS
    rng = np.random.default_rng(0)
    n = len(ds.vectors)
    t0 = time.perf_counter()
    for i in range(n):
        ctx.add_context(ds.vectors[i], ds.entry_paths[i], TIERS[i % 3],
                        rng.integers(0, vocab, size=64 * (1 + i % 3),
                                     dtype=np.int32))
    dt = time.perf_counter() - t0
    return {"scale_planned": RAG_SCALE_PLANNED, "scale": scale,
            "cut": scale < RAG_SCALE_PLANNED, "entries": n, "ingest_s": dt,
            "per_entry_us": dt / max(n, 1) * 1e6}


def serve_rag(ops, ctx, server, rcfg, reqs, prompt, tokens, path,
              gate) -> dict:
    """7f: the batch of phase 6's second answer served through the
    continuous-batching front ends. ``RAGServer.start`` with
    ``max_batch`` = the batch's size flushes the submitted requests as one
    batch, whose tokens and retrieval stats must equal ``answer``'s
    (``tokens``) with the same kernel-10 launches; then
    ``ContextDatabase.submit_retrieve`` must equal ``retrieve_batch``."""
    from repro_torch.serving import SchedulerConfig
    queries, paths, rec = reqs
    B = len(paths)
    steps = tokens.shape[1]
    direct = ctx.retrieve_batch(queries, paths, rcfg, recursive=rec)

    def strip(stats):
        return {key: v for key, v in stats.items()
                if key not in _TIMING_KEYS and not key.startswith("sched_")}

    before = ops.launch_counts()
    with path.counted():
        server.start(SchedulerConfig(max_batch=B, max_wait_ms=1e4),
                     max_new_tokens=steps)
        try:
            t0 = time.perf_counter()
            tickets = [server.submit(queries[i], paths[i], prompt=prompt,
                                     recursive=rec[i]) for i in range(B)]
            served = [t.result(WAIT_S) for t in tickets]
            wall = time.perf_counter() - t0
            snap = server.serving_stats()
        finally:
            server.stop()
    launched = new_launches(before, ops.launch_counts())
    per_batch = server.lm_cfg.n_layers * steps
    gate(all(t.batch_size == B for t in tickets),
         f"7f: served in batches of {sorted({t.batch_size for t in tickets})}")
    gate(np.array_equal(np.stack([r["tokens"] for r in served]), tokens),
         "7f: served tokens != answer's tokens for the same batch")
    gate([strip(r["retrieval_stats"]) for r in served]
         == [strip(st) for _, st in direct]
         and all([h.entry_id for h in r["hits"]]
                 == [h.entry_id for h in d] for r, (d, _) in zip(served,
                                                                  direct)),
         "7f: served retrieval != retrieve_batch")
    gate(launched.get("flash_decode", 0) == per_batch,
         f"7f: flash_decode launched {launched.get('flash_decode', 0)}, "
         f"want {per_batch}")
    with path.counted():
        ctx.start_serving(rcfg, SchedulerConfig(max_batch=B,
                                                max_wait_ms=1e4))
        try:
            rt = [ctx.submit_retrieve(queries[i], paths[i], recursive=rec[i])
                  for i in range(B)]
            got = [t.result(WAIT_S) for t in rt]
            rsnap = ctx.serving_stats()
        finally:
            ctx.stop_serving()
    gate(all([h.entry_id for h in g] == [h.entry_id for h in d]
             and strip(gs) == strip(ds) and "sched_occupancy" in gs
             for (g, gs), (d, ds) in zip(got, direct)),
         "7f: submit_retrieve != retrieve_batch")
    gate(snap["completed"] == B and snap["failed"] == 0
         and rsnap["completed"] == B and rsnap["failed"] == 0,
         "7f: a served request failed")
    return {"answer_wall_s": wall, "tokens_per_s": B * steps / wall,
            "batches": snap["batches"], "mean_batch": snap["mean_batch"],
            "launches": launched, "retrieve_batches": rsnap["batches"],
            "retrieve_p50_ms": rsnap["p50_ms"]}


def rag_database(args, vocab: int, device="cuda") -> dict:
    """The RAG deployment's ``ContextDatabase`` (WIKI-Dir at RAG_SCALE,
    every entry through ``add_context``, payload tokens below ``vocab``),
    built once and served by phases 6 and 11: ``{"ds", "ctx", "gen_s",
    "ingest"}``."""
    from repro_torch.datasets import make_wiki_dir
    from repro_torch.serving import ContextDatabase
    t0 = time.perf_counter()
    scale = RAG_SCALE * args.scale
    ds = make_wiki_dir(scale=scale, dim=128, n_queries=64, seed=0)
    gen_s = time.perf_counter() - t0
    ctx = ContextDatabase(dim=128, device=device)
    ingest = rag_ingest(ds, ctx, vocab, scale)
    emit({"phase": "6-ingest", "vocab": vocab, **ingest})
    ctx.build("flat")
    return {"ds": ds, "ctx": ctx, "gen_s": gen_s, "ingest": ingest}


def phase6(torch, ops, args, cfg=None, device="cuda", rag_db=None):
    """The RAG decode path on the card (module docstring, phase 6) with the
    LM ``cfg`` (full-width ``qwen3-0.6b`` when None), on ``rag_db``
    (:func:`rag_database`; built here when None, payload tokens below
    ``cfg``'s vocabulary). Every failed check is collected and reported at
    once. Returns the launch counts of the two answers and the recorded
    kernel-10 calls. ``cfg`` and ``device`` exist for the CPU rehearsal (a
    smoke config, ``device="cpu"``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import (Transformer, decode_step, forward,
                                    init_params, logits_from_hidden,
                                    model_schema, prefill)
    from repro_torch.serving import RAGConfig, RAGServer
    from repro_torch.serving import rag
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    def sync_s(t0: float) -> float:
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cfg = cfg or get_arch("qwen3-0.6b")
    info = {"phase": 6, "model": cfg.name, "dtype": cfg.dtype,
            "params": cfg.param_count()}
    rag_db = rag_db or rag_database(args, cfg.vocab_size, device)
    ds, ctx = rag_db["ds"], rag_db["ctx"]
    info["gen_s"], info["ingest"] = rag_db["gen_s"], rag_db["ingest"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, init_params(model_schema(cfg), gen,
                                         cfg.param_dtype(), device),
                        device=device)
    info["lm_init_s"] = sync_s(t0)
    info["lm_params_held"] = sum(p.numel() for p in model.parameters())
    # what the model and its decode cache allocate, for phase 12's specs
    sizes = {"param_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters())}
    rcfg = RAGConfig(k=10, token_budget=512)
    server = RAGServer(ctx, model, cfg, rcfg)
    queries, paths, rec = requests(ds)
    B = len(paths)
    prompt = [np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=RAG_PROMPT).astype(np.int32)]
    per_answer = cfg.n_layers * RAG_STEPS
    keep = set(range(cfg.n_layers)) | set(range(per_answer - cfg.n_layers,
                                                 per_answer))
    captured, flags, answers = [], [], []
    path = MainPath(ops)           # the checks' ``direct`` stays outside

    def one_answer(label, record):
        direct = ctx.retrieve_batch(queries, paths, rcfg, recursive=rec)
        before = ops.launch_counts()
        with contextlib.ExitStack() as stack:
            stack.enter_context(finite_logits(torch, rag, flags))
            if record:
                stack.enter_context(recorded_calls(
                    ops, "flash_decode", keep, captured))
            stack.enter_context(path.counted())
            t = time.perf_counter()
            out = server.answer(queries, paths, prompt,
                                max_new_tokens=RAG_STEPS, recursive=rec)
            wall = sync_s(t)
        after = ops.launch_counts()
        n_fd = after["flash_decode"] - before["flash_decode"]
        toks = out["tokens"]
        gate(toks.shape == (B, RAG_STEPS) and toks.dtype == np.int32
             and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
             f"{label}: tokens {toks.shape} {toks.dtype}")
        gate(n_fd == per_answer,
             f"{label}: flash_decode launched {n_fd}, want {per_answer}")
        strip = [{key: v for key, v in st.items() if key not in _TIMING_KEYS}
                 for st in out["retrieval_stats"]]
        want = [{key: v for key, v in st.items() if key not in _TIMING_KEYS}
                for _, st in direct]
        gate(strip == want, f"{label}: retrieval_stats != retrieve_batch")
        answers.append(toks)
        return {"wall_s": wall, "retrieve_s": out["retrieve_s"],
                "decode_s": out["decode_s"],
                "tokens_per_s": B * RAG_STEPS / wall,
                "flash_decode_launches": n_fd,
                "scope_sizes": [st["scope_size"] for st in strip],
                "plans": sorted({st["plan"] for st in strip})}

    ops.reset_launch_counts()
    info["answer_1"] = one_answer("answer 1", record=True)
    merged = None
    for src, dst in ds.merges:
        try:
            with path.counted():
                ctx.reorganize("merge", src, dst)
        except (KeyError, ValueError):
            continue
        merged = (src, dst)
        break
    gate(merged is not None, "no DSM merge of the dataset applied")
    ctx.db.check_invariants()
    info["merge"] = merged
    info["answer_2"] = one_answer("answer 2", record=False)
    info["served"] = serve_rag(ops, ctx, server, rcfg, (queries, paths, rec),
                               prompt[0], answers[-1], path, gate)
    counts = dict(path.counts)
    gate(all(bool(f) for f in flags) and len(flags) == 2 * (1 + RAG_STEPS),
         f"non-finite logits in {sum(not bool(f) for f in flags)} of "
         f"{len(flags)} calls")
    info["launches_main_path"] = counts
    info["launches_phase"] = ops.launch_counts()
    gate(len(captured) == len(keep),
         f"recorded {len(captured)} kernel-10 calls, want {len(keep)}")

    # the answer's contexts, padded as _decode_batch pads them
    contexts = [server.assemble_with_prompt(h, prompt[0]) for h, _ in
                ctx.retrieve_batch(queries, paths, rcfg, recursive=rec)]
    S = max(len(c) for c in contexts)
    toks = np.zeros((B, S), np.int32)
    for i, c in enumerate(contexts):
        toks[i, :len(c)] = c
    tk = torch.from_numpy(toks).to(device)
    cache_seq = S + RAG_STEPS
    info["context_lengths"] = [min(len(c) for c in contexts), S]
    # timings: prefill, then RAG_STEPS greedy steps, each ended by a sync
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        logits, cache = prefill(model, {"tokens": tk}, cfg, cache_seq)
        t_pre = sync_s(t0)
        sizes.update(cache_batch=B, cache_seq=cache_seq, cache_bytes=sum(
            t.numel() * t.element_size() for t in cache.values()))
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        t0 = time.perf_counter()
        for _ in range(RAG_STEPS):
            logits, cache = decode_step(model, cache, cur, cfg)
            cur = torch.argmax(logits[:, -1], -1)[:, None]
        t_dec = sync_s(t0)
        info[f"timing_{label}"] = {
            "prefill_s": t_pre, "decode_step_ms": t_dec / RAG_STEPS * 1e3,
            "decode_tokens_per_s": B * RAG_STEPS / t_dec,
            "tokens_per_s": B * RAG_STEPS / (t_pre + t_dec)}
        del logits, cache
    # one profiled prefill, then the last of RAG_STEPS steps profiled (the
    # cache holds exactly RAG_STEPS new tokens)
    box = {}

    def run_prefill():
        box["logits"], box["cache"] = prefill(model, {"tokens": tk}, cfg,
                                              cache_seq)

    def run_step():
        cur = torch.argmax(box["logits"][:, -1], -1)[:, None]
        box["logits"], box["cache"] = decode_step(model, box["cache"], cur,
                                                  cfg)

    info["trace_prefill"] = trace(torch, run_prefill, "flash_decode_kernel",
                                  0)
    for _ in range(RAG_STEPS - 1):
        run_step()
    info["trace_decode_step"] = trace(torch, run_step, "flash_decode_kernel",
                                      cfg.n_layers)
    box.clear()
    # kernel path (prefill ctx[:-1], decode ctx[-1]) against the forward
    _, cache = prefill(model, {"tokens": tk[:, :-1]}, cfg, S)
    dec, cache = decode_step(model, cache, tk[:, -1:], cfg)
    del cache
    h, _ = forward(model, tk, cfg)
    full = logits_from_hidden(model, h[:, -1:], cfg)[:, 0]
    info["decode_vs_forward"] = dv = logit_gap(torch, dec[:, 0], full)
    gate(logits_ok(dv), f"decode vs forward logits: {dv}")
    info["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    info["sizes"] = sizes
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return counts, captured, sizes


def phase6_kernels(torch, ops, ref, peaks, captured, measured) -> None:
    """Kernel 10 on the arguments every layer's call had at decode steps 1
    and 16 of phase 6's first answer, held against its plain version; the
    last layer's step-16 call is timed, and its record takes the place of
    phase 1's synthetic main shape (kept beside it as "synthetic")."""
    check(len(captured) > 0, "phase 6 recorded no kernel-10 call")
    errs = []
    for idx, args, kw in captured:
        errs.append(flash_case(torch, ops, ref, f"flash_decode call {idx}",
                               *args, **kw))
    _, args, _ = captured[-1]
    real = flash_record(torch, ops, ref, peaks, *args)
    real["max_abs_err"], real["err_at_value"] = max(errs)
    real["calls_checked"] = len(errs)
    measured["flash_decode"] = {**real, "synthetic": measured["flash_decode"]}
    emit({"phase": "6-kernels", "flash_decode": real})


# ---------------------------------------------------------------- phase 11
FAMILY_VOCAB = 32_001      # hymba-1.5b's vocabulary, the smallest served:
                           # the shared context database's tokens fit all
FAMILY_STEPS = RAG_STEPS
# decode vs the full forward (bf16) where phase 6's fixed tolerances do
# not hold (deeper or wider than qwen3-0.6b, or an SSM's recurrence): the
# decode's distance from the fp32 forward of the same parameters within
# twice the bf16 forward's own (each bf16 path rounds on its own)
ANCHOR_RATIO = 2.0
MOE_CHECK_TOKENS = 2_048
MOE_CHECK_REL = 2e-2       # bf16 grouped vs dense: each rounds the expert
                           # products to bf16 on its own (2^-8 relative)
LLAMA4_LAYERS = 4          # one global + three chunked layers: ~11B
                           # parameters (~22 GB); the 48 layers' 107.8B
                           # (215 GB in bf16) do not fit one card
HYMBA_DIRECT = (4, 2_048)  # b, prompt tokens: past the 1,024 window
PHI_DIRECT = (4, 64)       # b, prompt tokens after the 144 patches
WHISPER_DIRECT = (16, 64)  # b, prompt tokens; 1,500 frames each
TRAIN11_STEPS = 20


@contextlib.contextmanager
def moe_probe(moe_mod, drops: list, first: dict):
    """While open, every MoE call appends (hits, dropped hits) as device
    scalars to ``drops`` (no sync), and the first call's normed input is
    kept in ``first["x"]``."""
    plan, apply = moe_mod.capacity_plan, moe_mod.moe_apply

    def counted(idx, n_experts, capacity):
        out = plan(idx, n_experts, capacity)
        drops.append((idx.numel(), (~out[3]).sum()))
        return out

    def kept(p, x, cfg):
        first.setdefault("x", x)
        return apply(p, x, cfg)

    moe_mod.capacity_plan, moe_mod.moe_apply = counted, kept
    try:
        yield drops
    finally:
        moe_mod.capacity_plan, moe_mod.moe_apply = plan, apply


def attention_launches(cfg) -> int:
    """Kernel-10 launches of one decode step: one per attention layer,
    two (self and cross) with an encoder."""
    if cfg.attn_free:
        return 0
    return cfg.n_layers * (2 if cfg.is_encdec else 1)


def logit_gap(torch, dec, full) -> dict:
    """Phase 6's bf16 comparison of two logit rows (decode vs forward):
    the largest and mean differences and the tie-aware top-1 gap."""
    diff = (dec - full).abs()
    a_dec, a_full = dec.argmax(-1), full.argmax(-1)
    gap_full = full.max(-1).values - full.gather(1, a_dec[:, None])[:, 0]
    gap_dec = dec.max(-1).values - dec.gather(1, a_full[:, None])[:, 0]
    return {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
            "max_abs_logit": float(full.abs().max()),
            "top1_equal": float((a_dec == a_full).float().mean()),
            "top1_cross_gap": float(torch.maximum(gap_full, gap_dec).max()),
            "tol": LOGIT_TOL, "mean_tol": LOGIT_MEAN_TOL}


def fp32_logits(torch, cfg, tree, tokens, extra):
    """The last position's logits of the full forward in fp32, the bf16
    parameters ``tree`` widened exactly: the function both bf16 paths
    round."""
    from repro_torch.models import Transformer, forward, logits_from_hidden
    cfg32 = cfg.replace(dtype="float32")
    model = Transformer(cfg32, tree, device=tokens.device)
    h, _ = forward(model, tokens, cfg32,
                   {k: v.float() for k, v in extra.items()})
    out = logits_from_hidden(model, h[:, -1:], cfg32)[:, 0]
    del model, h
    return out


def anchored(torch, dec, full, ref) -> dict:
    """The bf16 decode's and the bf16 forward's distances from the fp32
    forward ``ref`` (largest and mean), and how far the fp32 logit of the
    decode's top-1 lies below the fp32 best."""
    e_dec, e_fwd = (dec - ref).abs(), (full - ref).abs()
    top = ref.gather(1, dec.argmax(-1)[:, None])[:, 0]
    return {"dec_max": float(e_dec.max()), "dec_mean": float(e_dec.mean()),
            "fwd_max": float(e_fwd.max()), "fwd_mean": float(e_fwd.mean()),
            "dec_top1_gap": float((ref.max(-1).values - top).max()),
            "ratio": ANCHOR_RATIO}


def logits_ok(dv: dict) -> bool:
    """Phase 6's bf16 gate on :func:`logit_gap`'s record."""
    return (dv["max_abs"] <= LOGIT_TOL and dv["mean_abs"] <= LOGIT_MEAN_TOL
            and dv["top1_cross_gap"] <= LOGIT_TOL)


def decode_ok(dv: dict, an: dict) -> bool:
    """Phase 6's bf16 gate, or the decode no farther from the fp32 forward
    than ANCHOR_RATIO times the bf16 forward is (largest, mean, and the
    top-1's fp32 gap against the forward's largest error)."""
    if logits_ok(dv):
        return True
    r = ANCHOR_RATIO
    return (an["dec_max"] <= r * an["fwd_max"]
            and an["dec_mean"] <= r * an["fwd_mean"]
            and an["dec_top1_gap"] <= r * an["fwd_max"])


def direct_decode(torch, ops, model, cfg, tokens, extra, steps, path,
                  gate, label, keep=(), captured=None, tree=None):
    """Prefill ``tokens`` (with ``extra``), then ``steps`` greedy decode
    steps, timed and counted on the main path; kernel 10 must launch
    ``attention_launches(cfg)`` times a step. Then one more step under the
    profiler, and the last timed step's logits against the full forward
    over the prompt and the fed tokens (reported). Given the model's
    stacked bf16 parameters ``tree``, that comparison is gated
    (:func:`decode_ok`) against the fp32 forward of the same parameters.
    ``keep`` records those kernel-10 calls (running index over the decode
    steps) into ``captured``."""
    from repro_torch.models import (decode_step, forward, logits_from_hidden,
                                    prefill)
    B, S = tokens.shape
    batch = {"tokens": tokens, **extra}
    fed = []
    before = ops.launch_counts()["flash_decode"]
    with path.counted():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch, cfg,
                                S + cfg.meta_tokens + steps + 1)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        with contextlib.ExitStack() as stack:
            if keep:
                stack.enter_context(recorded_calls(ops, "flash_decode",
                                                   set(keep), captured))
            t0 = time.perf_counter()
            for _ in range(steps):
                fed.append(cur)
                logits, cache = decode_step(model, cache, cur, cfg)
                cur = torch.argmax(logits[:, -1], -1)[:, None]
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
    n_fd = ops.launch_counts()["flash_decode"] - before
    want = attention_launches(cfg) * steps
    gate(n_fd == want, f"{label}: flash_decode launched {n_fd}, want {want}")
    last = logits[:, 0].clone()
    gate(bool(torch.isfinite(last).all()), f"{label}: non-finite logits")
    box = {"cache": cache, "cur": cur}

    def one_step():
        box["logits"], box["cache"] = decode_step(model, box["cache"],
                                                  box["cur"], cfg)
    traced = trace(torch, one_step, "flash_decode_kernel",
                   attention_launches(cfg))
    del box, cache, logits
    seq = torch.cat([tokens] + fed, dim=1)
    h, _ = forward(model, seq, cfg, extra)
    full = logits_from_hidden(model, h[:, -1:], cfg)[:, 0]
    del h
    out = {"batch": B, "prompt": S, "steps": steps, "prefill_s": t_pre,
           "decode_step_ms": t_dec / steps * 1e3,
           "decode_tokens_per_s": B * steps / t_dec,
           "tokens_per_s": B * steps / (t_pre + t_dec),
           "flash_decode_launches": n_fd, "trace_decode_step": traced,
           "decode_vs_forward": logit_gap(torch, last.float(),
                                          full.float()),
           "gated_vs_forward": tree is not None}
    if tree is not None:
        an = anchored(torch, last, full, fp32_logits(torch, cfg, tree, seq,
                                                     extra))
        out["vs_fp32_forward"] = an
        gate(decode_ok(out["decode_vs_forward"], an),
             f"{label}: decode vs forward {out['decode_vs_forward']}, vs "
             f"the fp32 forward {an}")
    return out


def family_answer(torch, ops, ctx, server, cfg, reqs, prompt, path, gate,
                  label):
    """``RAGServer.answer`` on the 64-request mix (phase 6's k, budget,
    prompt and steps): tokens (64, 16), every logit finite, stats equal to
    a direct ``retrieve_batch``, kernel 10 launched
    ``attention_launches(cfg) x 16`` times. Returns (its record, its
    tokens)."""
    from repro_torch.serving import rag
    queries, paths, rec = reqs
    B = len(paths)
    direct = ctx.retrieve_batch(queries, paths, server.cfg, recursive=rec)
    flags = []
    before = ops.launch_counts()["flash_decode"]
    with finite_logits(torch, rag, flags), path.counted():
        t0 = time.perf_counter()
        out = server.answer(queries, paths, prompt,
                            max_new_tokens=FAMILY_STEPS, recursive=rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_fd = ops.launch_counts()["flash_decode"] - before
    per = attention_launches(cfg) * FAMILY_STEPS
    toks = out["tokens"]
    gate(toks.shape == (B, FAMILY_STEPS) and toks.dtype == np.int32
         and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
         f"{label}: tokens {toks.shape} {toks.dtype}")
    gate(n_fd == per, f"{label}: flash_decode launched {n_fd}, want {per}")
    gate(all(bool(f) for f in flags) and len(flags) == 1 + FAMILY_STEPS,
         f"{label}: non-finite logits in {sum(not bool(f) for f in flags)} "
         f"of {len(flags)} calls")
    strip = [{k: v for k, v in st.items() if k not in _TIMING_KEYS}
             for st in out["retrieval_stats"]]
    gate(strip == [{k: v for k, v in st.items() if k not in _TIMING_KEYS}
                   for _, st in direct],
         f"{label}: retrieval_stats != retrieve_batch")
    return {"wall_s": wall, "retrieve_s": out["retrieve_s"],
            "decode_s": out["decode_s"], "tokens_per_s": B * FAMILY_STEPS
            / wall, "flash_decode_launches": n_fd}, toks


def rag_contexts(ctx, server, reqs, prompt) -> np.ndarray:
    """The answer's contexts, padded as ``_decode_batch`` pads them."""
    queries, paths, rec = reqs
    contexts = [server.assemble_with_prompt(h, prompt[0]) for h, _ in
                ctx.retrieve_batch(queries, paths, server.cfg,
                                   recursive=rec)]
    S = max(len(c) for c in contexts)
    toks = np.zeros((len(contexts), S), np.int32)
    for i, c in enumerate(contexts):
        toks[i, :len(c)] = c
    return toks


def moe_layer_check(torch, model, cfg, x, gate, label) -> dict:
    """Layer 0's ``moe_apply`` on MOE_CHECK_TOKENS of its prefill input
    with capacity_factor = E / K (nothing can drop), grouped against
    ``dense_tp``: within MOE_CHECK_REL of the output's largest magnitude.
    The routed experts only: the shared experts are the same code on both
    paths and would hide a difference in the routed part."""
    from repro_torch.models import moe as MOE
    x = x.reshape(-1, x.shape[-1])[:MOE_CHECK_TOKENS][None]
    ccfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k,
                       n_shared_experts=0)
    p = model.layers[0].moe
    drops = []
    with moe_probe(MOE, drops, {}):
        grouped = MOE.moe_apply(p, x, ccfg).float()
    dense = MOE.moe_apply(p, x, ccfg.replace(moe_impl="dense_tp")).float()
    err = float((grouped - dense).abs().max())
    mag = float(dense.abs().max())
    dropped = int(drops[0][1])
    gate(dropped == 0 and err <= MOE_CHECK_REL * mag,
         f"{label}: grouped vs dense_tp {err} of {mag} (limit "
         f"{MOE_CHECK_REL}), {dropped} hits dropped")
    return {"tokens": x.shape[1], "capacity_factor": ccfg.capacity_factor,
            "max_abs_err": err, "max_abs": mag, "rel": err / max(mag, 1e-30),
            "limit": MOE_CHECK_REL, "dropped": dropped}


def drop_table(drops: list, n_layers: int, steps: int, gate) -> dict:
    """Hits and dropped hits per layer at prefill and summed over the
    decode steps, from :func:`moe_probe`'s records of one answer (one a
    layer a call)."""
    vals = [int(d) for _, d in drops]
    hits = [h for h, _ in drops]
    gate(len(vals) == n_layers * (1 + steps),
         f"{len(vals)} MoE calls in an answer, want {n_layers * (1 + steps)}")
    if len(vals) != n_layers * (1 + steps):
        return {}
    pre = vals[:n_layers]
    dec = [sum(vals[n_layers * (1 + s) + i] for s in range(steps))
           for i in range(n_layers)]
    return {"prefill_hits_per_layer": hits[0], "prefill_dropped": pre,
            "decode_hits_per_layer": hits[n_layers] * steps,
            "decode_dropped": dec}


FAMILIES = {"a": "deepseek-moe-16b", "b": "hymba-1.5b", "c": "mamba2-130m",
            "d": "phi-3-vision-4.2b", "e": "whisper-large-v3",
            "f": "llama4-scout-17b-a16e", "g": "mamba2-130m"}


def phase11(torch, ops, ref, peaks, rag_db, card: str, measured: dict,
            device="cuda", cfgs=None):
    """The other LM families on the card (module docstring, phase 11), on
    phase 6's context database. Each model is built, driven and freed
    before the next. Every failed check is collected and reported at once.
    Returns the main path's launch counts. ``cfgs`` (label -> config, in
    place of FAMILIES' full configs) and ``device`` exist for the CPU
    rehearsal."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.models import Transformer, init_params, model_schema
    from repro_torch.models import moe as MOE
    from repro_torch.serving import RAGConfig, RAGServer
    from repro_torch.training import (DataConfig, OptConfig,
                                      SyntheticLMData, make_train_step)
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    t_phase = time.perf_counter()
    ds, ctx = rag_db["ds"], rag_db["ctx"]
    reqs = requests(ds)
    path = MainPath(ops)
    rcfg = RAGConfig(k=10, token_budget=512)
    gen = np.random.default_rng(11)
    info = {"phase": 11, "card": card, "context_vocab": FAMILY_VOCAB}
    records = {}

    def config(label):
        return (cfgs or {}).get(label) or get_arch(FAMILIES[label])

    def build(cfg):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = torch.Generator(device=device).manual_seed(0)
        tree = init_params(model_schema(cfg), g, cfg.param_dtype(), device)
        model = Transformer(cfg, tree, device=device)   # views of ``tree``
        torch.cuda.synchronize()
        return model, tree, {"model": cfg.name, "family": cfg.family,
                       "layers": cfg.n_layers, "dtype": cfg.dtype,
                       "params": cfg.param_count(),
                       "params_held": sum(p.numel()
                                          for p in model.parameters()),
                       "init_s": time.perf_counter() - t0}

    def prompt_for(cfg):
        return [np.random.default_rng(1).integers(
            0, min(cfg.vocab_size, FAMILY_VOCAB),
            size=RAG_PROMPT).astype(np.int32)]

    def done(rec, label):
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        rec["card"] = card
        emit({"phase": f"11{label}", **rec})
        records[label] = rec

    def kernel_cases(calls, label, timed_idx):
        out = {}
        for idx, args, kw in calls:
            if idx == timed_idx:
                out[idx] = flash_record(torch, ops, ref, peaks, *args)
            else:
                err, at = flash_case(torch, ops, ref,
                                     f"{label} flash_decode call {idx}",
                                     *args, **kw)
                b, h, d = args[0].shape
                out[idx] = {"max_abs_err": err, "err_at_value": at,
                            "shape": f"b={b} h={h} kv={args[1].shape[1]} "
                                     f"s={args[1].shape[2]} d={d}"}
        return out

    # (11a) deepseek-moe-16b, full width and depth
    cfg = config("a")
    model, tree, rec = build(cfg)
    server = RAGServer(ctx, model, cfg, rcfg)
    prompt = prompt_for(cfg)
    drops, first = [], {}
    with moe_probe(MOE, drops, first):
        rec["answer"], toks = family_answer(torch, ops, ctx, server, cfg,
                                            reqs, prompt, path, gate, "11a")
    rec["moe_drops"] = drop_table(drops, cfg.n_layers, FAMILY_STEPS, gate)
    rec["answer_again"], again = family_answer(
        torch, ops, ctx, server, cfg, reqs, prompt, path, gate, "11a again")
    gate(np.array_equal(again, toks),
         "11a: the same batch answered twice gave other tokens")
    rec["moe_check"] = moe_layer_check(torch, model, cfg, first["x"], gate,
                                       "11a")
    del first, drops
    tk = torch.from_numpy(rag_contexts(ctx, server, reqs, prompt)).to(device)
    rec["direct"] = direct_decode(torch, ops, model, cfg, tk, {},
                                  FAMILY_STEPS, path, gate, "11a")
    del model, tree, server, tk
    done(rec, "a")

    # (11b) hymba-1.5b, full width and depth
    cfg = config("b")
    model, tree, rec = build(cfg)
    server = RAGServer(ctx, model, cfg, rcfg)
    prompt = prompt_for(cfg)
    rec["answer"], _ = family_answer(torch, ops, ctx, server, cfg, reqs,
                                     prompt, path, gate, "11b")
    tk = torch.from_numpy(rag_contexts(ctx, server, reqs, prompt)).to(device)
    last = (FAMILY_STEPS - 1) * cfg.n_layers
    calls = []
    rec["rag_direct"] = direct_decode(torch, ops, model, cfg, tk, {},
                                      FAMILY_STEPS, path, gate, "11b rag",
                                      keep=(last, last + 1), captured=calls,
                                      tree=tree)
    gate(len(calls) == 2, f"11b: recorded {len(calls)} kernel-10 calls")
    rec["kernel10_rag"] = kernel_cases(calls, "11b rag global/local", last)
    b, s = HYMBA_DIRECT
    tk = torch.from_numpy(gen.integers(0, cfg.vocab_size, size=(b, s))
                          .astype(np.int64)).to(device)
    calls = []
    rec["direct"] = direct_decode(torch, ops, model, cfg, tk, {},
                                  FAMILY_STEPS, path, gate, "11b long",
                                  keep=(last, last + 1), captured=calls,
                                  tree=tree)
    rec["direct"]["positions"] = s + cfg.meta_tokens + FAMILY_STEPS
    rec["direct"]["window"] = cfg.sliding_window
    gate(len(calls) == 2, f"11b: recorded {len(calls)} kernel-10 calls")
    rec["kernel10"] = kernel_cases(calls, "11b global/local", last)
    del model, tree, server, tk, calls
    done(rec, "b")

    # (11c) mamba2-130m
    cfg = config("c")
    model, tree, rec = build(cfg)
    server = RAGServer(ctx, model, cfg, rcfg)
    prompt = prompt_for(cfg)
    rec["answer"], _ = family_answer(torch, ops, ctx, server, cfg, reqs,
                                     prompt, path, gate, "11c")
    tk = torch.from_numpy(rag_contexts(ctx, server, reqs, prompt)).to(device)
    rec["direct"] = direct_decode(torch, ops, model, cfg, tk, {},
                                  FAMILY_STEPS, path, gate, "11c", tree=tree)
    del model, tree, server, tk
    done(rec, "c")

    # (11d) phi-3-vision-4.2b
    cfg = config("d")
    model, tree, rec = build(cfg)
    server = RAGServer(ctx, model, cfg, rcfg)
    prompt = prompt_for(cfg)
    rec["answer"], _ = family_answer(torch, ops, ctx, server, cfg, reqs,
                                     prompt, path, gate, "11d")
    b, s = PHI_DIRECT
    s += cfg.num_patches
    tk = torch.from_numpy(gen.integers(0, cfg.vocab_size, size=(b, s))
                          .astype(np.int64)).to(device)
    # stub patch embeddings at the token embeddings' scale (std 0.02)
    pg = torch.Generator(device=device).manual_seed(2)
    patches = (torch.randn(b, cfg.num_patches, cfg.d_model, generator=pg,
                           device=device) * 0.02).to(cfg.param_dtype())
    last = (FAMILY_STEPS - 1) * cfg.n_layers
    calls = []
    rec["direct"] = direct_decode(torch, ops, model, cfg, tk,
                                  {"patch_embeds": patches}, FAMILY_STEPS,
                                  path, gate, "11d patches", keep=(last,),
                                  captured=calls, tree=tree)
    gate(len(calls) == 1, f"11d: recorded {len(calls)} kernel-10 calls")
    rec["kernel10"] = kernel_cases(calls, "11d d=96", last)
    del model, tree, server, tk, patches, calls
    done(rec, "d")

    # (11e) whisper-large-v3, driven directly (the RAG server passes no
    # frames, as the reference's does not)
    cfg = config("e")
    model, tree, rec = build(cfg)
    b, s = WHISPER_DIRECT
    tk = torch.from_numpy(gen.integers(0, cfg.vocab_size, size=(b, s))
                          .astype(np.int64)).to(device)
    fg = torch.Generator(device=device).manual_seed(3)
    frames = torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=fg,
                         device=device).to(cfg.param_dtype())
    last = (FAMILY_STEPS - 1) * 2 * cfg.n_layers
    calls = []
    rec["direct"] = direct_decode(torch, ops, model, cfg, tk,
                                  {"frames": frames}, FAMILY_STEPS, path,
                                  gate, "11e", keep=(last, last + 1),
                                  captured=calls, tree=tree)
    rec["direct"]["frames"] = cfg.encoder_seq
    gate(len(calls) == 2, f"11e: recorded {len(calls)} kernel-10 calls")
    rec["kernel10"] = kernel_cases(calls, "11e self/cross", last + 1)
    del model, tree, tk, frames, calls
    done(rec, "e")

    # (11f) llama4-scout-17b-a16e at full width, depth cut
    full = config("f")
    cfg = full.replace(n_layers=min(LLAMA4_LAYERS, full.n_layers))
    model, tree, rec = build(cfg)
    rec["cut"] = {"layers": [full.n_layers, cfg.n_layers],
                  "params": [full.param_count(), cfg.param_count()],
                  "windows": [int(w) for w in cfg.layer_windows()]}
    server = RAGServer(ctx, model, cfg, rcfg)
    prompt = prompt_for(cfg)
    drops, first = [], {}
    with moe_probe(MOE, drops, first):
        rec["answer"], _ = family_answer(torch, ops, ctx, server, cfg, reqs,
                                         prompt, path, gate, "11f")
    rec["moe_drops"] = drop_table(drops, cfg.n_layers, FAMILY_STEPS, gate)
    rec["moe_check"] = moe_layer_check(torch, model, cfg, first["x"], gate,
                                       "11f")
    del first, drops
    tk = torch.from_numpy(rag_contexts(ctx, server, reqs, prompt)).to(device)
    rec["direct"] = direct_decode(torch, ops, model, cfg, tk, {},
                                  FAMILY_STEPS, path, gate, "11f")
    del model, tree, server, tk
    done(rec, "f")

    # (11g) training the full-width mamba2-130m through launch/train.py
    cfg = config("g")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, opt = launcher.build(cfg, device, seed=0)
    torch.cuda.synchronize()
    rec = {"model": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "remat": cfg.remat,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN11_STEPS,
           "init_s": time.perf_counter() - t0}
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH))
    step_fn = make_train_step(cfg, OptConfig(
        lr=TRAIN_LR, total_steps=TRAIN11_STEPS,
        warmup_steps=max(1, TRAIN11_STEPS // 10)))
    lines = []
    launches0 = dict(ops.launch_counts())
    opt, recs = launcher.train(model, opt, step_fn, data,
                               range(TRAIN11_STEPS), device, log_every=5,
                               log=lines.append)
    losses = [r["loss"] for r in recs]
    step_s = [r["s"] for r in recs[1:]]
    med = statistics.median(step_s)
    rec.update({"losses": losses, "step_ms_median": med * 1e3,
                "step_ms_min": min(step_s) * 1e3,
                "step_ms_max": max(step_s) * 1e3,
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "log": lines,
                "port_kernel_launches": sum(ops.launch_counts().values())
                - sum(launches0.values())})
    gate(all(np.isfinite(losses)), f"11g: a loss is not finite {losses}")
    gate(np.mean(losses[-5:]) < np.mean(losses[:5]),
         f"11g: loss did not fall: first 5 {losses[:5]}, last 5 "
         f"{losses[-5:]}")
    del model, params, opt
    done(rec, "g")
    gc.collect()
    torch.cuda.empty_cache()

    measured["flash_decode"]["phase11"] = {
        "hymba_rag": records["b"]["kernel10_rag"],
        **{FAMILIES[label]: records[label]["kernel10"]
           for label in ("b", "d", "e")}}
    info["launches_main_path"] = dict(path.counts)
    info["phase_s"] = time.perf_counter() - t_phase
    info["models"] = {label: {key: records[label].get(key) for key in (
        "model", "init_s", "peak_device_bytes")} for label in records}
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return dict(path.counts)


# ---------------------------------------------------------------- phase 12
SERVE_ARCH = "qwen3-0.6b"
SERVE_REQUESTS = 64        # the RAG dataset's 64 queries and anchors
SERVE_QPS = 4.0            # Poisson arrivals (launch/serve.py's default)
SERVE_BATCH = 8
SERVE_SLO_MS = 50.0
SERVE_STEPS = 16           # new tokens a request
SERVE_QUEUE = 256
SERVE_LIMIT_S = 60.0       # the whole phase, set-up and dry-run included


def phase12(torch, ops, rag_db, card: str, sizes: dict, device="cuda",
            smoke: bool = False, memory_bytes=None) -> dict:
    """The serving launcher (``launch/serve.py``) and the dry-run tools on
    phase 6's context database (module docstring, phase 12). Every failed
    check is collected and reported at once. Returns the launch counts of
    the serving window. ``device``, ``smoke`` (the launcher's ``--smoke``
    config, for a context database whose payloads lie below 256) and
    ``memory_bytes`` (the dry-run's device memory) exist for the CPU
    rehearsal."""
    from repro_torch.configs import ARCHS, SHAPES, ShapeSpec
    from repro_torch.launch import dryrun, serve, specs
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    t_phase = time.perf_counter()
    ds, ctx = rag_db["ds"], rag_db["ctx"]
    args = serve.parse_args(
        ["--arch", SERVE_ARCH, "--requests", str(SERVE_REQUESTS),
         "--qps", str(SERVE_QPS), "--batch", str(SERVE_BATCH),
         "--slo-ms", str(SERVE_SLO_MS), "--new-tokens", str(SERVE_STEPS),
         "--queue-capacity", str(SERVE_QUEUE), "--device", device]
        + (["--smoke"] if smoke else []))
    built = serve.build(args, ctx=ctx, ds=ds)     # model, warm-up answer
    cfg = built.cfg
    path = MainPath(ops)
    with path.counted():
        out = serve.serve(built.server, built.queries, built.scopes,
                          built.prompts, qps=args.qps, max_batch=args.batch,
                          slo_ms=args.slo_ms,
                          queue_capacity=args.queue_capacity,
                          new_tokens=args.new_tokens, seed=args.seed)
    counts = dict(path.counts)
    results = out.pop("results")
    gate((out["served"], out["shed"], out["failed"])
         == (SERVE_REQUESTS, 0, 0),
         f"12: served {out['served']}, shed {out['shed']}, failed "
         f"{out['failed']} of {SERVE_REQUESTS}: {out['errors']}")
    gate(all(r["tokens"].shape == (SERVE_STEPS,)
             and bool(((r["tokens"] >= 0)
                       & (r["tokens"] < cfg.vocab_size)).all())
             for r in results), "12: a result's tokens")
    # retrieval does not depend on the batch: each request's hits are
    # those of the request retrieved alone
    rcfg = built.server.cfg
    alone = 0
    for r in results:
        i = r["index"]
        (hits, st), = ctx.retrieve_batch(built.queries[i:i + 1],
                                         [built.scopes[i]], rcfg)
        alone += ([h.entry_id for h in hits] == r["hits"]
                  and st["scope_size"] == r["scope_size"])
    gate(alone == len(results),
         f"12: {len(results) - alone} requests' hits != retrieve_batch")
    want = cfg.n_layers * SERVE_STEPS * out["batches"]
    gate(counts["flash_decode"] == want,
         f"12: flash_decode launched {counts['flash_decode']}, want "
         f"{cfg.n_layers} x {SERVE_STEPS} x {out['batches']} = {want}")
    out["failed_requests"] = out.pop("failed")
    model_s, warm_s = built.model_s, built.warm_s
    del built
    gc.collect()
    torch.cuda.empty_cache()

    # the dry-run: every cell's records, and the specs against what phase
    # 6's model and decode cache really allocated
    t0 = time.perf_counter()
    memory = (memory_bytes if memory_bytes is not None else
              float(torch.cuda.get_device_properties(0).total_memory))
    recs = [dryrun.run_cell(a, sh, 1, memory) for a in ARCHS for sh in SHAPES]
    cells = {f"{r['arch']}/{r['shape']}": (
        "skipped" if r["skipped"] else
        [r["roofline"]["bound_s"] * 1e3, r["roofline"]["dominant"],
         r["fits"]]) for r in recs}
    # the served config is phase 6's (same arch, bf16 or the smoke one)
    spec_bytes = {
        "params": specs.tree_bytes(specs.params_specs(cfg)),
        "cache": specs.tree_bytes(specs.cache_specs(cfg, ShapeSpec(
            "phase6", sizes["cache_seq"], sizes["cache_batch"], "decode")))}
    gate(len(recs) == len(ARCHS) * len(SHAPES)
         and all(r["skipped"] or r["fits"] is not None for r in recs),
         "12: dry-run records")
    gate(spec_bytes["params"] == sizes["param_bytes"],
         f"12: params_specs bytes {spec_bytes['params']} != phase 6's "
         f"model {sizes['param_bytes']}")
    gate(spec_bytes["cache"] == sizes["cache_bytes"],
         f"12: cache_specs bytes {spec_bytes['cache']} != phase 6's cache "
         f"{sizes['cache_bytes']}")
    emit({"phase": "12-dryrun", "chips": 1, "memory_bytes": memory,
          "cells": cells, "spec_bytes": spec_bytes,
          "allocated_bytes": {"params": sizes["param_bytes"],
                              "cache": sizes["cache_bytes"]},
          "s": time.perf_counter() - t0})
    phase_s = time.perf_counter() - t_phase
    gate(phase_s <= SERVE_LIMIT_S,
         f"12: took {phase_s:.1f} s, limit {SERVE_LIMIT_S}")
    emit({"phase": 12, "card": card, "model": cfg.name, "dtype": cfg.dtype,
          "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
          "slo_ms": SERVE_SLO_MS, "new_tokens": SERVE_STEPS, **out,
          "model_s": model_s, "warm_s": warm_s,
          "launches_main_path": counts, "phase_s": phase_s,
          "failed": failed})
    check(not failed, "; ".join(failed))
    return counts


# ---------------------------------------------------------------- phase 10
TRAIN_BATCH = 8            # sequences a step
TRAIN_SEQ = 512            # tokens a sequence: 4,096 tokens a step
TRAIN_STEPS = 20
TRAIN_SAVE_AT = 9          # the checkpoint the restart restores (step m)
TRAIN_LR = 3e-4            # launch/train.py's default
# accum_steps=2's first loss against accum_steps=1's: the two halves' bf16
# products may round differently from the whole batch's (other cuBLAS
# tiles), so each position's loss moves by ~2^-8 of its logits' spread and
# the mean over 4,096 positions far less; 1e-3 of the loss (~0.012 at
# ln(151,936) = 11.9) holds that with room
TRAIN_ACCUM_RTOL = 1e-3


def fingerprint(torch, params) -> list:
    """Each parameter's bits summed as int64: equal lists mean equal
    parameters with overwhelming probability, read back in one copy."""
    sums = [(p.view(torch.int16) if p.element_size() == 2
             else p.view(torch.int32)).sum(dtype=torch.int64)
            for p in params.values()]
    return torch.stack(sums).tolist()


def phase10(torch, ops, card: str, cfg=None, device="cuda",
            steps=TRAIN_STEPS, save_at=TRAIN_SAVE_AT, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ) -> dict:
    """Training on the card (module docstring, phase 10) under
    ``torch.use_deterministic_algorithms(True)``. ``cfg``, ``device`` and
    the sizes exist for the CPU rehearsal."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.training import (CheckpointManager, DataConfig,
                                      OptConfig, SyntheticLMData,
                                      make_train_step)
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    cfg = (cfg or get_arch("qwen3-0.6b")).replace(remat="full")
    info = {"phase": 10, "card": card, "model": cfg.name,
            "dtype": cfg.dtype, "layers": cfg.n_layers,
            "params": cfg.param_count(), "batch": batch, "seq": seq,
            "tokens_per_step": batch * seq, "remat": cfg.remat,
            "attn_impl": cfg.attn_impl, "steps": steps, "save_at": save_at,
            "deterministic": True}
    opt_cfg = OptConfig(lr=TRAIN_LR, total_steps=steps,
                        warmup_steps=max(1, steps // 10))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, seq, batch))
    lines = []
    log = lines.append
    launches0 = dict(ops.launch_counts())
    torch.use_deterministic_algorithms(True)
    # deterministic mode also fills every new tensor with NaN (a check for
    # reads of uninitialized memory; 8,065 fills, 41 ms a step in the
    # first card run); nothing here reads memory before writing it
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.cuda.reset_peak_memory_stats()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            ckpt = CheckpointManager(Path(tmp) / "ckpt", keep=1)
            step_fn = make_train_step(cfg, opt_cfg)
            t0 = time.perf_counter()
            model, params, opt = launcher.build(cfg, device, seed=0)
            torch.cuda.synchronize()
            info["init_s"] = time.perf_counter() - t0
            opt, recs = launcher.train(model, opt, step_fn, data,
                                       range(0, save_at + 1), device,
                                       log_every=5, log=log)
            saved = {"params": {n: p.to("cpu", copy=True)
                                for n, p in params.items()},
                     "opt": {"mu": {n: t.to("cpu", copy=True)
                                    for n, t in opt["mu"].items()},
                             "nu": {n: t.to("cpu", copy=True)
                                    for n, t in opt["nu"].items()},
                             "step": opt["step"].cpu()}}
            t0 = time.perf_counter()
            ckpt.save_async(save_at, {"params": params, "opt": opt})
            info["ckpt_snapshot_s"] = time.perf_counter() - t0
            # the write overlaps the next steps, as in launch/train.py
            opt, more = launcher.train(model, opt, step_fn, data,
                                       range(save_at + 1, steps), device,
                                       log_every=5, log=log)
            recs += more
            t0 = time.perf_counter()
            ckpt.wait()
            info["ckpt_wait_s"] = time.perf_counter() - t0
            info["ckpt_write_s"] = ckpt.last_write_s
            info["ckpt_bytes"] = ckpt.last_write_bytes
            info["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            final = fingerprint(torch, params)
            losses = [r["loss"] for r in recs]
            step_s = [r["s"] for r in recs[1:]]      # step 0 warms up
            med = statistics.median(step_s)
            info["losses"] = losses
            info["grad_norms"] = [r["grad_norm"] for r in recs]
            info["step_ms_median"] = med * 1e3
            info["step_ms_min"] = min(step_s) * 1e3
            info["step_ms_max"] = max(step_s) * 1e3
            info["tokens_per_s"] = batch * seq / med
            gate(all(np.isfinite(losses)), f"10: a loss is not finite "
                 f"{losses}")
            gate(np.mean(losses[-5:]) < np.mean(losses[:5]),
                 f"10: loss did not fall: first 5 {losses[:5]}, last 5 "
                 f"{losses[-5:]}")
            # one more step under the profiler (its batch made first):
            # device time and idle share of the step function alone
            box = {"opt": opt, "batch": {
                k: torch.from_numpy(v).to(device)
                for k, v in data.batch(steps).items()}}

            def one_step():
                box["opt"], m = step_fn(model, box["opt"], box["batch"])
                float(m["loss"])
            info["trace_step"] = trace(torch, one_step, "", None, top=15)
            del model, params, opt, box
            gc.collect()
            torch.cuda.empty_cache()

            # restart: a fresh model and optimizer restore step m
            model, params, opt = launcher.build(cfg, device, seed=1)
            t0 = time.perf_counter()
            opt, at = launcher.restore(ckpt, params, opt, device)
            torch.cuda.synchronize()
            info["restore_s"] = time.perf_counter() - t0
            gate(at == save_at, f"10: restored step {at} != {save_at}")
            same = all(torch.equal(p.cpu(), saved["params"][n])
                       for n, p in params.items()) and all(
                torch.equal(opt[key][n].cpu(), saved["opt"][key][n])
                for key in ("mu", "nu") for n in params) and torch.equal(
                opt["step"].cpu(), saved["opt"]["step"])
            gate(same, "10: the restored state differs from the saved one")
            del saved
            opt, resumed = launcher.train(model, opt, step_fn, data,
                                          range(at + 1, steps), device,
                                          log_every=5, log=log)
            again = [r["loss"] for r in resumed]
            info["resumed_losses"] = again
            info["resume_bitwise"] = again == losses[at + 1:] and \
                fingerprint(torch, params) == final
            gate(info["resume_bitwise"],
                 f"10: resumed losses {again} != {losses[at + 1:]} or the "
                 "final parameters differ")
            del model, params, opt
            gc.collect()
            torch.cuda.empty_cache()

            # accum_steps=2: the first step's loss against accum_steps=1's
            model, params, opt = launcher.build(cfg, device, seed=0)
            _, first = launcher.train(
                model, opt, make_train_step(cfg, opt_cfg, accum_steps=2),
                data, range(0, 1), device, log=log)
            info["accum2_first_loss"] = first[0]["loss"]
            info["accum2_diff"] = abs(first[0]["loss"] - losses[0])
            info["accum2_rtol"] = TRAIN_ACCUM_RTOL
            gate(info["accum2_diff"] <= TRAIN_ACCUM_RTOL * abs(losses[0]),
                 f"10: accum_steps=2 first loss {first[0]['loss']} vs "
                 f"{losses[0]}")
            del model, params, opt
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        gc.collect()
        torch.cuda.empty_cache()
    info["port_kernel_launches"] = sum(ops.launch_counts().values()) - sum(
        launches0.values())
    info["log"] = lines
    info["failed"] = failed
    emit(info)
    check(not failed, "; ".join(failed))
    return info


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="WIKI-Dir scale (1.0 = published size)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 8's DSM picks and ingested rows")
    args = ap.parse_args()

    # phase 10 runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's fixed workspace chosen before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    peaks = peaks_of(name)
    t0 = time.perf_counter()
    _build.library()
    regs = [line.strip() for line in _build.build_log.splitlines()
            if "registers" in line]
    emit({"phase": 0, "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_seconds, "ptxas": regs,
          "peaks": {"hbm_bytes_per_s": peaks[0], "fp32_flops": peaks[1],
                    "int8_ops": peaks[2], "bf16_flops": peaks[3]},
          "kernel_names": list(REPLACES)})

    measured = phase1(torch, ops, ref, peaks)
    scratch = ROOT / "build"            # ignored by git, like the kernels
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ds, db, batched, looped, c2, captured = phase2(
            torch, args, ops, str(Path(tmp) / "dsm.journal"))
        phase2_kernels(torch, ops, ref, peaks, captured, measured)
        del captured                    # it holds the fp32 device rows
        c3 = phase3(torch, ops, ds, db, batched, looped)
        c4, captured, rescores = phase4(torch, ops, ds, db, batched)
        phase4_kernels(torch, ops, ref, peaks, captured, rescores, measured)
        del captured, rescores
        c5, captured = phase5(torch, ops, ref, ds, db)
        phase5_kernels(torch, ops, ref, peaks, captured, measured)
        del captured
        c8, remapped = phase8(torch, ops, ref, args, ds, db, smi)
        c7 = phase7(torch, ops, ref, ds, db, tmp)
        c8g = phase8_compacted(torch, ops, ds, db, remapped, smi)
        c9 = phase9(torch, ops, ds, db, tmp, smi)
        del ds, db, batched, looped
    gc.collect()
    torch.cuda.empty_cache()
    rag_db = rag_database(args, FAMILY_VOCAB)
    c6, captured, sizes6 = phase6(torch, ops, args, rag_db=rag_db)
    phase6_kernels(torch, ops, ref, peaks, captured, measured)
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    c11 = phase11(torch, ops, ref, peaks, rag_db, smi, measured)
    gc.collect()
    torch.cuda.empty_cache()
    c12 = phase12(torch, ops, rag_db, smi, sizes6)
    del rag_db
    gc.collect()
    torch.cuda.empty_cache()
    phase10(torch, ops, smi)
    launches = {key: c2[key] + c3[key] + c4[key] + c5[key] + c6[key]
                + c7[key] + c8[key] + c8g[key] + c9[key] + c11[key]
                + c12[key] for key in c2}
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
