#!/usr/bin/env python3
"""Time variants of the scan kernels' source side by side on one card.

    python3 tools/scan_variants.py                 # every variant below
    python3 tools/scan_variants.py --only final list_chunk_2048
    python3 tools/scan_variants.py --only final pq_q1 --kernels 7

Each variant is this checkout's ``src/repro_torch`` copied under
``build/variants/<name>/`` with the text substitutions listed in
:data:`VARIANTS` (in the CUDA source, and in the Python constants that
mirror it). All variants are built at once, one process each; then each is
timed in a process of its own, in turns (the list, then the list reversed):
kernel 1 (``scoped_topk``) at q = 1 over 1.94M unit rows (d = 128, k = 10,
ip, every row admitted), kernel 5 (``scoped_topk_i8``) on the same rows'
int8 codes (k = 40), kernel 7 (``scoped_topk_pq``) at its main shape
(q = 1, M = 32, k = 40, every row admitted) and at the PQ batch's widest
gather plan (q = 5 over 41,829 gathered rows, k = 80, keys ending
" gather"), kernel 8 (``multi_scope_topk_pq``) at the main PQ shape
(q = 64, M = 32, k = 80, 8 scopes, random codes) and kernel 9's list
form in its three modes (``ivf_probe_topk*``, k = 10 / 40 / 80) on two
layouts of those rows skewed like phase 5's k-means lists (``chip_smoke``'s
``synthetic_layout``: 64 lists, 8 probed per query, the 8 scopes), one for
B = 64 queries and one for phase 5's B = 44 (keys ending " b44"),
each checked against its plain version first (a variant that changes what
is computed is marked ``"checked": false``); ``--kernels`` times some of
them (1, 5, 7, 8, 9). Prints one JSON line per run:
the CUDA-event time (``ms``), the profiler's device time (``device_ms``)
and pass 1's alone (``pass1_ms``), with the card's name and power limit.

The variants are the experiments behind the designs of
``scan_pass1_stream``, its list and PQ modes and ``scan_pass1_pq``
(``PERF.md`` section 6).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "kernels/csrc/scoped_topk.cu"
PY = "kernels/scoped_topk.py"
BM = "kernels/csrc/bitmap_ops.cu"
IVF_B = 44          # phase 5's IVF batch (B = 44 queries on its layout)
_EPILOGUE = ("    if (s != ns - 1) continue;\n"
             "    // epilogue: per query, the admitted")


_POPC_HEAD = """  if (rank == 0 && threadIdx.x == 0) {  // expect kPopBlocks totals' bytes
    unsigned long long state;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(bar)
                 : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\\n"
                 : "=l"(state)
                 : "r"(bar), "r"(4 * kPopBlocks)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
"""
_POPC_SEND = """  if (threadIdx.x == 0) {       // into rank 0's totals[rank], on its barrier
"""
_POPC_WAIT = """    asm volatile(
        "{\\n .reg .pred p;\\n WAIT%=:\\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\\n"
        " @!p bra WAIT%=;\\n}\\n" ::"r"(bar)
        : "memory");
"""
# kernel 4's first handoff: each block stores its total into rank 0's
# shared memory, then a cluster barrier (every block waits on it)
_POPC_SYNC = {
    _POPC_HEAD: "",
    _POPC_SEND: """  if (threadIdx.x == 0) *cluster.map_shared_rank(totals + rank, 0) = total;
  cluster.sync();
  if (false) {
""",
    _POPC_WAIT: ""}


def _stream(threads: int, slice_: int, stages: int = 3) -> dict:
    return {CU: {"kStreamThreads = 128;": f"kStreamThreads = {threads};",
                 "return kind == kF32 ? (list ? 32 : 64) : 256;":
                 f"return kind == kF32 ? (list ? 32 : {slice_}) : 256;",
                 "kStreamStages = 3;": f"kStreamStages = {stages};"},
            PY: {"STREAM_ROWS = 128": f"STREAM_ROWS = {threads}"}}


# name -> {file under src/repro_torch: {text: replacement}}
VARIANTS = {
    "final": {},
    # kernel 1: rows per tile (= threads), floats of a row per item, stages
    "stream_t256_s32": _stream(256, 32),
    "stream_t256_s16_x4": _stream(256, 16, 4),
    "stream_t128_s128": _stream(128, 128),
    "stream_t64_s128": _stream(64, 128),
    # kernel 8: the lookups alone (no epilogue: the scores are summed into
    # shared memory), and 8 warps instead of 16
    "pq_lookups_only": {CU: {_EPILOGUE: (
        "    if (s == ns - 1) {\n      float t = 0.0f;\n"
        "      for (int j = 0; j < kPQMaxQ; ++j) t += acc[j];\n"
        "      sv[threadIdx.x] += t;\n    }\n    continue;\n"
        "    // epilogue: per query, the admitted")}},
    "pq_w8": {CU: {"constexpr int kPQWarps = 16;":
                   "constexpr int kPQWarps = 8;"}},
    # kernel 8 with the code bytes taken out by shift and mask
    "pq_shift_extract": {CU: {
        "static_cast<int>(__byte_perm(\n"
        "                                    wd[b >> 2], 0u, 0x4440u + (b & 3)))":
        "((wd[b >> 2] >> (8 * (b & 3))) & 255u)"}},
    # kernel 9's list mode: list positions per block, and the fp32 item's
    # depth (64 floats: one block per SM beside the compacted rows)
    "list_chunk_2048": {CU: {"constexpr int kListChunk = 4096;":
                             "constexpr int kListChunk = 2048;"}},
    "list_chunk_8192": {CU: {"constexpr int kListChunk = 4096;":
                             "constexpr int kListChunk = 8192;"}},
    "list_f32_slice64": {CU: {"return kind == kF32 ? (list ? 32 : 64) : 256;":
                              "return kind == kF32 ? 64 : 256;"}},
    # the streaming pass without its epilogue (staging and chains alone),
    # and with its merges inlined
    "stream_no_epilogue": {CU: {"    if (any) {": "    if (false) {"}},
    # the streaming pass's buffers never merged (winners past 32 dropped),
    # and list tiles of at most 4 or 2 queries
    "stream_no_flush": {CU: {"          if (bc[j] + __popc(bal[j]) > 32) flush(j);":
                             "          if (bc[j] + __popc(bal[j]) > 32) bc[j] = 0;"}},
    "list_q4": {CU: {"  if (qt_cap > kListQ) qt_cap = kListQ;":
                     "  if (qt_cap > 4) qt_cap = 4;"}},
    "list_q2": {CU: {"  if (qt_cap > kListQ) qt_cap = kListQ;":
                     "  if (qt_cap > 2) qt_cap = 2;"}},
    # list tiles of up to 16 queries (PQ stays at 8): one tile holds every
    # query of a list on the B = 44 layout, most on the B = 64 one
    "list_q16": {CU: {"constexpr int kListQ = 8;": "constexpr int kListQ = 16;",
                      "constexpr int kStreamQ = 8;":
                      "constexpr int kStreamQ = 16;",
                      "constexpr int kStreamMisc = 256;":
                      "constexpr int kStreamMisc = 512;",
                      "    const PQPlan plan = pq_plan(1, qt_cap, depth, k);":
                      "    const PQPlan plan = pq_plan(\n"
                      "        1, qt_cap < kPQMaxQ ? qt_cap : kPQMaxQ, depth, k);"},
                 PY: {"LIST_Q = 8": "LIST_Q = 16"}},
    "inline_merge": {CU: {"__device__ __noinline__ void warp_merge(":
                          "__device__ void warp_merge(",
                          "__device__ __noinline__ void warp_insert(":
                          "__device__ void warp_insert("}},
    # kernel 7: the fewest rows of a chunk (its block's LUT copy against
    # its codes), and the PQ query tile (occupancy against code re-reads)
    "pq_floor_512": {PY: {"STREAM_PQ_ROWS = 1024": "STREAM_PQ_ROWS = 512"}},
    "pq_floor_2048": {PY: {"STREAM_PQ_ROWS = 1024": "STREAM_PQ_ROWS = 2048"}},
    "pq_floor_4096": {PY: {"STREAM_PQ_ROWS = 1024": "STREAM_PQ_ROWS = 4096"}},
    "pq_q2": {CU: {"constexpr int kStreamPQQ = 1;":
                   "constexpr int kStreamPQQ = 2;"}},
    "pq_q5": {CU: {"constexpr int kStreamPQQ = 1;":
                   "constexpr int kStreamPQQ = 5;"}},
    # kernel 7's grid sized to a wave of at most 2 blocks per SM (fewer,
    # longer chunks: fewer lists to merge, less occupancy)
    "pq_wave2": {PY: {"            nq, n, plan.qt, plan.blocks, block_n, sms,":
                      "            nq, n, plan.qt, min(plan.blocks, 2) if "
                      "kind == 'pq' else plan.blocks, block_n, sms,"}},
    # kernel 7's pass 1 without its lookups (staging and votes alone: every
    # score 0); "stream_no_epilogue" above takes out its appends and merges
    "pq_no_lookups": {CU: {
        "      if (t * kStreamRows + threadIdx.x < count && "
        "mt[threadIdx.x] != 0) {":
        "      if (false) {"}},
    # kernel 4: the cluster's blocks and threads, and the first handoff (a
    # cluster barrier, at 8 x 1,024 as first built and at 16 x 512)
    "popc_c8": {BM: {"kPopBlocks = 16;": "kPopBlocks = 8;"}},
    "popc_t1024": {BM: {"kPopThreads = 512;": "kPopThreads = 1024;"}},
    "popc_sync": {BM: _POPC_SYNC},
    "popc_c8_t1024_sync": {BM: {**_POPC_SYNC,
                                "kPopBlocks = 16;": "kPopBlocks = 8;",
                                "kPopThreads = 512;": "kPopThreads = 1024;"}},
}
KERNELS = ("1", "4", "5", "7", "8", "9")
# variants that change what a kernel computes (not held to its plain version)
UNCHECKED = ("pq_lookups_only", "stream_no_epilogue", "stream_no_flush",
             "pq_no_lookups")


def make(name: str) -> Path:
    """The variant's source tree (its ``src`` directory)."""
    src = ROOT / "build" / "variants" / name / "src"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, subs in VARIANTS[name].items():
        path = src / "repro_torch" / rel
        text = path.read_text()
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {rel}")
            text = text.replace(old, new)
        path.write_text(text)
    return src


def time_here(name: str, kernels=KERNELS) -> dict:
    """Kernels ``kernels`` (of 1, 4, 5, 7, 8 and 9) with the
    ``repro_torch`` first on ``sys.path``."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d, B, S, M = cs.MAIN_ROWS, 128, 64, 8, 32
    X = cs.unit(torch, torch.randn(n, d, generator=g, device=dev))
    Q1 = torch.randn(1, d, generator=g, device=dev)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    checked = name not in UNCHECKED
    runs = []                   # (key, fn, calls timed)

    def exact(label, got, want):
        if checked:
            cs.exact_case(torch, f"{name} {label}", got, want)

    def k1():
        return ops.scoped_topk(Q1, X, ones, 10)

    if "4" in kernels:          # phase 1's main shape: W = ceil(n / 32)
        a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, ((n + 31) // 32,),
                              generator=g, device=dev, dtype=torch.int32)
                for _ in range(2))
        w, c = ops.mask_and_popcount(a, b)
        want_w, want_c = ref.mask_and_popcount_ref(a, b)
        if checked and not (torch.equal(w, want_w) and
                            int(c) == int(want_c)):
            raise SystemExit(f"{name}: kernel 4 differs from its plain "
                             f"version")
        runs.append(("mask_and_popcount",
                     lambda: ops.mask_and_popcount(a, b), 50))
    if "1" in kernels:
        if checked:
            cs.topk_case(ref, f"{name} kernel 1", k1(),
                         ref.scoped_topk_ref(Q1, X, ones, 10))
        runs.append(("scoped_topk", k1, 30))
    x8, xs = cs.quantize(torch, X)
    q8, qs = cs.quantize(torch, Q1)

    def k5():
        return ops.scoped_topk_i8(q8, qs, x8, xs, None, ones, 40)

    if "5" in kernels:
        exact("kernel 5", k5(),
              ref.scoped_topk_i8_ref(q8, qs, x8, xs, None, ones, 40))
        runs.append(("scoped_topk_i8", k5, 30))
    dense = torch.rand(S, n, generator=g, device=dev) < torch.linspace(
        0.2, 1.0, S, device=dev)[:, None]
    dense[-1] = True
    words = cs.words_of(torch, dense)
    sid = (torch.arange(B, device=dev) % S).to(torch.int32)
    lut = torch.randn(B, M, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n, M), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    if "7" in kernels:          # the main shape, then the widest gather
        ng = 41_829
        gathered = codes[torch.randperm(n, generator=g, device=dev)[:ng]]
        k7 = {"scoped_topk_pq": (lut[:1], codes, ones, 40),
              "scoped_topk_pq gather": (lut[:5], gathered, ones[:ng], 80)}
        for key, args in k7.items():
            exact(key, ops.scoped_topk_pq(*args),
                  ref.scoped_topk_pq_ref(*args))
            runs.append((key, (lambda a: lambda: ops.scoped_topk_pq(*a))(
                args), 30))

    def k8():
        return ops.multi_scope_topk_pq(lut, codes, words, sid, 80)

    if "8" in kernels:
        exact("kernel 8", k8(),
              ref.multi_scope_topk_pq_ref(lut, codes, words, sid, 80))
        runs.append(("multi_scope_topk_pq", k8, 10))
    if "9" in kernels:
        QB = torch.randn(B, d, generator=g, device=dev)
        qb, sb = cs.quantize(torch, QB)
        k9 = {}
        for b in (B, IVF_B):    # the layout's batch: phase 1's, phase 5's
            layout, probe = cs.synthetic_layout(torch, g, n, b, dev)
            listed = (*layout, probe, words, sid[:b])
            tag = "" if b == B else f" b{b}"
            k9.update({
                "ivf_probe_topk" + tag: (QB[:b], X, *listed, 10),
                "ivf_probe_topk_i8" + tag: (qb[:b], sb[:b], x8, xs, None,
                                            *listed, 40),
                "ivf_probe_topk_pq" + tag: (lut[:b], codes, *listed, 80)})
        for key, args in k9.items():
            fn = getattr(ops, key.split()[0])
            got = fn(*args)
            want = getattr(ref, key.split()[0] + "_ref")(*args)
            if key.split()[0] != "ivf_probe_topk":     # int8, PQ: exact
                exact(key, got, want)
            elif checked:
                cs.topk_case(ref, f"{name} kernel 9 {key}", got, want)
            runs.append((key, (lambda f, a: lambda: f(*a))(fn, args), 10))
    out = {"variant": name, "checked": checked}
    for key, fn, n_runs in runs:
        if key == "mask_and_popcount":
            out[key] = cs.timed(torch, fn, n_runs, ("and_popc_kernel",))
            continue
        out[key] = {"ms": cs.median_ms(torch, fn, n_runs),
                    "device_ms": cs.device_ms(torch, fn, n_runs,
                                              ("scan_pass1", "scan_pass2")),
                    "pass1_ms": cs.device_ms(torch, fn, n_runs,
                                             ("scan_pass1",))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS))
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument("--time", help=argparse.SUPPRESS)   # one timing process
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))                       # chip_smoke.py
    if args.time:
        print(json.dumps(time_here(args.time, args.kernels)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    names = args.only or list(VARIANTS)
    srcs = {name: make(name) for name in names}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c",
         "from repro_torch.kernels import _build; _build.library()"],
        env={**os.environ, "PYTHONPATH": str(src)})
        for name, src in srcs.items()}
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"scan_variants: {name} did not build")
    for name in names + names[::-1]:
        run = subprocess.run(
            [sys.executable, __file__, "--time", name, "--kernels",
             *args.kernels],
            env={**os.environ, "PYTHONPATH": str(srcs[name])},
            capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"scan_variants: {name} failed:\n"
                             f"{run.stderr[-3000:]}")
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
