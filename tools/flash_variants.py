#!/usr/bin/env python3
"""Time variants of kernel 10's source and its split counts on one card.

    python3 tools/flash_variants.py                  # every variant, sweeps
    python3 tools/flash_variants.py --only final no_two_warps --no-sweep

Each variant is this checkout's ``kernels/csrc/flash_decode.cu`` with the
text substitutions listed in :data:`VARIANTS`, built on its own (the source
has its own C entry) into ``build/flash_variants/<name>.so``, all at once;
the launch wrapper ``kernels/flash_decode.py`` then calls each library in
turn (the list, then the list reversed) at ``chip_smoke.py``'s kernel-10
shapes (the RAG decode shape, the 32,768-position cache and
``FAMILY_FLASH``; bf16, inputs from seed 0), each held against the plain
version first (a variant that changes what is computed is marked
``"checked": false`` and skipped there). Then, unless ``--no-sweep``, the
final source at forced split counts (the wrapper's ``n_split``) beside
``split_plan``'s. Prints one JSON line per shape: the profiler's device
time of each variant (``<name>#0``, ``<name>#1``) and split count
(``n<k>``), with the card's name and power limit.

The variants are the experiments behind the design in the source's note
(``PERF.md`` section 6, PR 23).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/flash_decode.cu"
OUT = ROOT / "build/flash_variants"

_TWO = ("a.n_split == 1 && rows >= kTwoWarpBlocks * "
        "static_cast<long long>(sms)")
_NO_TWO = ("constexpr int kTwoWarpBlocks = 3;",
           "constexpr int kTwoWarpBlocks = 1 << 20;")
_STAGES = "a.ns = warps != 8 && smem_of(3) <= kThreeStageMax ? 3 : 2;"
_COMPUTE = "if (__any_sync(0xffffffffu, lane < 16 && msk[lane & 15])) {"

# name -> (substitutions, computes the same function)
VARIANTS = {
    "final": ([], True),
    # above d = 64, 4 warps at any grid size; or 2 at any grid size
    "no_two_warps": ([_NO_TWO], True),
    "two_warps_always": ([(_TWO, "true")], True),
    # 4 warps (64-position tiles) at every head dim
    "four_warps": ([("constexpr int kWideChunks = 4;",
                     "constexpr int kWideChunks = 0;"), _NO_TWO], True),
    # 8 warps (128-position tiles) at every head dim
    "eight_warps": ([("constexpr int kWideChunks = 4;",
                      "constexpr int kWideChunks = 16;")], True),
    # 3 stages on 8 warps too where they fit
    "eight_warps_3_stages": ([(_STAGES, _STAGES.replace("warps != 8 && ",
                                                        ""))], True),
    # the copies alone: the ring's own ceiling
    "copies_only": ([(_COMPUTE, _COMPUTE.replace("if (", "if (false && "))],
                    False),
}
SPLITS = (1, 2, 4, 8, 13, 16, 24, 33, 48, 66)


def build(names):
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name][0]:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.library()              # the final library, built meanwhile
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_flash_decode
        fn.argtypes = _build.SIGNATURES["repro_flash_decode"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    fd = ops._fd
    names = args.only or list(VARIANTS)
    entries = build(names)
    final = fd._launcher()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv, s, d = cs.RAG_SHAPE
    shapes = {"main": (b, h, kv, s, d, 0, s - 15),
              "long": (1, h, kv, cs.LONG_S, d, 0, cs.LONG_S),
              **cs.FAMILY_FLASH}
    for label, (b, h, kv, s, d, window, lo) in shapes.items():
        q, k, v, mask = cs.flash_inputs(torch, g, b, h, kv, s, d,
                                        torch.bfloat16, lo=lo, window=window)
        plan = fd.split_plan(b, kv, s, h // kv, q.dtype, sms)
        row = {"card": card, "plan": plan}
        try:
            for name in names:
                if VARIANTS[name][1]:
                    fd._entry = entries[name]
                    cs.flash_case(torch, ops, ref, f"{name} {label}", q, k,
                                  v, mask)
                else:
                    row[f"{name} checked"] = False
            for rep, order in enumerate((names, names[::-1])):
                for name in order:
                    fd._entry = entries[name]
                    row[f"{name}#{rep}"] = cs.device_ms(
                        torch, lambda: ops.flash_decode(q, k, v, mask), 20,
                        cs.FLASH_KERNELS)
        finally:
            fd._entry = final
        if not args.no_sweep:
            tiles = -(-s // fd.SPLIT_TILE)
            for n in sorted({n for n in SPLITS if n <= tiles} | {plan}):
                row[f"n{n}"] = cs.device_ms(
                    torch, lambda: fd.flash_decode(q, k, v, mask, n_split=n),
                    20, cs.FLASH_KERNELS)
        print(json.dumps({label: row}), flush=True)
        del q, k, v, mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
