#!/usr/bin/env python3
"""Time one tree's CUDA kernels against another's on the same card.

    python3 tools/scan_ab.py --label change
    PYTHONPATH=<other checkout>/src python3 tools/scan_ab.py --label parent

Runs the ``repro_torch`` that comes first on ``sys.path`` (the one
``PYTHONPATH`` names, else this checkout's ``src``) through the phase 1 of
the ``chip_smoke.py`` beside it (``<tree>/chip_smoke.py``: every kernel
held against its plain version, then timed at the main path's shapes, with
kernel 1 also at a gather plan's 4,000 gathered rows, kernel 2 at
``gather_rescore``'s block-diagonal shapes, kernel 8 also over
bank-conflict-free codes and kernel 9 at a synthetic IVF layout), so unpack
the other tree's ``src/repro_torch`` and ``chip_smoke.py`` together. Then,
on inputs that are the same for both trees, kernel 9 in its three modes
on a layout skewed like phase 5's k-means lists (64 lists, 8 probed per
query, B = 64 over 1.94M rows): its candidate form, which every tree has,
and its list form where the tree has one; and kernel 7 at the shape of
its widest real launch, a PQ batch's gather plan (q = 5 over 41,829
gathered rows, M = 32, k = 80, an all-ones mask); and kernel 10 at the
RAG decode shape, the 32,768-position cache and phase 11's four family
shapes (``flash/*``). ``--kernels 10`` runs only those kernel-10 shapes
(a few seconds after the build). Each tree builds its own kernels under
its own ``build/``. Prints one JSON line: the label, the package's
path, the card's name and power limit, and per kernel and shape the
CUDA-event time (``ms``; kernel 10 also its wrapper's host time alone,
``host_us``), the profiler's device time (``device_ms``, and
pass 1's alone where recorded), the bound (and the PQ scans' shared-memory
lookup bound) and the library call's time. Compare two trees only within
one run on one card, in turns (A, B, B, A), each in its own process.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("ms", "device_ms", "pass1_device_ms", "bound_ms", "lookup_bound_ms",
        "library_ms", "shape")


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def skewed_ivf(torch, ops, ref, here) -> dict:
    """Kernel 9's three modes on one skewed synthetic layout (this
    checkout's ``chip_smoke.synthetic_layout``, seed 1): the candidate form
    on the expanded matrix, and the list form where ``ops`` has it, each
    held against its plain version and timed."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    n, d, M, B, S, k = here.MAIN_ROWS, 128, 32, 64, 8, 10
    X = here.unit(torch, torch.randn(n, d, generator=g, device=dev))
    dense = torch.rand(S, n, generator=g, device=dev) < torch.linspace(
        0.2, 1.0, S, device=dev)[:, None]
    dense[-1] = True
    words = here.words_of(torch, dense)
    sid = (torch.arange(B, device=dev) % S).to(torch.int32)
    layout, probe = here.synthetic_layout(torch, g, n, B, dev)
    cand = here.expand(torch, layout, probe)
    Q = torch.randn(B, d, generator=g, device=dev)
    q8, qs = here.quantize(torch, Q)
    x8, xs = here.quantize(torch, X)
    lut = torch.randn(B, M, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n, M), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    listed = (*layout, probe)
    calls = {
        "ivf_gather_topk": ((Q, X), (words, sid, k), here.topk_case),
        "ivf_gather_topk_i8": ((q8, qs, x8, xs, None), (words, sid, 4 * k),
                               lambda r, label, a, b: here.exact_case(
                                   torch, label, a, b)),
        "ivf_gather_topk_pq": ((lut, codes), (words, sid, 8 * k),
                               lambda r, label, a, b: here.exact_case(
                                   torch, label, a, b))}
    out = {}
    for name, (head, tail, agree) in calls.items():
        forms = {"cand_form": (name, (*head, cand, *tail))}
        lname = name.replace("gather", "probe")
        if hasattr(ops, lname):
            forms["list_form"] = (lname, (*head, *listed, *tail))
        for form, (fname, args) in forms.items():
            fn = getattr(ops, fname)
            agree(ref, f"{fname} skewed", fn(*args),
                  getattr(ref, fname + "_ref")(*args))
            out[f"{name}/skewed_{form}"] = {
                **here.timed(torch, lambda: fn(*args), 10,
                             ("scan_pass1", "scan_pass2")),
                "shape": f"B={B} n={n} lists={here.IVF_LISTS} "
                         f"nprobe={here.IVF_NPROBE} C={cand.shape[1]} "
                         f"k={tail[-1]}"}
    return out


def pq_gather(torch, ops, ref, here, peaks) -> dict:
    """Kernel 7 at the shape of the PQ batch's widest gather-plan launch on
    WIKI-Dir (q = 5, 41,829 gathered rows of M = 32 codes, k = r = 80, an
    all-ones mask), on random LUTs and codes from seed 2, held bit for bit
    against its plain version and timed by this checkout's
    ``chip_smoke.dense_pq_record``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q, n, M, k = 5, 41_829, 32, 80
    lut, codes = here.pq_case(torch, g, q, n, M, dev)
    ones = torch.ones(n, dtype=torch.int8, device=dev)
    return {"scoped_topk_pq/gather_synthetic": here.dense_pq_record(
        torch, ops, ref, peaks, (lut, codes, ones, k), {},
        "scoped_topk_pq gather (synthetic)")}


def flash_shapes(torch, ops, ref, here, peaks) -> dict:
    """Kernel 10 at this checkout's ``chip_smoke.RAG_SHAPE``, ``LONG_S`` and
    ``FAMILY_FLASH`` shapes (bf16), on inputs drawn from seed 3 in that
    order, so both trees see the same bits; each held against its plain
    version and timed by this checkout's ``chip_smoke.flash_record``."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, h, kv, s, d = here.RAG_SHAPE
    shapes = {"main": (b, h, kv, s, d, 0, s - 15),
              "long": (1, h, kv, here.LONG_S, d, 0, here.LONG_S),
              **here.FAMILY_FLASH}
    out = {}
    for label, (b, h, kv, s, d, window, lo) in shapes.items():
        args = here.flash_inputs(torch, g, b, h, kv, s, d, torch.bfloat16,
                                 lo=lo, window=window)
        out[f"flash/{label}"] = here.flash_record(torch, ops, ref, peaks,
                                                  *args)
        del args
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--kernels", choices=("all", "10"), default="all",
                    help="10: kernel 10's shapes only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.append(str(ROOT / "src"))       # after PYTHONPATH's trees
    import repro_torch
    from repro_torch.kernels import ops, ref

    tree = Path(repro_torch.__file__).resolve().parents[2]
    here = load("chip_smoke", ROOT / "chip_smoke.py")
    theirs = here if tree == ROOT else load("tree_chip_smoke",
                                            tree / "chip_smoke.py")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    peaks = here.peaks_of(torch.cuda.get_device_name(0))
    table = {}
    if args.kernels == "all":
        measured = theirs.phase1(torch, ops, ref, peaks)
        for name, rec in measured.items():
            table[name] = {key: rec.get(key) for key in KEYS}
            for sub, nested in rec.items():
                if isinstance(nested, dict) and "ms" in nested:
                    table[f"{name}/{sub}"] = {key: nested.get(key)
                                              for key in KEYS}
        table.update(skewed_ivf(torch, ops, ref, here))
        table.update(pq_gather(torch, ops, ref, here, peaks))
    for name, rec in flash_shapes(torch, ops, ref, here, peaks).items():
        table[name] = {key: rec.get(key) for key in (*KEYS, "n_split",
                                                     "plain_ms", "host_us")}
    print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                      "card": card, "kernels": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
