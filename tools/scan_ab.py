#!/usr/bin/env python3
"""Time one tree's CUDA kernels against another's on the same card.

    python3 tools/scan_ab.py --label change
    PYTHONPATH=<other checkout>/src python3 tools/scan_ab.py --label parent

Runs ``chip_smoke.py``'s phase 1 (every kernel held against its plain
version, then timed at the main path's shapes, with kernel 1 also at a
gather plan's 4,000 gathered rows, kernel 2 at ``gather_rescore``'s
block-diagonal shapes, kernel 8 also over bank-conflict-free codes and
kernel 9 at a synthetic IVF layout) with the ``repro_torch`` that comes
first on ``sys.path``: the one
``PYTHONPATH`` names, else this checkout's ``src``. Each tree builds its own
kernels under its own ``build/``. Prints one JSON line: the label, the
package's path, the card's name and power limit, and per kernel and shape
the CUDA-event time (``ms``), the profiler's device time (``device_ms``,
and pass 1's alone where recorded), the bound (and the PQ scans'
shared-memory lookup bound) and the library call's time. Compare two
trees only within one
run on one card, in turns (A, B, B, A), each in its own process.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("ms", "device_ms", "pass1_device_ms", "bound_ms", "lookup_bound_ms",
        "library_ms", "shape")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))            # chip_smoke.py
    sys.path.append(str(ROOT / "src"))       # after PYTHONPATH's trees
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import ops, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    peaks = next((v for key, v in chip_smoke.CARD_PEAKS.items()
                  if key in torch.cuda.get_device_name(0)),
                 chip_smoke.CARD_PEAKS["H100"])
    measured = chip_smoke.phase1(torch, ops, ref, peaks)
    table = {}
    for name, rec in measured.items():
        table[name] = {key: rec.get(key) for key in KEYS}
        for sub, nested in rec.items():
            if isinstance(nested, dict) and "ms" in nested:
                table[f"{name}/{sub}"] = {key: nested.get(key)
                                          for key in KEYS}
    print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                      "card": card, "kernels": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
