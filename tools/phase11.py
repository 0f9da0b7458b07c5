#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11 (the MoE, SSM, hybrid, encoder-decoder
and VLM families on the card) alone.

    python3 tools/phase11.py                # phase 6's context database
    python3 tools/phase11.py --scale 0.1    # a tenth of it: a quicker run

Builds the CUDA kernels, ingests the RAG context database as phase 6 does
(WIKI-Dir at 0.02 x ``--scale``), then drives the six families exactly as
the whole script does after phase 6: deepseek-moe-16b, hymba-1.5b,
mamba2-130m, phi-3-vision-4.2b and whisper-large-v3 at full width and
depth, llama4-scout-17b-a16e at full width and 4 layers, and 20 training
steps of mamba2-130m. Prints the card's name and power limit, then phase
11's JSON lines; exits non-zero when a check fails or there is no card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="context database scale, as chip_smoke.py's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase11: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build, ops, ref
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = chip_smoke.peaks_of(name)
    (ROOT / "build").mkdir(exist_ok=True)
    _build.library()
    rag_db = chip_smoke.rag_database(args, chip_smoke.FAMILY_VOCAB)
    chip_smoke.phase11(torch, ops, ref, peaks, rag_db, smi,
                       {"flash_decode": {}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
