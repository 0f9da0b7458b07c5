#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 10 (training on the card) alone.

    python3 tools/phase10.py

The full-width ``qwen3-0.6b`` in bf16 trained by ``launch/train.py``'s loop
for 20 steps at 8 x 512 tokens, a checkpoint restored into a fresh model
and resumed, one ``accum_steps=2`` step and one profiled step, exactly as
the whole script runs it after phase 6 (~1 min on one H100, no kernel
build: the training path launches none of the port's CUDA kernels).
Prints the card's name and power limit, then phase 10's JSON line; exits
non-zero when a check fails or there is no card.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    # phase 10 runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's fixed workspace chosen before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("phase10: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    chip_smoke.phase10(torch, ops, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
