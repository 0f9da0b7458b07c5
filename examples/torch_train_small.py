"""Train a small LM for a few hundred steps with checkpoint-restart, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_train_small.py          # card, smoke
    PYTHONPATH=src python examples/torch_train_small.py --full   # mamba2-130m
    PYTHONPATH=src python examples/torch_train_small.py --device cpu --steps 5

(Thin wrapper over repro_torch.launch.train so the example and the launcher
share one code path; later arguments override the defaults, and the
checkpoints go to build/torch_ckpt unless --ckpt-dir names another
directory.)
"""
import sys
from pathlib import Path

from repro_torch.launch import train

CKPT = Path(__file__).resolve().parents[1] / "build" / "torch_ckpt"

if __name__ == "__main__":
    full = "--full" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--full"]
    defaults = (["--arch", "mamba2-130m", "--steps", "300", "--batch", "8",
                 "--seq", "512"] if full else
                ["--arch", "mamba2-130m", "--smoke", "--steps", "200",
                 "--batch", "8", "--seq", "128"])
    train.main(defaults + ["--ckpt-dir", str(CKPT), "--log-every", "20"]
               + argv)
