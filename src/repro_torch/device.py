"""Device selection and the fp32 numerics contract of the port.

fp32 scores must be plain IEEE fp32: TF32 keeps ~3 decimal digits and would
move fp32 ids away from the reference, so both TF32 switches are pinned off
when this module is imported (every device-holding module imports it).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises: the
    port never carries on silently on the CPU; pass ``device="cpu"`` to run
    the plain PyTorch versions there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
