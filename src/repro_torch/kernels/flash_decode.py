"""ctypes launch wrapper of the GQA flash-decode kernel
(``csrc/flash_decode.cu``), kernel 10 of the port.

CUDA tensors only (``ops.py`` routes CPU tensors to ``ref.py``): the wrapper
checks device, type, shape and contiguity, allocates the output with
``torch.empty``, launches on the current stream, raises on a non-zero
``cudaError_t`` and counts its launches in :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .scoped_topk import _check, _ptr, count_launch

MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_decode": 0}


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """q (b, h, d); k, v (b, kv, s, d) of q's type (fp32 or bf16); mask
    (b, s) int8, non-zero = admitted -> (b, h, d) in q's type."""
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_decode takes fp32 or bf16, got {q.dtype}")
    _check(q, "q", q.dtype, 3, dev)
    _check(k, "k", q.dtype, 4, dev)
    _check(v, "v", q.dtype, 4, dev)
    _check(mask, "mask", torch.int8, 2, dev)
    b, h, d = q.shape
    kb, kv, s, kd = k.shape
    if (kb, kd) != (b, d) or v.shape != k.shape or \
            tuple(mask.shape) != (b, s):
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if kv < 1 or h % kv != 0:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"head dim {d} outside 1..{MAX_D}")
    if s < 1:
        raise ValueError("empty cache")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_flash_decode(
            DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out),
            b, h, kv, s, d, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"flash_decode launch failed: cudaError_t {rc} (1 = invalid "
            f"value: group {h // kv} at d = {d} needs more shared memory "
            f"than one block may have)")
    count_launch(launches, "flash_decode")
    return out
