"""ctypes launch wrappers of the packed-mask kernels (``csrc/bitmap_ops.cu``):
``bitmap_patch`` and ``mask_and_popcount``.

Packed words travel as ``torch.int32`` views of the uint32 bits. CUDA
tensors only (``ops.py`` routes CPU tensors to ``ref.py``); each wrapper
checks its inputs, allocates outputs and scratch with ``torch.empty``,
launches on the current stream, raises on a non-zero ``cudaError_t`` and
counts its launches in :data:`launches`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .scoped_topk import _check, _ptr, count_launch

THREADS = 256
MAX_BLOCKS = 1024      # grid-stride cap: enough blocks to fill 132 SMs

launches = {"bitmap_patch": 0, "mask_and_popcount": 0}


def _blocks_for(n_words: int) -> int:
    return max(1, min(MAX_BLOCKS, -(-n_words // THREADS)))


def bitmap_patch(masks: torch.Tensor, delta: torch.Tensor,
                 ops: torch.Tensor) -> torch.Tensor:
    """masks (R, W) int32; delta (W,) int32; ops (R,) int32 -> (R, W):
    ``m | delta`` (op > 0), ``m & ~delta`` (op < 0), ``m`` (op == 0)."""
    dev = masks.device
    _check(masks, "masks", torch.int32, 2, dev)
    _check(delta, "delta", torch.int32, 1, dev)
    _check(ops, "ops", torch.int32, 1, dev)
    n_rows, n_words = masks.shape
    if delta.shape[0] != n_words or ops.shape[0] != n_rows:
        raise ValueError(f"delta {tuple(delta.shape)} / ops "
                         f"{tuple(ops.shape)} do not fit masks "
                         f"{tuple(masks.shape)}")
    if n_rows > 65535:
        raise ValueError(f"{n_rows} mask rows exceed the grid.y limit")
    out = torch.empty_like(masks)
    if n_rows == 0 or n_words == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_bitmap_patch(
            _ptr(masks), _ptr(delta), _ptr(ops), _ptr(out), n_rows, n_words,
            _blocks_for(n_words), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"bitmap_patch launch failed: cudaError_t {rc}")
    count_launch(launches, "bitmap_patch")
    return out


def mask_and_popcount(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b (W,) int32 -> (a & b (W,) int32, total popcount 0-d int32)."""
    dev = a.device
    _check(a, "a", torch.int32, 1, dev)
    _check(b, "b", torch.int32, 1, dev)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    n_words = a.shape[0]
    n_blocks = _blocks_for(n_words)
    out = torch.empty_like(a)
    partials = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_mask_and_popcount(
            _ptr(a), _ptr(b), _ptr(out), n_words, n_blocks, _ptr(partials),
            _ptr(count), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"mask_and_popcount launch failed: cudaError_t {rc}")
    count_launch(launches, "mask_and_popcount")
    return out, count
