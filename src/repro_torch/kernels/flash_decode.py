"""ctypes launch wrapper of the GQA flash-decode kernel
(``csrc/flash_decode.cu``), kernel 10 of the port.

CUDA tensors only (``ops.py`` routes CPU tensors to ``ref.py``): the wrapper
checks device, type, shape and contiguity, allocates the output (and, when
the cache is split, the partials' workspace) with ``torch.empty``, launches
on the current stream, raises on a non-zero ``cudaError_t`` and counts its
launches in :data:`launches` (one a call, the combine of the splits
included).

The cache is split across blocks by :func:`split_plan` (a pure function of
the shapes and the card's SM count, so two calls on the same inputs launch
the same grid and give the same bits); :func:`split_ranges` is the span of
each split, the formula the kernel's ``split_span`` computes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _build
from .scoped_topk import _check, count_launch

MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TILE = 64     # positions of the unit a split owns
MMA_ROWS = 16       # query rows of one bf16 block (a larger group is sliced)
MAX_SPLIT = 65535   # the grid's y extent
BLOCKS_PER_SM = 2   # the split fills the card with this many blocks an SM

launches = {"flash_decode": 0}

_entry = None                 # the C entry, argtypes set (first launch)
_sm_count = {}                # device index -> SMs


def split_plan(b: int, kv: int, s: int, group: int, dtype: torch.dtype,
               sm_count: int) -> int:
    """Splits of the cache for one call: as many as keep the (b, kv
    head[, 16-row group slice]) blocks within one wave of
    :data:`BLOCKS_PER_SM` on every SM, at most one per 64-position tile;
    1 when b * kv blocks fill more than half that wave already. (A second,
    partial wave of short blocks costs more than it spreads: at b * kv = 8
    and 32,768 positions, 33 splits beat 48 and 66 on an H100; ``PERF.md``
    section 6, ``tools/flash_variants.py``.) The head dim does not enter:
    it sets a block's bytes, not how many blocks fill the card."""
    slices = -(-group // MMA_ROWS) if dtype == torch.bfloat16 else 1
    blocks = b * kv * slices
    fit = BLOCKS_PER_SM * sm_count // blocks
    return max(1, min(fit, -(-s // SPLIT_TILE), MAX_SPLIT))


def split_ranges(s: int, n_split: int) -> List[Tuple[int, int]]:
    """[start, stop) positions of each split: whole 64-position tiles
    ``[tiles * i // n_split, tiles * (i + 1) // n_split)``, the last cut at
    s (empty where n_split exceeds the tiles)."""
    tiles = -(-s // SPLIT_TILE)
    spans = []
    for i in range(n_split):
        t0, t1 = tiles * i // n_split, tiles * (i + 1) // n_split
        spans.append((min(t0 * SPLIT_TILE, s), min(t1 * SPLIT_TILE, s)))
    return spans


def _launcher():
    global _entry
    if _entry is None:
        _entry = _build.library().repro_flash_decode
    return _entry


def _sms(index: int) -> int:
    sms = _sm_count.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _sm_count[index] = sms
    return sms


def _fits(q, k, v, mask, index: int) -> bool:
    """Every check of the launch wrapper at once, without building device
    objects: CUDA tensors on one card, q's type (int8 mask), the ranks,
    contiguous."""
    return (index >= 0 and q.is_cuda
            and all(isinstance(t, torch.Tensor) for t in (k, v, mask))
            and k.dtype is q.dtype and v.dtype is q.dtype
            and mask.dtype is torch.int8
            and k.get_device() == index and v.get_device() == index
            and mask.get_device() == index
            and q.dim() == 3 and k.dim() == 4 and v.dim() == 4
            and mask.dim() == 2 and q.is_contiguous()
            and k.is_contiguous() and v.is_contiguous()
            and mask.is_contiguous())


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor,
                 n_split: Optional[int] = None) -> torch.Tensor:
    """q (b, h, d); k, v (b, kv, s, d) of q's type (fp32 or bf16); mask
    (b, s) int8, non-zero = admitted -> (b, h, d) in q's type. ``n_split``
    forces the number of cache splits (1 .. ceil(s / 64)); None takes
    :func:`split_plan`'s."""
    code = DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"flash_decode takes fp32 or bf16, got {q.dtype}")
    index = q.get_device()
    if not _fits(q, k, v, mask, index):      # say which check fails
        dev = q.device
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
    most = min(-(-s // SPLIT_TILE), MAX_SPLIT)
    if n_split is not None and not 1 <= n_split <= most:
        raise ValueError(f"n_split {n_split} outside 1..{most} (one split "
                         f"at most per {SPLIT_TILE}-position tile)")
    out = torch.empty_like(q)
    if b == 0:
        return out
    if n_split is None:
        n_split = split_plan(b, kv, s, h // kv, q.dtype, _sms(index))
    # the partials (m, l and acc of every split), alive until the launch
    ws = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device) if n_split > 1 else None
    # the current stream's handle without building a torch.cuda.Stream
    # (~6 us a call on an H100 host, against ~0.1 us); the C entry makes
    # q's device current for the launch
    rc = _launcher()(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), b, h, kv, s, d,
        n_split, index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(
            f"flash_decode launch failed: cudaError_t {rc} (1 = invalid "
            f"value: group {h // kv} at d = {d} needs more shared memory "
            f"than one block may have)")
    count_launch(launches, "flash_decode")
    return out
