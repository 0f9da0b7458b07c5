"""ctypes launch wrappers of the masked scan + top-k kernels
(``csrc/scoped_topk.cu``): ``scoped_topk`` and ``multi_scope_topk``.

They take CUDA tensors only (``ops.py`` routes CPU tensors to ``ref.py``),
check what the kernel cannot take, allocate outputs and scratch with
``torch.empty``, launch on the current stream, raise on a non-zero
``cudaError_t``, and count their launches in :data:`launches`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build

MAX_K = 256            # the kernel's per-query top-k list (shared memory)
MAX_BLOCK_Q = 8        # queries per block = warps per block
THREADS = 256
SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use
_BLOCKS_PER_SM = 4     # target pass-1 blocks per SM when block_n is auto

launches = {"scoped_topk": 0, "multi_scope_topk": 0}
_count_lock = threading.Lock()     # DSM worker threads launch kernels too


def count_launch(table: dict, name: str) -> None:
    with _count_lock:
        table[name] += 1


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, expected {device} (cuda)")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} has {t.ndim} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _geometry(nq: int, n: int, d: int, k: int, block_q: int,
              block_n: Optional[int], device: torch.device
              ) -> Tuple[int, int, int]:
    """(query tile, rows per chunk, chunks) for pass 1."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range [1, {MAX_K}]")
    if not 1 <= block_q <= MAX_BLOCK_Q:
        raise ValueError(f"block_q={block_q} outside [1, {MAX_BLOCK_Q}]")
    smem = 4 * (block_q * d + block_q * THREADS + 2 * block_q * k + block_q)
    if smem > SMEM_LIMIT:
        raise ValueError(f"d={d}, k={k}, block_q={block_q} need {smem} B of "
                         f"shared memory (> {SMEM_LIMIT})")
    if block_n is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        chunks = max(1, _ceil(_BLOCKS_PER_SM * sms, _ceil(nq, block_q)))
        block_n = _ceil(max(n, 1), chunks)
    # whole words per chunk, and at most 65535 chunks (the grid.y limit)
    block_n = 32 * _ceil(max(block_n, _ceil(n, 65535)), 32)
    return block_q, block_n, max(1, _ceil(n, block_n))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _launch(name: str, fn, queries: torch.Tensor, rows: torch.Tensor,
            sq: Optional[torch.Tensor], mask_args, k: int, metric: str,
            block_q: int, block_n: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = queries.device
    _check(queries, "queries", torch.float32, 2, dev)
    _check(rows, "rows", torch.float32, 2, dev)
    nq, d = queries.shape
    n = rows.shape[0]
    if rows.shape[1] != d:
        raise ValueError(f"rows have d={rows.shape[1]}, queries d={d}")
    if metric not in ("ip", "cos", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    l2 = metric == "l2"
    if l2:
        _check(sq, "sq", torch.float32, 1, dev)
        if sq.shape[0] < n:
            raise ValueError(f"sq has {sq.shape[0]} norms for {n} rows")
    qt, chunk_rows, n_chunks = _geometry(nq, n, d, k, block_q, block_n, dev)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_i
    part_v = torch.empty((nq, n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, n_chunks, k), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(
            _ptr(queries), _ptr(rows), _ptr(sq if l2 else None), *mask_args,
            nq, n, d, k, int(l2), qt, chunk_rows, n_chunks, _ptr(part_v),
            _ptr(part_i), _ptr(out_v), _ptr(out_i), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    count_launch(launches, name)
    return out_v, out_i


def scoped_topk(queries: torch.Tensor, rows: torch.Tensor,
                mask: torch.Tensor, k: int, metric: str = "ip",
                sq: Optional[torch.Tensor] = None, block_q: int = 8,
                block_n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (q, d) f32; rows (n, d) f32; mask (n,) int8 (non-zero admits
    the row); sq (n,) f32 squared norms, read for l2 only. Returns
    (vals (q, k) f32, ids (q, k) int32), ``finfo.min`` / -1 when empty."""
    _check(mask, "mask", torch.int8, 1, queries.device)
    if mask.shape[0] != rows.shape[0]:
        raise ValueError(f"mask has {mask.shape[0]} lanes for "
                         f"{rows.shape[0]} rows")
    return _launch("scoped_topk", "repro_scoped_topk_f32", queries, rows, sq,
                   (_ptr(mask),), k, metric, block_q, block_n)


def multi_scope_topk(queries: torch.Tensor, rows: torch.Tensor,
                     mask_words: torch.Tensor, scope_ids: torch.Tensor,
                     k: int, metric: str = "ip",
                     sq: Optional[torch.Tensor] = None, block_q: int = 8,
                     block_n: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """As :func:`scoped_topk`, with query i admitting row r where bit r%32 of
    ``mask_words[scope_ids[i], r // 32]`` is set. mask_words (S, W) int32
    view of the packed uint32 words, W >= ceil(n/32); scope_ids (q,) int32
    (an id outside [0, S) admits nothing)."""
    dev = queries.device
    _check(mask_words, "mask_words", torch.int32, 2, dev)
    _check(scope_ids, "scope_ids", torch.int32, 1, dev)
    n_scopes, n_words = mask_words.shape
    if n_words * 32 < rows.shape[0]:
        raise ValueError(f"{n_words} mask words cover fewer than "
                         f"{rows.shape[0]} rows")
    if scope_ids.shape[0] != queries.shape[0]:
        raise ValueError(f"{scope_ids.shape[0]} scope ids for "
                         f"{queries.shape[0]} queries")
    return _launch("multi_scope_topk", "repro_multi_scope_topk_f32", queries,
                   rows, sq, (_ptr(mask_words), _ptr(scope_ids), n_scopes,
                              n_words), k, metric, block_q, block_n)
