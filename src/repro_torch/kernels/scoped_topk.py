"""ctypes launch wrappers of the masked scan + top-k kernels
(``csrc/scoped_topk.cu``): the fp32, int8 and PQ scans, each with one dense
mask (``scoped_topk*``), packed per-query scope masks
(``multi_scope_topk*``), or packed scope masks over each query's own
gathered IVF candidates (``ivf_gather_topk*``).

They take CUDA tensors only (``ops.py`` routes CPU tensors to ``ref.py``),
check what the kernel cannot take, allocate outputs and scratch with
``torch.empty``, launch on the current stream, raise on a non-zero
``cudaError_t``, and count their launches in :data:`launches`. Any k >= 1
and any depth (d, or M for PQ) are taken. Which pass 1 runs:

* the scans with scope words (:data:`TILED`: ``multi_scope_topk``,
  ``multi_scope_topk_i8``, ``multi_scope_topk_pq``) run the tiled passes
  (query tiles of up to 64 fp32 / int8 or 8 PQ queries, rows staged through
  a shared-memory ring; :func:`tiled_plan` asks the C entry for the tile,
  :func:`tiled_geometry` sizes the grid);
* the fp32 dense-mask scan (``scoped_topk``) runs the streaming pass
  (query tiles of up to 8; :func:`stream_plan`, :func:`stream_geometry`);
* the int8 and PQ dense-mask scans and the gathered scans run the per-row
  pass 1, whose query tile (<= 8), list placement and depth slice
  :func:`geometry` picks.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

MAX_BLOCK_Q = 8        # per-row pass 1: queries per block = warps per block
THREADS = 256
SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use
LIST_SMEM = 64 * 1024  # shared memory a block's top-k lists may take
_BLOCKS_PER_SM = 4     # target pass-1 blocks per SM when block_n is auto

KINDS = {"f32": 0, "i8": 1, "pq": 2}
# bytes one depth element of one query takes when staged, and the depth
# granularity that keeps the kernel's wide loads aligned
_DEPTH_BYTES = {"f32": 4, "i8": 1, "pq": 256 * 4}
_DEPTH_UNIT = {"f32": 4, "i8": 16, "pq": 4}

# the tiled passes (scan_pass1_tiled, scan_pass1_pq): largest query tile
# asked for (the PQ plan takes at most 8), rows per row tile
TILE_Q = 64
TILE_R = {"f32": 256, "i8": 128, "pq": 512}
TILED = ("multi_scope_topk", "multi_scope_topk_i8", "multi_scope_topk_pq")
# the streaming pass 1 of the fp32 dense scan (scan_pass1_stream): largest
# query tile, rows per row tile
STREAM_Q = 8
STREAM_ROWS = 128

launches = {name: 0 for name in (
    "scoped_topk", "multi_scope_topk", "scoped_topk_i8",
    "multi_scope_topk_i8", "scoped_topk_pq", "multi_scope_topk_pq",
    "ivf_gather_topk", "ivf_gather_topk_i8", "ivf_gather_topk_pq")}
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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class Geometry(NamedTuple):
    qt: int            # query tile (queries per block)
    slice: int         # depth staged at once (== depth: staged once)
    smem_lists: bool   # top-k lists in shared memory (else device memory)
    chunk_rows: int    # rows one block sweeps
    n_chunks: int


def smem_bytes(kind: str, qt: int, slice_: int, k: int,
               smem_lists: bool) -> int:
    """Pass-1 shared memory, as ``pass1_smem`` in the CUDA source."""
    q = _ceil(qt * slice_ * _DEPTH_BYTES[kind], 16) * 16
    return q + qt * (THREADS * 4 + 4) + (qt * k * 8 if smem_lists else 0)


def geometry(kind: str, nq: int, n: int, depth: int, k: int, block_q: int,
             block_n: Optional[int], sms: int = 132) -> Geometry:
    """Pass-1 launch shape for any k >= 1 and depth >= 1.

    The query tile starts at ``min(block_q, nq)``. Top-k lists stay in
    shared memory while the tile's lists fit ``LIST_SMEM`` (the tile
    shrinks for large k) and move to their partial slots in device memory
    past ``k * 8 > LIST_SMEM``. The query side is staged whole when it
    fits; PQ first shrinks the tile to fit whole LUTs, since re-staging a
    LUT slice every 256 rows would cost more bytes than the codes. What
    still does not fit is staged in slices of the depth."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if depth < 1:
        raise ValueError(f"depth={depth} must be >= 1")
    if not 1 <= block_q <= MAX_BLOCK_Q:
        raise ValueError(f"block_q={block_q} outside [1, {MAX_BLOCK_Q}]")
    qt = max(1, min(block_q, nq))
    smem_lists = k * 8 <= LIST_SMEM
    if smem_lists:
        qt = max(1, min(qt, LIST_SMEM // (k * 8)))
    per = _DEPTH_BYTES[kind]

    def room(qt: int) -> int:
        return SMEM_LIMIT - smem_bytes(kind, qt, 0, k, smem_lists) - 16

    if kind == "pq":
        while qt > 1 and qt * depth * per > room(qt):
            qt -= 1
    fit = room(qt) // (qt * per)
    unit = _DEPTH_UNIT[kind]
    slice_ = depth if fit >= depth else max(1, fit // unit * unit)
    if block_n is None:
        chunks = max(1, _ceil(_BLOCKS_PER_SM * sms, _ceil(max(nq, 1), qt)))
        block_n = max(_ceil(max(n, 1), chunks), k)
    # whole words per chunk, and at most 65535 chunks (the grid.y limit)
    block_n = 32 * _ceil(max(block_n, _ceil(n, 65535)), 32)
    return Geometry(qt, slice_, smem_lists, block_n,
                    max(1, _ceil(n, block_n)))


class TiledGeometry(NamedTuple):
    qt: int            # query tile (<= 64)
    chunk_rows: int    # rows one block sweeps (a multiple of 32)
    n_chunks: int


@functools.lru_cache(maxsize=256)
def tiled_plan(kind: str, qt_cap: int, depth: int, k: int) -> Tuple[int, int]:
    """The C entry's plan for the tiled pass 1 (``tiled_plan`` in the CUDA
    source, which alone holds its shared-memory layout): the query tile for
    a cap of ``qt_cap`` (halved while its top-k lists do not fit shared
    memory) and the dynamic shared memory of a block, 0 when nothing fits.
    Builds the library; plans are remembered (they depend on the arguments
    alone)."""
    qt = ctypes.c_int(0)
    smem = _build.library().repro_tiled_plan(KINDS[kind], qt_cap, depth, k,
                                             ctypes.byref(qt))
    return qt.value, smem


def tiled_geometry(kind: str, nq: int, n: int, k: int, qt: int,
                   block_n: Optional[int], sms: int = 132) -> TiledGeometry:
    """Grid of the tiled passes for the query tile ``qt`` that
    :func:`tiled_plan` gave: ``block_n`` (default: at most one block per SM
    in all, so the grid is one wave, and at least k rows and one row tile
    each) is rounded up to whole mask words and to at most 65535
    chunks."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if not 1 <= qt <= TILE_Q:
        raise ValueError(f"qt={qt} outside [1, {TILE_Q}]")
    if block_n is None:
        chunks = max(1, sms // _ceil(max(nq, 1), qt))
        block_n = max(_ceil(max(n, 1), chunks), k, TILE_R[kind])
    block_n = 32 * _ceil(max(block_n, _ceil(n, 65535)), 32)
    return TiledGeometry(qt, block_n, max(1, _ceil(n, block_n)))


class StreamPlan(NamedTuple):
    qt: int            # query tile (<= 8)
    lists: int         # partial lists per chunk: 1, or one per warp (4)
    blocks: int        # blocks one SM holds (1 to 4)
    smem: int          # dynamic shared memory of a block


@functools.lru_cache(maxsize=256)
def stream_plan(qt_cap: int, depth: int, k: int) -> StreamPlan:
    """The C entry's plan for the streaming pass 1 of ``scoped_topk``
    (``stream_plan`` in the CUDA source, which alone holds its layout): the
    largest query tile up to ``qt_cap`` whose per-warp lists fit shared
    memory beside the ring (else the lists go to device memory, one partial
    per warp), and how many blocks an SM holds. Builds the library; plans
    are remembered."""
    if not 1 <= qt_cap <= STREAM_Q:
        raise ValueError(f"qt_cap={qt_cap} outside [1, {STREAM_Q}]")
    qt, lists, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    smem = _build.library().repro_stream_plan(
        qt_cap, depth, k, ctypes.byref(qt), ctypes.byref(lists),
        ctypes.byref(blocks))
    return StreamPlan(qt.value, lists.value, blocks.value, smem)


def stream_geometry(nq: int, n: int, qt: int, blocks: int,
                    block_n: Optional[int], sms: int = 132) -> TiledGeometry:
    """Grid of the streaming pass 1 for the plan's query tile ``qt`` and
    ``blocks`` per SM: ``block_n`` (default: the rows split over one wave of
    ``sms * blocks`` blocks, in whole 128-row tiles) is rounded up to whole
    mask words and to at most 65535 chunks. A launch of a few thousand
    rows (a gather plan's) gets one tile per block."""
    if not 1 <= qt <= STREAM_Q:
        raise ValueError(f"qt={qt} outside [1, {STREAM_Q}]")
    if blocks < 1:
        raise ValueError(f"blocks={blocks} must be >= 1")
    if block_n is None:
        chunks = max(1, (sms * blocks) // _ceil(max(nq, 1), qt))
        block_n = STREAM_ROWS * _ceil(_ceil(max(n, 1), chunks), STREAM_ROWS)
    block_n = 32 * _ceil(max(block_n, _ceil(n, 65535)), 32)
    return TiledGeometry(qt, block_n, max(1, _ceil(n, block_n)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cand(cand: torch.Tensor, nq: int, n: int,
                device: torch.device, check_ids: bool) -> int:
    """Gathered mode's (nq, C) int32 candidate ids: C >= 1 and, with
    ``check_ids``, every id in [-1, n) (a reduction over the ids and a
    device-to-host read; a caller whose ids come from an already checked
    table passes False). Returns C."""
    _check(cand, "cand_ids", torch.int32, 2, device)
    if cand.shape[0] != nq:
        raise ValueError(f"{cand.shape[0]} candidate rows for {nq} queries")
    if cand.shape[1] < 1:
        raise ValueError("cand_ids has no candidate column (C = 0)")
    if check_ids and cand.numel():
        lo, hi = (int(v) for v in torch.aminmax(cand))
        if lo < -1 or hi >= n:
            raise ValueError(f"cand_ids in [{lo}, {hi}], outside [-1, {n})")
    return cand.shape[1]


def _launch(name: str, kind: str, q: torch.Tensor, q_scale, rows: torch.Tensor,
            row_scale, sq, mask, words, sids, depth: int, k: int, l2: bool,
            block_q: int, block_n: Optional[int], cand=None,
            check_ids: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared launch of every scan. The wrappers named in :data:`TILED` run
    the tiled passes, ``scoped_topk`` the streaming pass 1, the others the
    per-row pass 1. With ``cand`` (gathered mode) the sweep runs over
    each query's C candidate positions instead of the n rows, one query per
    block (``block_q`` 1)."""
    dev = q.device
    nq, n = q.shape[0], rows.shape[0]
    sweep = n if cand is None else _check_cand(cand, nq, n, dev, check_ids)
    if l2:
        _check(sq, "sq", torch.float32, 1, dev)
        if sq.shape[0] < n:
            raise ValueError(f"sq has {sq.shape[0]} norms for {n} rows")
    if words is not None:
        _check(words, "mask_words", torch.int32, 2, dev)
        _check(sids, "scope_ids", torch.int32, 1, dev)
        if words.shape[1] * 32 < n:
            raise ValueError(f"{words.shape[1]} mask words cover fewer than "
                             f"{n} rows")
        if sids.shape[0] != nq:
            raise ValueError(f"{sids.shape[0]} scope ids for {nq} queries")
        n_scopes, n_words = words.shape
    else:
        _check(mask, "mask", torch.int8, 1, dev)
        if mask.shape[0] != n:
            raise ValueError(f"mask has {mask.shape[0]} lanes for {n} rows")
        n_scopes = n_words = 0
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    tiled = name in TILED
    streaming = name == "scoped_topk"
    lists = 1                          # partial lists per chunk
    if streaming:
        if block_q < 1:
            raise ValueError(f"block_q={block_q} must be >= 1")
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        plan = stream_plan(max(1, min(block_q, nq, STREAM_Q)), depth, k)
        geo = stream_geometry(nq, n, plan.qt, plan.blocks, block_n, sms)
        lists = plan.lists
    elif tiled:
        if block_q < 1:
            raise ValueError(f"block_q={block_q} must be >= 1")
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        qt, smem = tiled_plan(kind, max(1, min(block_q, nq, TILE_Q)), depth,
                              k)
        if smem == 0:
            raise ValueError(f"no tiled plan fits shared memory: {name} "
                             f"depth={depth} k={k}")
        geo = tiled_geometry(kind, nq, n, k, qt, block_n, sms)
    else:
        geo = geometry(kind, nq, sweep, depth, k, block_q, block_n, sms)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_i
    part_v = torch.empty((nq, geo.n_chunks * lists, k),
                         dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, geo.n_chunks * lists, k), dtype=torch.int32,
                         device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        cuda_stream = ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream)
        if streaming:
            rc = lib.repro_scan_topk_stream(
                _ptr(q), _ptr(rows), _ptr(sq if l2 else None), _ptr(mask),
                nq, n, depth, k, int(l2), geo.qt, geo.chunk_rows,
                geo.n_chunks, _ptr(part_v), _ptr(part_i), _ptr(out_v),
                _ptr(out_i), cuda_stream)
        elif tiled:
            rc = lib.repro_scan_topk_tiled(
                KINDS[kind], _ptr(q), _ptr(q_scale), _ptr(rows),
                _ptr(row_scale), _ptr(sq if l2 else None), _ptr(words),
                _ptr(sids), n_scopes, n_words, nq, n, depth, k, int(l2),
                geo.qt, geo.chunk_rows, geo.n_chunks, _ptr(part_v),
                _ptr(part_i), _ptr(out_v), _ptr(out_i), cuda_stream)
        else:
            rc = lib.repro_scan_topk(
                KINDS[kind], _ptr(q), _ptr(q_scale), _ptr(rows),
                _ptr(row_scale), _ptr(sq if l2 else None), _ptr(mask),
                _ptr(words), _ptr(sids), _ptr(cand), n_scopes, n_words, nq,
                sweep, depth, geo.slice, k, int(l2), geo.qt, geo.chunk_rows,
                geo.n_chunks, int(geo.smem_lists), _ptr(part_v),
                _ptr(part_i), _ptr(out_v), _ptr(out_i), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    count_launch(launches, name)
    return out_v, out_i


def _metric_l2(metric: str) -> bool:
    if metric not in ("ip", "cos", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    return metric == "l2"


def _f32(queries, rows):
    dev = queries.device
    _check(queries, "queries", torch.float32, 2, dev)
    _check(rows, "rows", torch.float32, 2, dev)
    if rows.shape[1] != queries.shape[1]:
        raise ValueError(f"rows have d={rows.shape[1]}, queries "
                         f"d={queries.shape[1]}")
    return queries.shape[1]


def _i8(q_i8, q_scale, rows_i8, row_scale):
    dev = q_i8.device
    _check(q_i8, "q_i8", torch.int8, 2, dev)
    _check(rows_i8, "rows_i8", torch.int8, 2, dev)
    _check(q_scale, "q_scale", torch.float32, 1, dev)
    _check(row_scale, "row_scale", torch.float32, 1, dev)
    if rows_i8.shape[1] != q_i8.shape[1]:
        raise ValueError(f"codes have d={rows_i8.shape[1]}, queries "
                         f"d={q_i8.shape[1]}")
    if q_scale.shape[0] != q_i8.shape[0] or \
            row_scale.shape[0] < rows_i8.shape[0]:
        raise ValueError("one scale per query and per row")
    return q_i8.shape[1]


def _pq(lut, codes):
    dev = lut.device
    _check(lut, "lut", torch.float32, 3, dev)
    _check(codes, "codes", torch.uint8, 2, dev)
    if lut.shape[2] != 256 or lut.shape[1] != codes.shape[1]:
        raise ValueError(f"lut {tuple(lut.shape)} does not fit codes "
                         f"{tuple(codes.shape)}")
    return codes.shape[1]


def scoped_topk(queries, rows, mask, k, metric="ip", sq=None, block_q=8,
                block_n=None):
    """queries (q, d) f32; rows (n, d) f32; mask (n,) int8 (non-zero admits
    the row); sq (n,) f32 squared norms, read for l2 only. Returns
    (vals (q, k) f32, ids (q, k) int32), ``finfo.min`` / -1 when empty."""
    d = _f32(queries, rows)
    return _launch("scoped_topk", "f32", queries, None, rows, None, sq, mask,
                   None, None, d, k, _metric_l2(metric), block_q, block_n)


def multi_scope_topk(queries, rows, mask_words, scope_ids, k, metric="ip",
                     sq=None, block_q=TILE_Q, block_n=None):
    """As :func:`scoped_topk`, with query i admitting row r where bit r%32 of
    ``mask_words[scope_ids[i], r // 32]`` is set. mask_words (S, W) int32
    view of the packed uint32 words, W >= ceil(n/32); scope_ids (q,) int32
    (an id outside [0, S) admits nothing)."""
    d = _f32(queries, rows)
    return _launch("multi_scope_topk", "f32", queries, None, rows, None, sq,
                   None, mask_words, scope_ids, d, k, _metric_l2(metric),
                   block_q, block_n)


def scoped_topk_i8(q_i8, q_scale, rows_i8, row_scale, sq, mask, k,
                   metric="ip", block_q=8, block_n=None):
    """int8 scan: q_i8 (q, d) int8 with q_scale (q,) f32; rows_i8 (n, d)
    int8 with row_scale (n,) f32; sq (n,) f32 dequantized squared norms
    (l2 only); mask (n,) int8."""
    d = _i8(q_i8, q_scale, rows_i8, row_scale)
    return _launch("scoped_topk_i8", "i8", q_i8, q_scale, rows_i8, row_scale,
                   sq, mask, None, None, d, k, _metric_l2(metric), block_q,
                   block_n)


def multi_scope_topk_i8(q_i8, q_scale, rows_i8, row_scale, sq, mask_words,
                        scope_ids, k, metric="ip", block_q=TILE_Q,
                        block_n=None):
    """int8 scan with packed per-query scope masks."""
    d = _i8(q_i8, q_scale, rows_i8, row_scale)
    return _launch("multi_scope_topk_i8", "i8", q_i8, q_scale, rows_i8,
                   row_scale, sq, None, mask_words, scope_ids, d, k,
                   _metric_l2(metric), block_q, block_n)


def scoped_topk_pq(lut, codes, mask, k, block_q=8, block_n=None):
    """PQ/ADC scan: lut (q, M, 256) f32 (metric folded in); codes (n, M)
    uint8; mask (n,) int8."""
    m = _pq(lut, codes)
    return _launch("scoped_topk_pq", "pq", lut, None, codes, None, None,
                   mask, None, None, m, k, False, block_q, block_n)


def multi_scope_topk_pq(lut, codes, mask_words, scope_ids, k,
                        block_q=TILE_Q, block_n=None):
    """PQ/ADC scan with packed per-query scope masks."""
    m = _pq(lut, codes)
    return _launch("multi_scope_topk_pq", "pq", lut, None, codes, None, None,
                   None, mask_words, scope_ids, m, k, False, block_q,
                   block_n)


def ivf_gather_topk(queries, rows, cand_ids, mask_words, scope_ids, k,
                    metric="ip", sq=None, check_ids=True):
    """Gathered fp32 scan of the IVF executor: query b scores store rows
    ``cand_ids[b, c]`` (cand_ids (B, C) int32, -1 = padding) of rows (n, d)
    f32 that bit r%32 of ``mask_words[scope_ids[b], r // 32]`` admits.
    Returns (vals (B, k) f32, ids (B, k) int32 store ids), ties ranked by
    the lower candidate position. ``check_ids=False`` skips the range check
    of the ids (the IVF executor's come from its checked CSR layout)."""
    d = _f32(queries, rows)
    return _launch("ivf_gather_topk", "f32", queries, None, rows, None, sq,
                   None, mask_words, scope_ids, d, k, _metric_l2(metric), 1,
                   None, cand=cand_ids, check_ids=check_ids)


def ivf_gather_topk_i8(q_i8, q_scale, rows_i8, row_scale, sq, cand_ids,
                       mask_words, scope_ids, k, metric="ip", check_ids=True):
    """int8 twin of :func:`ivf_gather_topk` (scores as
    :func:`scoped_topk_i8`)."""
    d = _i8(q_i8, q_scale, rows_i8, row_scale)
    return _launch("ivf_gather_topk_i8", "i8", q_i8, q_scale, rows_i8,
                   row_scale, sq, None, mask_words, scope_ids, d, k,
                   _metric_l2(metric), 1, None, cand=cand_ids,
                   check_ids=check_ids)


def ivf_gather_topk_pq(lut, codes, cand_ids, mask_words, scope_ids, k,
                       check_ids=True):
    """PQ/ADC twin of :func:`ivf_gather_topk` (scores as
    :func:`scoped_topk_pq`)."""
    m = _pq(lut, codes)
    return _launch("ivf_gather_topk_pq", "pq", lut, None, codes, None, None,
                   None, mask_words, scope_ids, m, k, False, 1, None,
                   cand=cand_ids, check_ids=check_ids)
