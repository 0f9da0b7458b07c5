"""ctypes launch wrappers of the masked scan + top-k kernels
(``csrc/scoped_topk.cu``): the fp32, int8 and PQ scans, each with one dense
mask (``scoped_topk*``), packed per-query scope masks
(``multi_scope_topk*``), or packed scope masks over the IVF executor's
probed lists (kernel 9: ``ivf_probe_topk*``, and ``ivf_gather_topk*`` over
a (B, C) candidate matrix).

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
* the fp32, int8 and PQ dense-mask scans (:data:`STREAMED`:
  ``scoped_topk``, ``scoped_topk_i8``, ``scoped_topk_pq``) run the
  streaming pass (query tiles of up to 8; PQ's of one query whose LUT
  stays resident; :func:`stream_plan`, :func:`stream_geometry`, which gives
  a PQ chunk at least :data:`STREAM_PQ_ROWS` rows);
* kernel 9 runs the list form (:func:`list_plan`): the streaming pass
  (fp32, int8) or the PQ tiled pass in list mode, a block per (probed
  list's chunk, tile of up to 8 queries that probe the list). The wrapper
  inverts the probes on the device (a stable sort of the (query, slot)
  pairs by list, and each list's first pair). Both forms count their
  launches under the ``ivf_gather_topk*`` names: they are one kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use

KINDS = {"f32": 0, "i8": 1, "pq": 2}

# the tiled passes (scan_pass1_tiled, scan_pass1_pq): largest query tile
# asked for (the PQ plan takes at most 8), rows per row tile
TILE_Q = 64
TILE_R = {"f32": 256, "i8": 128, "pq": 512}
TILED = ("multi_scope_topk", "multi_scope_topk_i8", "multi_scope_topk_pq")
# the streaming pass 1 of the dense scans (scan_pass1_stream): largest
# query tile, rows per row tile, and the fewest rows of a PQ chunk (its
# block copies the tile's LUTs, qt x M KB, once: at M = 32 a 1,024-row
# chunk's codes are one LUT's bytes)
STREAMED = ("scoped_topk", "scoped_topk_i8", "scoped_topk_pq")
STREAM_Q = 8
STREAM_ROWS = 128
STREAM_PQ_ROWS = 1024
# kernel 9's list form: largest query tile of a list block
LIST_Q = 8

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
def stream_plan(qt_cap: int, depth: int, k: int,
                kind: str = "f32") -> StreamPlan:
    """The C entry's plan for the streaming pass 1 of ``scoped_topk``
    (``kind`` "f32"), ``scoped_topk_i8`` ("i8") or ``scoped_topk_pq``
    ("pq", ``depth`` = M) (``stream_plan`` in the CUDA source, which alone
    holds its layout): the largest query tile up to ``qt_cap`` (PQ: up to
    the C source's occupancy cap, with resident LUTs where they fit) whose
    per-warp lists fit shared memory beside the ring (else the lists go to
    device memory, one partial per warp), and how many blocks an SM holds;
    ``smem`` 0 when nothing fits. Builds the library; plans are
    remembered."""
    if not 1 <= qt_cap <= STREAM_Q:
        raise ValueError(f"qt_cap={qt_cap} outside [1, {STREAM_Q}]")
    if kind not in KINDS:
        raise ValueError(f"no streaming pass for kind {kind!r}")
    qt, lists, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    smem = _build.library().repro_stream_plan(
        KINDS[kind], qt_cap, depth, k, ctypes.byref(qt), ctypes.byref(lists),
        ctypes.byref(blocks))
    return StreamPlan(qt.value, lists.value, blocks.value, smem)


class ListPlan(NamedTuple):
    qt: int            # query tile of a list block (<= 8)
    lists: int         # partials per (probe slot, chunk): 1, or 4 per warp
    blocks: int        # blocks one SM holds
    chunk: int         # list positions one block scans
    smem: int          # dynamic shared memory of a block, 0: nothing fits


@functools.lru_cache(maxsize=256)
def list_plan(kind: str, qt_cap: int, depth: int, k: int) -> ListPlan:
    """The C entry's plan for kernel 9's list form (``list_plan`` in the
    CUDA source): the streaming pass's (fp32, int8) or the PQ tiled pass's
    with room for a chunk's compacted rows. Builds the library; plans are
    remembered."""
    if not 1 <= qt_cap <= LIST_Q:
        raise ValueError(f"qt_cap={qt_cap} outside [1, {LIST_Q}]")
    out = [ctypes.c_int(0) for _ in range(4)]
    smem = _build.library().repro_list_plan(
        KINDS[kind], qt_cap, depth, k, *map(ctypes.byref, out))
    return ListPlan(*(v.value for v in out), smem)


def list_grid(nq: int, n_lists: int, max_aligned: int, qt: int,
              chunk: int) -> Tuple[int, int, int]:
    """The list form's grid for the plan's query tile ``qt`` and ``chunk``:
    (query tiles per list, chunks of the widest list ``cmax``, blocks).
    A list is probed at most once per query, so by at most ``nq`` of them;
    blocks past a list's queries or its end return at once."""
    tiles = _ceil(max(nq, 1), qt)
    cmax = max(1, _ceil(max_aligned, chunk))
    return tiles, cmax, n_lists * tiles * cmax


def stream_geometry(nq: int, n: int, qt: int, blocks: int,
                    block_n: Optional[int], sms: int = 132,
                    min_rows: int = STREAM_ROWS) -> TiledGeometry:
    """Grid of the streaming pass 1 for the plan's query tile ``qt`` and
    ``blocks`` per SM: ``block_n`` (default: the rows split over one wave of
    ``sms * blocks`` blocks, in whole 128-row tiles and at least
    ``min_rows`` rows a chunk) is rounded up to whole mask words and to at
    most 65535 chunks. A launch of a few thousand rows (a gather plan's)
    gets one tile per block at fp32 and int8; PQ passes ``min_rows`` =
    :data:`STREAM_PQ_ROWS`, so its chunks' codes outweigh their blocks'
    LUT copies."""
    if not 1 <= qt <= STREAM_Q:
        raise ValueError(f"qt={qt} outside [1, {STREAM_Q}]")
    if blocks < 1:
        raise ValueError(f"blocks={blocks} must be >= 1")
    if min_rows < 1 or min_rows % STREAM_ROWS:
        raise ValueError(f"min_rows={min_rows} is not whole {STREAM_ROWS}-row "
                         f"tiles")
    if block_n is None:
        chunks = max(1, (sms * blocks) // _ceil(max(nq, 1), qt))
        block_n = max(min_rows, STREAM_ROWS * _ceil(_ceil(max(n, 1), chunks),
                                                    STREAM_ROWS))
    block_n = 32 * _ceil(max(block_n, _ceil(n, 65535)), 32)
    return TiledGeometry(qt, block_n, max(1, _ceil(n, block_n)))


def pass2_groups(nq: int, lists: int, sms: int = 132) -> int:
    """Blocks per query of pass 2's first level for ``lists`` partial lists
    a query (the streaming pass's): one (a single level) while the queries
    alone fill half the card or a query has fewer than 64 lists, else about
    32 lists a block, at most one wave."""
    if 2 * nq > sms or lists < 64:
        return 1
    return max(1, min(lists // 32, sms // nq))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_geometry(name: str, kind: str, nq: int, n: int, depth: int,
                    k: int, block_q: int, block_n: Optional[int],
                    sms: int = 132) -> Tuple[TiledGeometry, int]:
    """(grid, partial lists per chunk) of one launch of the dense-mask or
    scope-word scan ``name``: the plan the C entry gives for the query tile
    ``block_q`` asks for, and the geometry ``block_n`` (``None``: one
    wave) sizes. Builds the library; the calibration sweep reads the
    ``chunk_rows`` a default launch resolves to."""
    if block_q < 1:
        raise ValueError(f"block_q={block_q} must be >= 1")
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if name in STREAMED:
        plan = stream_plan(max(1, min(block_q, nq, STREAM_Q)), depth, k, kind)
        if plan.smem == 0:
            raise ValueError(f"no streaming plan fits shared memory: {name} "
                             f"depth={depth} k={k}")
        return stream_geometry(
            nq, n, plan.qt, plan.blocks, block_n, sms,
            STREAM_PQ_ROWS if kind == "pq" else STREAM_ROWS), plan.lists
    qt, smem = tiled_plan(kind, max(1, min(block_q, nq, TILE_Q)), depth, k)
    if smem == 0:
        raise ValueError(f"no tiled plan fits shared memory: {name} "
                         f"depth={depth} k={k}")
    return tiled_geometry(kind, nq, n, k, qt, block_n, sms), 1


def _launch(name: str, kind: str, q: torch.Tensor, q_scale,
            rows: torch.Tensor, row_scale, sq, mask, words, sids, depth: int,
            k: int, l2: bool, block_q: int, block_n: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared launch of the dense-mask and scope-word scans. The wrappers
    named in :data:`TILED` run the tiled passes, those in :data:`STREAMED`
    the streaming pass 1."""
    dev = q.device
    nq, n = q.shape[0], rows.shape[0]
    if l2:
        _check(sq, "sq", torch.float32, 1, dev)
        if sq.shape[0] < n:
            raise ValueError(f"sq has {sq.shape[0]} norms for {n} rows")
    if words is not None:
        n_scopes, n_words = _check_words(words, sids, nq, n, dev)
    else:
        _check(mask, "mask", torch.int8, 1, dev)
        if mask.shape[0] != n:
            raise ValueError(f"mask has {mask.shape[0]} lanes for {n} rows")
        n_scopes = n_words = 0
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    streaming = name in STREAMED
    geo, lists = launch_geometry(name, kind, nq, n, depth, k, block_q,
                                 block_n, sms)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_i
    slots = geo.n_chunks * lists
    groups = pass2_groups(nq, slots, sms) if streaming else 1
    # (nq, slots, k) partials, then pass 2's nq * groups first-level lists
    extra = nq * groups * k if groups > 1 else 0
    part_v = torch.empty(nq * slots * k + extra, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(nq * slots * k + extra, dtype=torch.int32,
                         device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        cuda_stream = ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream)
        if streaming:
            rc = lib.repro_scan_topk_stream(
                KINDS[kind], _ptr(q), _ptr(q_scale), _ptr(rows),
                _ptr(row_scale), _ptr(sq if l2 else None), _ptr(mask), nq, n,
                depth, k, int(l2), geo.qt, geo.chunk_rows, geo.n_chunks,
                groups, _ptr(part_v), _ptr(part_i), _ptr(out_v),
                _ptr(out_i), cuda_stream)
        else:
            rc = lib.repro_scan_topk_tiled(
                KINDS[kind], _ptr(q), _ptr(q_scale), _ptr(rows),
                _ptr(row_scale), _ptr(sq if l2 else None), _ptr(words),
                _ptr(sids), n_scopes, n_words, nq, n, depth, k, int(l2),
                geo.qt, geo.chunk_rows, geo.n_chunks, _ptr(part_v),
                _ptr(part_i), _ptr(out_v), _ptr(out_i), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    count_launch(launches, name)
    return out_v, out_i


def _check_words(words, sids, nq: int, n: int,
                 dev: torch.device) -> Tuple[int, int]:
    """Packed (S, W) int32 scope words covering n rows and (nq,) int32
    scope ids; returns (S, W)."""
    _check(words, "mask_words", torch.int32, 2, dev)
    _check(sids, "scope_ids", torch.int32, 1, dev)
    if words.shape[1] * 32 < n:
        raise ValueError(f"{words.shape[1]} mask words cover fewer than "
                         f"{n} rows")
    if sids.shape[0] != nq:
        raise ValueError(f"{sids.shape[0]} scope ids for {nq} queries")
    return words.shape[0], words.shape[1]


class Layout(NamedTuple):
    """Kernel 9's padded-CSR layout: list c holds positions
    [0, aligned[c]) at flat_ids[offsets[c]:], -1 = padding."""
    offsets: torch.Tensor    # (n_lists,) int64
    aligned: torch.Tensor    # (n_lists,) int64
    flat_ids: torch.Tensor   # int32 store ids
    max_aligned: int         # widest region: a probe slot's positions


def cand_layout(cand: torch.Tensor) -> Tuple[Layout, torch.Tensor]:
    """The layout and (B, 1) probes in which query b alone probes one list
    of C positions, its row of the (B, C) candidate matrix ``cand``."""
    B, C = cand.shape
    dev = cand.device
    offsets = torch.arange(B, dtype=torch.int64, device=dev) * C
    aligned = torch.full((B,), C, dtype=torch.int64, device=dev)
    probe = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    return Layout(offsets, aligned, cand.reshape(-1), C), probe


def _check_layout(lay: Layout, probe: torch.Tensor, nq: int, n: int,
                  dev: torch.device, check_ids: bool) -> Tuple[int, int]:
    """The layout's tensors and the (nq, nprobe) int32 probes; with
    ``check_ids`` also (reductions and a device-to-host read) every probed
    list in range and distinct within its row, every id in [-1, n), and
    ``max_aligned`` the widest region (the IVF executor's come from its
    checked layout and a sort, and it passes False). Returns
    (n_lists, nprobe)."""
    _check(lay.offsets, "offsets", torch.int64, 1, dev)
    _check(lay.aligned, "aligned", torch.int64, 1, dev)
    _check(lay.flat_ids, "flat_ids", torch.int32, 1, dev)
    _check(probe, "probe", torch.int32, 2, dev)
    n_lists = lay.offsets.shape[0]
    if lay.aligned.shape[0] != n_lists or n_lists < 1:
        raise ValueError(f"{n_lists} offsets, {lay.aligned.shape[0]} "
                         f"lengths: one each per list, at least one list")
    if probe.shape[0] != nq or probe.shape[1] < 1:
        raise ValueError(f"probe {tuple(probe.shape)} for {nq} queries")
    nprobe = probe.shape[1]
    if nprobe * lay.max_aligned >= 2 ** 31:
        raise ValueError(f"{nprobe} x {lay.max_aligned} positions exceed "
                         f"int32")
    if check_ids and probe.numel():
        lo, hi = (int(v) for v in torch.aminmax(probe))
        if lo < 0 or hi >= n_lists:
            raise ValueError(f"probe in [{lo}, {hi}], outside "
                             f"[0, {n_lists})")
        srt = probe.sort(dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise ValueError("a row of probe repeats a list")
        if int(lay.aligned.max()) > lay.max_aligned:
            raise ValueError(f"a list is wider than max_aligned "
                             f"{lay.max_aligned}")
        if lay.flat_ids.numel():
            lo, hi = (int(v) for v in torch.aminmax(lay.flat_ids))
            if lo < -1 or hi >= n:
                raise ValueError(f"flat_ids in [{lo}, {hi}], outside "
                                 f"[-1, {n})")
    return n_lists, nprobe


def check_per_list(probe: torch.Tensor, per_list: Optional[int],
                   check_ids: bool) -> None:
    """``per_list`` (None: every query) at least 1 and, with ``check_ids``
    (a device-to-host read), no list probed by more queries than it; a
    list's queries past ``per_list`` would get no lane of the grid."""
    if per_list is None:
        return
    if per_list < 1:
        raise ValueError(f"per_list={per_list} must be >= 1")
    if check_ids and probe.numel():
        most = int(torch.unique(probe, return_counts=True)[1].max())
        if most > per_list:
            raise ValueError(f"a list is probed by {most} queries, more "
                             f"than per_list={per_list}")


def _launch_list(name: str, kind: str, q: torch.Tensor, q_scale,
                 rows: torch.Tensor, row_scale, sq, words, sids, depth: int,
                 k: int, l2: bool, lay: Layout, probe: torch.Tensor,
                 check_ids: bool, per_list: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9 in its list form (any kind): the probes' inversion on the
    device (a stable sort of the pairs by list and each list's first
    pair), pass 1 over (list x query tile, list chunk) blocks, pass 2.
    ``per_list`` bounds the queries that probe one list (default nq; 1 for
    a candidate matrix, whose tiles then hold one query): it trims the
    grid's empty query tiles when many lists each have few queries (the
    candidate form's B one-query lists, the flat executor's batch of
    gather-plan scopes). A list probed by more queries than ``per_list``
    would lose the rest, so a caller passes the exact largest count
    (:func:`check_per_list`)."""
    dev = q.device
    nq, n = q.shape[0], rows.shape[0]
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if l2:
        _check(sq, "sq", torch.float32, 1, dev)
        if sq.shape[0] < n:
            raise ValueError(f"sq has {sq.shape[0]} norms for {n} rows")
    n_scopes, n_words = _check_words(words, sids, nq, n, dev)
    n_lists, nprobe = _check_layout(lay, probe, nq, n, dev, check_ids)
    check_per_list(probe, per_list, check_ids)
    per_list = nq if per_list is None else per_list
    plan = list_plan(kind, max(1, min(nq, per_list, LIST_Q)), depth, k)
    if plan.smem == 0:
        raise ValueError(f"no list plan fits shared memory: {name} "
                         f"depth={depth} k={k}")
    _, cmax, _ = list_grid(min(nq, per_list), n_lists, lay.max_aligned,
                           plan.qt, plan.chunk)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_i
    slots = nprobe * cmax * plan.lists
    part_v = torch.empty((nq, slots, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, slots, k), dtype=torch.int32, device=dev)
    # the inversion: pairs b * nprobe + p sorted stably by list, and each
    # list's first sorted pair
    by_list, order = torch.sort(probe.reshape(-1), stable=True)
    list_start = torch.searchsorted(
        by_list, torch.arange(n_lists + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    lib = _build.library()
    with torch.cuda.device(dev):
        cuda_stream = ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.repro_scan_topk_list(
            KINDS[kind], _ptr(q), _ptr(q_scale), _ptr(rows), _ptr(row_scale),
            _ptr(sq if l2 else None), _ptr(words), _ptr(sids), n_scopes,
            n_words, nq, depth, k, int(l2), _ptr(lay.offsets),
            _ptr(lay.aligned), _ptr(lay.flat_ids), _ptr(probe), _ptr(order),
            _ptr(list_start), n_lists, nprobe, lay.max_aligned, plan.qt,
            per_list, _ptr(part_v), _ptr(part_i), _ptr(out_v), _ptr(out_i),
            cuda_stream)
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


def _cand(cand_ids) -> Tuple[Layout, torch.Tensor]:
    _check(cand_ids, "cand_ids", torch.int32, 2, cand_ids.device)
    if cand_ids.shape[1] < 1:
        raise ValueError("cand_ids has no candidate column (C = 0)")
    return cand_layout(cand_ids)


def ivf_probe_topk(queries, rows, layout: Layout, probe, mask_words,
                   scope_ids, k, metric="ip", sq=None, check_ids=True,
                   per_list=None):
    """Kernel 9 (fp32), the IVF executor's scoring launch and the flat
    executor's batch of gather-plan scopes: query b scores the rows of its
    probed lists ``probe[b]`` ((B, nprobe) int32) of the padded-CSR
    ``layout`` that bit r%32 of ``mask_words[scope_ids[b], r // 32]``
    admits, reading rows (n, d) f32 in place. Returns (vals (B, k) f32, ids
    (B, k) int32 store ids), ties ranked by the lower position
    p * max_aligned + o. ``check_ids=False`` skips the range checks of the
    probes and ids (the IVF executor's come from its checked layout);
    ``per_list``, the most queries that probe one list (default B), sizes
    the grid's query tiles."""
    d = _f32(queries, rows)
    return _launch_list("ivf_gather_topk", "f32", queries, None, rows, None,
                        sq, mask_words, scope_ids, d, k, _metric_l2(metric),
                        layout, probe, check_ids, per_list)


def ivf_probe_topk_i8(q_i8, q_scale, rows_i8, row_scale, sq, layout: Layout,
                      probe, mask_words, scope_ids, k, metric="ip",
                      check_ids=True):
    """int8 mode of :func:`ivf_probe_topk` (scores as
    :func:`scoped_topk_i8`)."""
    d = _i8(q_i8, q_scale, rows_i8, row_scale)
    return _launch_list("ivf_gather_topk_i8", "i8", q_i8, q_scale, rows_i8,
                        row_scale, sq, mask_words, scope_ids, d, k,
                        _metric_l2(metric), layout, probe, check_ids)


def ivf_probe_topk_pq(lut, codes, layout: Layout, probe, mask_words,
                      scope_ids, k, check_ids=True):
    """PQ/ADC mode of :func:`ivf_probe_topk` (scores as
    :func:`scoped_topk_pq`)."""
    m = _pq(lut, codes)
    return _launch_list("ivf_gather_topk_pq", "pq", lut, None, codes, None,
                        None, mask_words, scope_ids, m, k, False, layout,
                        probe, check_ids)


def ivf_gather_topk(queries, rows, cand_ids, mask_words, scope_ids, k,
                    metric="ip", sq=None, check_ids=True):
    """Kernel 9 over a (B, C) int32 candidate matrix (-1 = padding): the
    list form on the layout in which query b alone probes its row, one
    query a tile. Ties rank by the lower candidate position."""
    d = _f32(queries, rows)
    return _launch_list("ivf_gather_topk", "f32", queries, None, rows, None,
                        sq, mask_words, scope_ids, d, k, _metric_l2(metric),
                        *_cand(cand_ids), check_ids, per_list=1)


def ivf_gather_topk_i8(q_i8, q_scale, rows_i8, row_scale, sq, cand_ids,
                       mask_words, scope_ids, k, metric="ip", check_ids=True):
    """int8 twin of :func:`ivf_gather_topk`."""
    d = _i8(q_i8, q_scale, rows_i8, row_scale)
    return _launch_list("ivf_gather_topk_i8", "i8", q_i8, q_scale, rows_i8,
                        row_scale, sq, mask_words, scope_ids, d, k,
                        _metric_l2(metric), *_cand(cand_ids), check_ids,
                        per_list=1)


def ivf_gather_topk_pq(lut, codes, cand_ids, mask_words, scope_ids, k,
                       check_ids=True):
    """PQ/ADC twin of :func:`ivf_gather_topk`."""
    m = _pq(lut, codes)
    return _launch_list("ivf_gather_topk_pq", "pq", lut, None, codes, None,
                        None, mask_words, scope_ids, m, k, False,
                        *_cand(cand_ids), check_ids, per_list=1)
