"""Public kernel wrappers: device dispatch, padding rules and the tuned-block
registry.

Each wrapper dispatches on the device of its tensors: CUDA tensors launch the
hand-written Hopper kernel (``scoped_topk.py`` / ``bitmap_ops.py`` /
``flash_decode.py``), CPU tensors run the plain PyTorch version in
``ref.py``, and any other device raises. There is no fallback: a kernel that
fails to build or launch raises.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import bitmap_ops as _bm
from . import flash_decode as _fd
from . import ref
from . import scoped_topk as _st
from .common import row_sq_norms

# Tuned (block_q, block_n) per wrapper, installed from a measured calibration
# artifact (vectordb.costmodel.install_kernel_tuning). Tiling is a pure
# performance knob -- results are block-shape independent -- so a
# process-global registry is safe; callers passing explicit block args still
# win. On the card block_q is the query tile and block_n the rows one block
# sweeps; ``None`` sizes the row chunks to fill the card. The query tile is
# at most 8 on the streaming pass 1 (1 at PQ) and at most 64 on the tiled
# passes of the scope-word scans (``_st.TILED``), whose default is the
# 64-query cap (the PQ plan takes at most 8 of it).
_DEFAULT_BLOCK_Q = 8
_DEFAULT_BLOCK_N: Optional[int] = None
_BLOCK_OVERRIDES: Dict[str, Tuple[int, int]] = {}


def set_block_overrides(overrides: Mapping[str, Tuple[int, int]]) -> None:
    """Replace the tuned-block registry (pass ``{}`` to restore defaults)."""
    new = {str(name): (int(bq), int(bn))
           for name, (bq, bn) in dict(overrides).items()}
    _BLOCK_OVERRIDES.clear()
    _BLOCK_OVERRIDES.update(new)


def get_block_overrides() -> Dict[str, Tuple[int, int]]:
    return dict(_BLOCK_OVERRIDES)


def _blocks(name: str, block_q: Optional[int],
            block_n: Optional[int]) -> Tuple[int, Optional[int]]:
    """Resolve a wrapper's block shape: explicit caller args > tuned registry
    entry > defaults."""
    tuned = _BLOCK_OVERRIDES.get(name)
    if block_q is None:
        block_q = tuned[0] if tuned else (
            _st.TILE_Q if name in _st.TILED else _DEFAULT_BLOCK_Q)
    if block_n is None:
        block_n = tuned[1] if tuned else _DEFAULT_BLOCK_N
    return block_q, block_n


def _align_block_n(block_n: int, n_rows: int, floor: int = 128) -> int:
    """Clamp ``block_n`` to the (floored) row count, then round UP to a
    multiple of 32, so a block's rows are whole mask words (e.g. n_rows=137
    gives 160, never an unaligned 137)."""
    block_n = min(block_n, max(floor, n_rows))
    return ((block_n + 31) // 32) * 32


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {**_st.launches, **_bm.launches, **_fd.launches}


def reset_launch_counts() -> None:
    for table in (_st.launches, _bm.launches, _fd.launches):
        for name in table:
            table[name] = 0


def as_words(words) -> torch.Tensor:
    """Packed uint32 words (numpy array or tensor) as an int32 tensor view
    of the same bits."""
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(
            np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be 32-bit, got {words.dtype}")
    return words


def _device_of(*tensors: Optional[torch.Tensor]) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel and no plain version for device {dev}")
    return dev


def _pad_words(mask_words, n: int) -> torch.Tensor:
    """Packed words as int32, zero-padded to cover ``ceil(n/32)`` words
    (rows past the given words are out of every scope)."""
    mask_words = as_words(mask_words)
    want = (n + 31) // 32
    if mask_words.shape[1] < want:
        mask_words = torch.nn.functional.pad(
            mask_words, (0, want - mask_words.shape[1]))
    return mask_words


def scoped_topk(queries: torch.Tensor, rows: torch.Tensor,
                mask: torch.Tensor, k: int = 10, metric: str = "ip",
                sq: Optional[torch.Tensor] = None,
                block_q: Optional[int] = None,
                block_n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over rows with one (n,) mask shared by all queries.
    Returns (vals (q, k) f32 descending, ids (q, k) int32), ``finfo.min`` /
    -1 for empty lanes. ``sq`` is the rows' squared norms (l2 only;
    computed from ``rows`` when omitted)."""
    dev = _device_of(queries, rows, mask, sq)
    if metric == "l2" and sq is None:
        sq = row_sq_norms(rows)
    if dev.type == "cpu":
        return ref.scoped_topk_ref(queries, rows, mask, k, metric, sq)
    block_q, block_n = _blocks("scoped_topk", block_q, block_n)
    if block_n is not None:
        block_n = _align_block_n(block_n, rows.shape[0])
    return _st.scoped_topk(queries.float().contiguous(), rows,
                           mask.to(torch.int8).contiguous(), k, metric, sq,
                           block_q, block_n)


def multi_scope_topk(queries: torch.Tensor, rows: torch.Tensor,
                     mask_words: torch.Tensor, scope_ids: torch.Tensor,
                     k: int = 10, metric: str = "ip",
                     sq: Optional[torch.Tensor] = None,
                     block_q: Optional[int] = None,
                     block_n: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-launch heterogeneous masked top-k: query i ranks the rows its
    scope row ``scope_ids[i]`` of the packed (n_scopes, ceil(n/32)) mask
    matrix admits. Mask words shorter than ceil(n/32) are padded with zero
    words (rows past them are out of every scope)."""
    mask_words = _pad_words(mask_words, rows.shape[0])
    dev = _device_of(queries, rows, mask_words, scope_ids, sq)
    if metric == "l2" and sq is None:
        sq = row_sq_norms(rows)
    if dev.type == "cpu":
        return ref.multi_scope_topk_ref(queries, rows, mask_words, scope_ids,
                                        k, metric, sq)
    block_q, block_n = _blocks("multi_scope_topk", block_q, block_n)
    if block_n is not None:
        block_n = _align_block_n(block_n, rows.shape[0])
    return _st.multi_scope_topk(queries.float().contiguous(), rows,
                                mask_words.contiguous(),
                                scope_ids.to(torch.int32).contiguous(), k,
                                metric, sq, block_q, block_n)


def _i8_sq(metric: str, sq: Optional[torch.Tensor]) -> None:
    if metric == "l2" and sq is None:
        raise ValueError("the int8 l2 scan needs sq, the dequantized rows' "
                         "squared norms (VectorStore.q_sq_norms)")


def scoped_topk_i8(q_i8: torch.Tensor, q_scale: torch.Tensor,
                   rows_i8: torch.Tensor, row_scale: torch.Tensor,
                   sq: Optional[torch.Tensor], mask: torch.Tensor,
                   k: int = 10, metric: str = "ip",
                   block_q: Optional[int] = None,
                   block_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over the int8 store (the scan phase of the two-phase
    int8 plan): scores ``float(int32 dot) * (q_scale * row_scale)``, and
    ``2 s - sq`` for l2 (``sq`` read for l2 only)."""
    dev = _device_of(q_i8, q_scale, rows_i8, row_scale, mask, sq)
    _i8_sq(metric, sq)
    if dev.type == "cpu":
        return ref.scoped_topk_i8_ref(q_i8, q_scale, rows_i8, row_scale, sq,
                                      mask, k, metric)
    block_q, block_n = _blocks("scoped_topk_i8", block_q, block_n)
    if block_n is not None:
        block_n = _align_block_n(block_n, rows_i8.shape[0])
    return _st.scoped_topk_i8(
        q_i8.to(torch.int8).contiguous(), q_scale.float().contiguous(),
        rows_i8, row_scale, sq, mask.to(torch.int8).contiguous(), k, metric,
        block_q, block_n)


def multi_scope_topk_i8(q_i8: torch.Tensor, q_scale: torch.Tensor,
                        rows_i8: torch.Tensor, row_scale: torch.Tensor,
                        sq: Optional[torch.Tensor], mask_words: torch.Tensor,
                        scope_ids: torch.Tensor, k: int = 10,
                        metric: str = "ip", block_q: Optional[int] = None,
                        block_n: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-launch heterogeneous masked top-k over the int8 store: the
    scope-id indirection of :func:`multi_scope_topk`, the scoring of
    :func:`scoped_topk_i8`."""
    mask_words = _pad_words(mask_words, rows_i8.shape[0])
    dev = _device_of(q_i8, q_scale, rows_i8, row_scale, mask_words,
                     scope_ids, sq)
    _i8_sq(metric, sq)
    if dev.type == "cpu":
        return ref.multi_scope_topk_i8_ref(q_i8, q_scale, rows_i8, row_scale,
                                           sq, mask_words, scope_ids, k,
                                           metric)
    block_q, block_n = _blocks("multi_scope_topk_i8", block_q, block_n)
    if block_n is not None:
        block_n = _align_block_n(block_n, rows_i8.shape[0])
    return _st.multi_scope_topk_i8(
        q_i8.to(torch.int8).contiguous(), q_scale.float().contiguous(),
        rows_i8, row_scale, sq, mask_words.contiguous(),
        scope_ids.to(torch.int32).contiguous(), k, metric, block_q, block_n)


def scoped_topk_pq(lut: torch.Tensor, codes: torch.Tensor,
                   mask: torch.Tensor, k: int = 10,
                   block_q: Optional[int] = None,
                   block_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over the PQ code store (the ADC scan phase of the
    two-phase PQ plan): lut (q, M, 256) f32 with the metric folded in,
    codes (n, M) uint8. No metric argument: the LUT is the metric."""
    dev = _device_of(lut, codes, mask)
    if dev.type == "cpu":
        return ref.scoped_topk_pq_ref(lut, codes, mask, k)
    block_q, block_n = _blocks("scoped_topk_pq", block_q, block_n)
    if block_n is not None:
        block_n = _align_block_n(block_n, codes.shape[0])
    return _st.scoped_topk_pq(lut.float().contiguous(), codes,
                              mask.to(torch.int8).contiguous(), k, block_q,
                              block_n)


def multi_scope_topk_pq(lut: torch.Tensor, codes: torch.Tensor,
                        mask_words: torch.Tensor, scope_ids: torch.Tensor,
                        k: int = 10, block_q: Optional[int] = None,
                        block_n: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-launch heterogeneous masked top-k over the PQ code store."""
    mask_words = _pad_words(mask_words, codes.shape[0])
    dev = _device_of(lut, codes, mask_words, scope_ids)
    if dev.type == "cpu":
        return ref.multi_scope_topk_pq_ref(lut, codes, mask_words, scope_ids,
                                           k)
    block_q, block_n = _blocks("multi_scope_topk_pq", block_q, block_n)
    if block_n is not None:
        block_n = _align_block_n(block_n, codes.shape[0])
    return _st.multi_scope_topk_pq(lut.float().contiguous(), codes,
                                   mask_words.contiguous(),
                                   scope_ids.to(torch.int32).contiguous(), k,
                                   block_q, block_n)


def ivf_gather_topk(queries: torch.Tensor, rows: torch.Tensor,
                    cand_ids: torch.Tensor, mask_words: torch.Tensor,
                    scope_ids: torch.Tensor, k: int = 10, metric: str = "ip",
                    sq: Optional[torch.Tensor] = None, check_ids: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9 over a candidate matrix: query b ranks the store rows
    ``cand_ids[b]`` ((B, C) int32, -1 = CSR padding) that its scope row
    ``mask_words[scope_ids[b]]`` admits, reading them from ``rows`` (n, d)
    in place. Returns (vals (B, k) f32, ids (B, k) int32 store ids), ties
    ranked by the lower candidate position; ``finfo.min`` / -1 when
    empty. The wrapper checks that every id lies in [-1, n) unless
    ``check_ids`` is False (ids from an already checked table). On the card
    it runs the list form (:func:`ivf_probe_topk`) on the layout in which
    query b alone probes one list, its row."""
    mask_words = _pad_words(mask_words, rows.shape[0])
    dev = _device_of(queries, rows, cand_ids, mask_words, scope_ids, sq)
    if metric == "l2" and sq is None:
        sq = row_sq_norms(rows)
    if dev.type == "cpu":
        return ref.ivf_gather_topk_ref(queries, rows, cand_ids, mask_words,
                                       scope_ids, k, metric, sq)
    return _st.ivf_gather_topk(queries.float().contiguous(), rows,
                               cand_ids.to(torch.int32).contiguous(),
                               mask_words.contiguous(),
                               scope_ids.to(torch.int32).contiguous(), k,
                               metric, sq, check_ids)


def ivf_gather_topk_i8(q_i8: torch.Tensor, q_scale: torch.Tensor,
                       rows_i8: torch.Tensor, row_scale: torch.Tensor,
                       sq: Optional[torch.Tensor], cand_ids: torch.Tensor,
                       mask_words: torch.Tensor, scope_ids: torch.Tensor,
                       k: int = 10, metric: str = "ip",
                       check_ids: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`ivf_gather_topk` (scores as
    :func:`scoped_topk_i8`)."""
    mask_words = _pad_words(mask_words, rows_i8.shape[0])
    dev = _device_of(q_i8, q_scale, rows_i8, row_scale, sq, cand_ids,
                     mask_words, scope_ids)
    _i8_sq(metric, sq)
    if dev.type == "cpu":
        return ref.ivf_gather_topk_i8_ref(q_i8, q_scale, rows_i8, row_scale,
                                          sq, cand_ids, mask_words,
                                          scope_ids, k, metric)
    return _st.ivf_gather_topk_i8(
        q_i8.to(torch.int8).contiguous(), q_scale.float().contiguous(),
        rows_i8, row_scale, sq, cand_ids.to(torch.int32).contiguous(),
        mask_words.contiguous(), scope_ids.to(torch.int32).contiguous(), k,
        metric, check_ids)


def ivf_gather_topk_pq(lut: torch.Tensor, codes: torch.Tensor,
                       cand_ids: torch.Tensor, mask_words: torch.Tensor,
                       scope_ids: torch.Tensor, k: int = 10,
                       check_ids: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ/ADC twin of :func:`ivf_gather_topk` (scores as
    :func:`scoped_topk_pq`)."""
    mask_words = _pad_words(mask_words, codes.shape[0])
    dev = _device_of(lut, codes, cand_ids, mask_words, scope_ids)
    if dev.type == "cpu":
        return ref.ivf_gather_topk_pq_ref(lut, codes, cand_ids, mask_words,
                                          scope_ids, k)
    return _st.ivf_gather_topk_pq(lut.float().contiguous(), codes,
                                  cand_ids.to(torch.int32).contiguous(),
                                  mask_words.contiguous(),
                                  scope_ids.to(torch.int32).contiguous(), k,
                                  check_ids)


def _contig(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor, ``t`` itself when it is one
    already: a conversion call that changes nothing still releases the
    interpreter lock, and another thread may hold it on the way back."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _probe32(probe: torch.Tensor) -> torch.Tensor:
    return _contig(probe, torch.int32)


def ivf_probe_topk(queries: torch.Tensor, rows: torch.Tensor,
                   offsets: torch.Tensor, aligned: torch.Tensor,
                   flat_ids: torch.Tensor, max_aligned: int,
                   probe: torch.Tensor, mask_words: torch.Tensor,
                   scope_ids: torch.Tensor, k: int = 10, metric: str = "ip",
                   sq: Optional[torch.Tensor] = None, check_ids: bool = True,
                   per_list: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9's list form, the IVF executor's scoring launch and the flat
    executor's batch of gather-plan scopes: query b
    ranks the rows of its probed lists ``probe[b]`` ((B, nprobe), distinct
    lists per row) of the padded-CSR layout (``offsets`` / ``aligned``
    int64 per list, ``flat_ids`` int32 with -1 padding, ``max_aligned`` the
    widest region) that its scope row ``mask_words[scope_ids[b]]`` admits,
    reading them from ``rows`` (n, d) in place. Returns what
    :func:`ivf_gather_topk` returns on the expanded (B, nprobe *
    max_aligned) candidate matrix: (vals (B, k) f32, ids (B, k) int32 store
    ids), ties ranked by the lower position p * max_aligned + o.
    ``check_ids=False`` skips the checks of the probes and ids (a caller
    whose come from an already checked layout). ``per_list``, the most
    queries that probe one list (default B), sizes the card's grid: it
    must be at least 1, and (checked with ``check_ids``) not below the
    true count."""
    mask_words = _pad_words(mask_words, rows.shape[0])
    dev = _device_of(queries, rows, offsets, aligned, flat_ids, probe,
                     mask_words, scope_ids, sq)
    if metric == "l2" and sq is None:
        sq = row_sq_norms(rows)
    if dev.type == "cpu":
        # the card's launch checks ``per_list`` itself
        _st.check_per_list(probe, per_list, check_ids)
        return ref.ivf_probe_topk_ref(queries, rows, offsets, aligned,
                                      flat_ids, max_aligned, probe,
                                      mask_words, scope_ids, k, metric, sq)
    return _st.ivf_probe_topk(
        _contig(queries, torch.float32), rows,
        _st.Layout(offsets, aligned, flat_ids, int(max_aligned)),
        _probe32(probe), _contig(mask_words, torch.int32),
        _contig(scope_ids, torch.int32), k, metric, sq, check_ids, per_list)


def ivf_probe_topk_i8(q_i8: torch.Tensor, q_scale: torch.Tensor,
                      rows_i8: torch.Tensor, row_scale: torch.Tensor,
                      sq: Optional[torch.Tensor], offsets: torch.Tensor,
                      aligned: torch.Tensor, flat_ids: torch.Tensor,
                      max_aligned: int, probe: torch.Tensor,
                      mask_words: torch.Tensor, scope_ids: torch.Tensor,
                      k: int = 10, metric: str = "ip", check_ids: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 mode of :func:`ivf_probe_topk` (the phase-1 scan of the IVF
    int8 plan; scores as :func:`scoped_topk_i8`)."""
    mask_words = _pad_words(mask_words, rows_i8.shape[0])
    dev = _device_of(q_i8, q_scale, rows_i8, row_scale, sq, offsets,
                     aligned, flat_ids, probe, mask_words, scope_ids)
    _i8_sq(metric, sq)
    if dev.type == "cpu":
        return ref.ivf_probe_topk_i8_ref(q_i8, q_scale, rows_i8, row_scale,
                                         sq, offsets, aligned, flat_ids,
                                         max_aligned, probe, mask_words,
                                         scope_ids, k, metric)
    return _st.ivf_probe_topk_i8(
        q_i8.to(torch.int8).contiguous(), q_scale.float().contiguous(),
        rows_i8, row_scale, sq,
        _st.Layout(offsets, aligned, flat_ids, int(max_aligned)),
        _probe32(probe), mask_words.contiguous(),
        scope_ids.to(torch.int32).contiguous(), k, metric, check_ids)


def ivf_probe_topk_pq(lut: torch.Tensor, codes: torch.Tensor,
                      offsets: torch.Tensor, aligned: torch.Tensor,
                      flat_ids: torch.Tensor, max_aligned: int,
                      probe: torch.Tensor, mask_words: torch.Tensor,
                      scope_ids: torch.Tensor, k: int = 10,
                      check_ids: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ/ADC mode of :func:`ivf_probe_topk` (the phase-1 scan of the IVF
    PQ plan; scores as :func:`scoped_topk_pq`)."""
    mask_words = _pad_words(mask_words, codes.shape[0])
    dev = _device_of(lut, codes, offsets, aligned, flat_ids, probe,
                     mask_words, scope_ids)
    if dev.type == "cpu":
        return ref.ivf_probe_topk_pq_ref(lut, codes, offsets, aligned,
                                         flat_ids, max_aligned, probe,
                                         mask_words, scope_ids, k)
    return _st.ivf_probe_topk_pq(
        lut.float().contiguous(), codes,
        _st.Layout(offsets, aligned, flat_ids, int(max_aligned)),
        _probe32(probe), mask_words.contiguous(),
        scope_ids.to(torch.int32).contiguous(), k, check_ids)


def bitmap_patch(masks, delta, op_signs) -> torch.Tensor:
    """Batched packed-mask patch: rows with op +1 get ``| delta``, -1 get
    ``& ~delta``, 0 pass through. Words are int32 views of uint32 bits."""
    masks = as_words(masks)
    if masks.ndim == 1:
        masks = masks[None, :]
    delta = as_words(delta).reshape(-1)
    if delta.shape[0] != masks.shape[1]:
        raise ValueError(f"delta has {delta.shape[0]} words for "
                         f"{masks.shape[1]}-word masks")
    dev = _device_of(masks, delta, op_signs)
    op_signs = op_signs.to(torch.int32).reshape(-1)
    if dev.type == "cpu":
        return ref.bitmap_patch_ref(masks, delta, op_signs)
    return _bm.bitmap_patch(masks.contiguous(), delta.contiguous(),
                            op_signs.contiguous())


def mask_and_popcount(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a & b`` and the total popcount (int32 0-d tensor)."""
    a, b = as_words(a), as_words(b)
    dev = _device_of(a, b)
    if dev.type == "cpu":
        return ref.mask_and_popcount_ref(a, b)
    return _bm.mask_and_popcount(a.contiguous(), b.contiguous())


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA decode attention for one query token: q (b, h, d); k, v
    (b, kv_h, s, d); length_mask (b, s), non-zero = admitted (all admitted
    when None) -> (b, h, d) in q's type. Any s: the ragged tail is masked,
    never padded."""
    if length_mask is None:
        length_mask = torch.ones(k.shape[0], k.shape[2], dtype=torch.int8,
                                 device=k.device)
    if not q.is_cuda:
        dev = _device_of(q, k, v, length_mask)
        if dev.type == "cpu":
            return ref.flash_decode_ref(q, k, v, length_mask)
    # every decode layer comes here: the launch wrapper checks the devices
    # itself, and only what it cannot take is converted
    if length_mask.dtype is not torch.int8:
        length_mask = length_mask.to(torch.int8)
    return _fd.flash_decode(*(t if t.is_contiguous() else t.contiguous()
                              for t in (q, k, v, length_mask)))


__all__ = ["scoped_topk", "multi_scope_topk", "scoped_topk_i8",
           "multi_scope_topk_i8", "scoped_topk_pq", "multi_scope_topk_pq",
           "ivf_gather_topk", "ivf_gather_topk_i8", "ivf_gather_topk_pq",
           "ivf_probe_topk", "ivf_probe_topk_i8", "ivf_probe_topk_pq",
           "bitmap_patch", "mask_and_popcount", "flash_decode",
           "set_block_overrides", "get_block_overrides",
           "launch_counts", "reset_launch_counts", "as_words", "ref"]
