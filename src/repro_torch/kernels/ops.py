"""Public kernel wrappers: device dispatch, padding rules and the tuned-block
registry.

Each wrapper dispatches on the device of its tensors: CUDA tensors launch the
hand-written Hopper kernel (``scoped_topk.py`` / ``bitmap_ops.py``), CPU
tensors run the plain PyTorch version in ``ref.py``, and any other device
raises. There is no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import bitmap_ops as _bm
from . import ref
from . import scoped_topk as _st
from .common import row_sq_norms

# Tuned (block_q, block_n) per wrapper, installed from a measured calibration
# artifact (vectordb.costmodel.install_kernel_tuning). Tiling is a pure
# performance knob -- results are block-shape independent -- so a
# process-global registry is safe; callers passing explicit block args still
# win. On the card block_q is the query tile (<= 8) and block_n the rows one
# block sweeps; ``None`` sizes the row chunks to fill the card.
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
        block_q = tuned[0] if tuned else _DEFAULT_BLOCK_Q
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
    return {**_st.launches, **_bm.launches}


def reset_launch_counts() -> None:
    for table in (_st.launches, _bm.launches):
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
    mask_words = as_words(mask_words)
    dev = _device_of(queries, rows, mask_words, scope_ids, sq)
    want = (rows.shape[0] + 31) // 32
    if mask_words.shape[1] < want:
        mask_words = torch.nn.functional.pad(
            mask_words, (0, want - mask_words.shape[1]))
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


__all__ = ["scoped_topk", "multi_scope_topk", "bitmap_patch",
           "mask_and_popcount", "set_block_overrides", "get_block_overrides",
           "launch_counts", "reset_launch_counts", "as_words", "ref"]
