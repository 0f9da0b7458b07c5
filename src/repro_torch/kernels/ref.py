"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its Hopper kernel computes, with ordinary
tensor ops. The CPU path runs them (a wrapper in ``ops.py`` picks them only
for tensors that lie on the CPU), the tests hold them against the JAX
package, and ``chip_smoke.py`` holds every kernel against them on the card.

Four traps these versions are built around:

* **Ties.** ``torch.topk`` does not keep lower ids first on equal scores;
  :func:`stable_topk` sorts with ``stable=True`` so the rank order is
  (score descending, id ascending), the rule of ``jax.lax.top_k``.
* **uint32.** ``~`` and ``>>`` are not implemented for ``torch.uint32`` on
  the CPU, so packed mask words travel as ``torch.int32`` views of the same
  bits: ``(w >> j) & 1`` is right even under an arithmetic shift, and the
  popcount is done by bit tricks on int64.
* **Batch invariance.** Scores are one ``torch.mv`` per query row, so a
  query's score bits do not depend on how many queries share the call —
  the property ``dsq_batch == loop of dsq`` rests on.
* **Sentinels.** Empty result lanes are ``NEG_INF = finfo(float32).min``
  with id -1, as in the Pallas kernels.

Nothing here runs on the main path when a card is present; the two tensor
helpers both sides need (word unpacking, squared row norms) live in
``common.py`` and are re-exported here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .common import row_sq_norms, unpack_words

__all__ = ["NEG_INF", "stable_topk", "row_sq_norms", "row_scores",
           "unpack_words", "scoped_topk_ref", "multi_scope_topk_ref",
           "bitmap_patch_ref", "popcount32", "mask_and_popcount_ref",
           "topk_disagreement"]

NEG_INF = float(np.finfo(np.float32).min)

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def stable_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, n) scores -> (vals (q, k) f32, ids (q, k) int32), ranked by
    (score descending, id ascending); lanes at or below ``NEG_INF`` and
    lanes past n come back as ``NEG_INF`` / -1."""
    q, n = scores.shape
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k].to(torch.int32)
    if k > n:
        pad_v = torch.full((q, k - n), NEG_INF, dtype=vals.dtype,
                           device=vals.device)
        pad_i = torch.full((q, k - n), -1, dtype=torch.int32,
                           device=ids.device)
        vals = torch.cat([vals, pad_v], dim=1)
        ids = torch.cat([ids, pad_i], dim=1)
    ids = torch.where(vals <= NEG_INF, torch.full_like(ids, -1), ids)
    return vals, ids


def row_scores(queries: torch.Tensor, rows: torch.Tensor, metric: str = "ip",
               sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(q, n) fp32 scores, one gemv per query row (batch-invariant). ip/cos:
    q.x; l2: 2 q.x - ||x||^2 (argmax of the negated distance)."""
    rows = rows.float()
    out = torch.stack([torch.mv(rows, qv) for qv in queries.float()])
    if metric == "l2":
        if sq is None:
            sq = row_sq_norms(rows)
        out = 2.0 * out - sq[None, :]
    return out


def scoped_topk_ref(queries: torch.Tensor, rows: torch.Tensor,
                    mask: torch.Tensor, k: int = 10, metric: str = "ip",
                    sq: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k with one (n,) mask shared by every query; materialises
    the full (q, n) score matrix."""
    scores = row_scores(queries, rows, metric, sq)
    scores = torch.where(mask.bool()[None, :], scores,
                         torch.full_like(scores, NEG_INF))
    return stable_topk(scores, k)


def multi_scope_topk_ref(queries: torch.Tensor, rows: torch.Tensor,
                         mask_words: torch.Tensor, scope_ids: torch.Tensor,
                         k: int = 10, metric: str = "ip",
                         sq: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heterogeneous-batch masked top-k: query i takes row ``scope_ids[i]``
    of the packed (n_scopes, W) mask matrix."""
    n = rows.shape[0]
    scores = row_scores(queries, rows, metric, sq)
    valid = unpack_words(mask_words, n)[scope_ids.long()]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    return stable_topk(scores, k)


def bitmap_patch_ref(masks: torch.Tensor, delta: torch.Tensor,
                     ops: torch.Tensor) -> torch.Tensor:
    """Per row of (R, W) packed masks: ``m | delta`` where op > 0,
    ``m & ~delta`` where op < 0, ``m`` where op == 0 (int32 views)."""
    d = delta.reshape(1, -1)
    op = ops.reshape(-1, 1)
    return torch.where(op > 0, masks | d,
                       torch.where(op < 0, masks & ~d, masks))


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32-viewed words (SWAR on int64)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def mask_and_popcount_ref(a: torch.Tensor, b: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a & b`` and its total popcount (int32 0-d tensor)."""
    words = a & b
    return words, popcount32(words).sum().to(torch.int32)


def topk_disagreement(ids: np.ndarray, vals: np.ndarray,
                      ref_ids: np.ndarray, ref_vals: np.ndarray,
                      tol: float = 1e-5) -> Optional[str]:
    """How a (q, k) top-k result departs from a reference one, or None.

    Empty lanes (id < 0) must coincide; other values must agree to
    rtol = atol = ``tol`` (fp32 sums taken in another order). Ids must be
    equal, except where the reference scores differ by less than ``tol``:
    there the ids are compared as a set (an id may sit anywhere in its tie
    group, or swap with an equal-scoring row just past the k-th)."""
    ids, ref_ids = np.asarray(ids, np.int64), np.asarray(ref_ids, np.int64)
    vals = np.asarray(vals, np.float64)
    ref_vals = np.asarray(ref_vals, np.float64)
    if ids.shape != ref_ids.shape:
        return f"shape {ids.shape} != {ref_ids.shape}"
    empty = ids < 0
    if not np.array_equal(empty, ref_ids < 0):
        return "empty lanes differ"
    if not np.allclose(vals[~empty], ref_vals[~empty], rtol=tol, atol=tol):
        err = np.max(np.abs(vals[~empty] - ref_vals[~empty]))
        return f"values differ (max abs err {err:.3g})"
    for r, j in zip(*np.nonzero(ids != ref_ids)):
        row, ref_row = ids[r], ref_ids[r]
        valid = ref_row >= 0
        tied = valid & (np.abs(ref_vals[r] - ref_vals[r, j]) <= tol)
        if row[j] in ref_row[tied]:
            continue
        last = np.flatnonzero(valid)[-1]
        if row[j] not in ref_row and (
                abs(ref_vals[r, j] - ref_vals[r, last]) <= 2 * tol):
            continue                      # tie at the k-th boundary
        return f"query {r} slot {j}: id {row[j]} vs {ref_row[j]}"
    return None
