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
* **Batch invariance.** fp32 scores are one product-and-sum per query
  row (see :func:`row_scores`), int8 scores are exact integer dots, and PQ
  scores add the LUT entries elementwise in subspace order, so a query's
  score bits do not depend on how many queries share the call — the
  property ``dsq_batch == loop of dsq`` rests on.
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
from .flash_decode import SPLIT_TILE, split_ranges

__all__ = ["NEG_INF", "stable_topk", "row_sq_norms", "row_scores",
           "i8_scores", "pq_scores", "unpack_words", "scoped_topk_ref",
           "multi_scope_topk_ref", "scoped_topk_i8_ref",
           "multi_scope_topk_i8_ref", "scoped_topk_pq_ref",
           "multi_scope_topk_pq_ref", "ivf_gather_topk_ref",
           "ivf_gather_topk_i8_ref", "ivf_gather_topk_pq_ref",
           "ivf_probe_topk_ref", "ivf_probe_topk_i8_ref",
           "ivf_probe_topk_pq_ref", "bitmap_patch_ref", "popcount32",
           "mask_and_popcount_ref", "flash_decode_ref",
           "flash_decode_split_ref", "topk_disagreement"]

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
    """(q, n) fp32 scores, one elementwise product and sum over d per query
    row, so a score's bits depend on neither the query count nor the row
    count nor the row's position (a CPU ``torch.mv`` sums in an order that
    depends on the row count; the rescore concatenates a batch's windows).
    ip/cos: q.x; l2: 2 q.x - ||x||^2 (argmax of the negated distance)."""
    rows = rows.float()
    out = torch.stack([(rows * qv).sum(dim=1) for qv in queries.float()])
    if metric == "l2":
        if sq is None:
            sq = row_sq_norms(rows)
        out = 2.0 * out - sq[None, :]
    return out


def _masked_topk(scores: torch.Tensor, valid: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return stable_topk(torch.where(valid, scores,
                                   torch.full_like(scores, NEG_INF)), k)


def _scope_valid(mask_words: torch.Tensor, scope_ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    return unpack_words(mask_words, n)[scope_ids.long()]


def scoped_topk_ref(queries: torch.Tensor, rows: torch.Tensor,
                    mask: torch.Tensor, k: int = 10, metric: str = "ip",
                    sq: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k with one (n,) mask shared by every query; materialises
    the full (q, n) score matrix."""
    return _masked_topk(row_scores(queries, rows, metric, sq),
                        mask.bool()[None, :], k)


def multi_scope_topk_ref(queries: torch.Tensor, rows: torch.Tensor,
                         mask_words: torch.Tensor, scope_ids: torch.Tensor,
                         k: int = 10, metric: str = "ip",
                         sq: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heterogeneous-batch masked top-k: query i takes row ``scope_ids[i]``
    of the packed (n_scopes, W) mask matrix."""
    return _masked_topk(row_scores(queries, rows, metric, sq),
                        _scope_valid(mask_words, scope_ids, rows.shape[0]),
                        k)


def i8_scores(q_i8: torch.Tensor, q_scale: torch.Tensor,
              rows_i8: torch.Tensor, row_scale: torch.Tensor,
              metric: str = "ip", sq: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """(q, n) fp32 scores of the int8 scan contract
    (``repro/kernels/scoped_topk.py:151-154``): the integer dot of the codes
    (taken in float64, where |dot| <= d * 127^2 is exact, so it equals the
    kernel's int32 sum in any order), rounded to fp32, times
    ``q_scale * row_scale`` formed first; l2 then ``2 s - sq`` with ``sq``
    the dequantized rows' squared norms."""
    dot = q_i8.double() @ rows_i8.double().T
    scores = dot.float() * (q_scale.float()[:, None]
                            * row_scale.float()[None, :])
    if metric == "l2":
        scores = 2.0 * scores - sq.float()[None, :]
    return scores


def pq_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(q, n) fp32 ADC scores: ``lut[q, m, codes[r, m]]`` added for
    m = 0..M-1 in that order (the reference's jnp twin,
    ``repro/vectordb/flat.py:162-174``). Metric-free: the LUT folds it in."""
    lut = lut.float()
    c = codes.long()
    scores = lut[:, 0, :][:, c[:, 0]]
    for m in range(1, codes.shape[1]):
        scores = scores + lut[:, m, :][:, c[:, m]]
    return scores


def scoped_topk_i8_ref(q_i8: torch.Tensor, q_scale: torch.Tensor,
                       rows_i8: torch.Tensor, row_scale: torch.Tensor,
                       sq: Optional[torch.Tensor], mask: torch.Tensor,
                       k: int = 10, metric: str = "ip"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over int8 codes with one (n,) mask for every query."""
    scores = i8_scores(q_i8, q_scale, rows_i8, row_scale, metric, sq)
    return _masked_topk(scores, mask.bool()[None, :], k)


def multi_scope_topk_i8_ref(q_i8: torch.Tensor, q_scale: torch.Tensor,
                            rows_i8: torch.Tensor, row_scale: torch.Tensor,
                            sq: Optional[torch.Tensor],
                            mask_words: torch.Tensor, scope_ids: torch.Tensor,
                            k: int = 10, metric: str = "ip"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`multi_scope_topk_ref`."""
    scores = i8_scores(q_i8, q_scale, rows_i8, row_scale, metric, sq)
    return _masked_topk(scores, _scope_valid(mask_words, scope_ids,
                                             rows_i8.shape[0]), k)


def scoped_topk_pq_ref(lut: torch.Tensor, codes: torch.Tensor,
                       mask: torch.Tensor, k: int = 10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over PQ codes (n, M) through per-query LUTs
    (q, M, 256), one (n,) mask for every query."""
    return _masked_topk(pq_scores(lut, codes), mask.bool()[None, :], k)


def multi_scope_topk_pq_ref(lut: torch.Tensor, codes: torch.Tensor,
                            mask_words: torch.Tensor, scope_ids: torch.Tensor,
                            k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ twin of :func:`multi_scope_topk_ref`."""
    return _masked_topk(pq_scores(lut, codes),
                        _scope_valid(mask_words, scope_ids, codes.shape[0]),
                        k)


def _gathered_topk(cand_ids: torch.Tensor, mask_words: torch.Tensor,
                   scope_ids: torch.Tensor, k: int, score_of
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered (IVF) contract shared by the three plain versions, one
    query at a time (the (B, C, d) gathered block is never built): query b
    scores its candidates ``score_of(b, rows)`` -> (1, C), admits those
    that are not padding (id >= 0) and whose bit is set in its scope row
    ``mask_words[scope_ids[b]]`` (a scope id out of range admits nothing),
    ranks them by (score descending, candidate position ascending) -- the
    tie rule of ``jax.lax.top_k`` over the (B, C) axis -- and returns the
    winners' store ids."""
    B, C = cand_ids.shape
    dev = cand_ids.device
    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        cand = cand_ids[b].long()
        safe = cand.clamp(min=0)
        s = int(scope_ids[b])
        if not 0 <= s < mask_words.shape[0]:
            continue
        bit = (mask_words[s][safe >> 5].long() >> (safe & 31)) & 1
        v, pos = _masked_topk(score_of(b, safe), ((cand >= 0) & (bit != 0))
                              [None, :], k)
        vals[b] = v[0]
        ids[b] = torch.where(pos[0] >= 0, cand[pos[0].long().clamp(min=0)],
                             torch.full_like(cand[:1], -1)).to(torch.int32)
    return vals, ids


def ivf_gather_topk_ref(queries: torch.Tensor, rows: torch.Tensor,
                        cand_ids: torch.Tensor, mask_words: torch.Tensor,
                        scope_ids: torch.Tensor, k: int = 10,
                        metric: str = "ip", sq: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gathered fp32 top-k of the IVF executor: query b ranks the store
    rows ``cand_ids[b]`` (B, C) int32, -1 = CSR padding, that its scope row
    admits; ``sq`` (n,) is read for l2 (computed from the gathered rows
    when omitted)."""
    def score(b, safe):
        return row_scores(queries[b:b + 1], rows[safe], metric,
                          None if sq is None else sq[safe])
    return _gathered_topk(cand_ids, mask_words, scope_ids, k, score)


def ivf_gather_topk_i8_ref(q_i8: torch.Tensor, q_scale: torch.Tensor,
                           rows_i8: torch.Tensor, row_scale: torch.Tensor,
                           sq: Optional[torch.Tensor],
                           cand_ids: torch.Tensor, mask_words: torch.Tensor,
                           scope_ids: torch.Tensor, k: int = 10,
                           metric: str = "ip"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`ivf_gather_topk_ref` (the reference's jnp
    ``_ivf_batch_i8``): scores as :func:`i8_scores`."""
    def score(b, safe):
        return i8_scores(q_i8[b:b + 1], q_scale[b:b + 1], rows_i8[safe],
                         row_scale[safe], metric,
                         None if sq is None else sq[safe])
    return _gathered_topk(cand_ids, mask_words, scope_ids, k, score)


def ivf_gather_topk_pq_ref(lut: torch.Tensor, codes: torch.Tensor,
                           cand_ids: torch.Tensor, mask_words: torch.Tensor,
                           scope_ids: torch.Tensor, k: int = 10
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ/ADC twin of :func:`ivf_gather_topk_ref` (the reference's jnp
    ``_ivf_batch_pq``): scores as :func:`pq_scores`."""
    def score(b, safe):
        return pq_scores(lut[b:b + 1], codes[safe])
    return _gathered_topk(cand_ids, mask_words, scope_ids, k, score)


def _listed_topk(offsets: torch.Tensor, aligned: torch.Tensor,
                 flat_ids: torch.Tensor, max_aligned: int,
                 probe: torch.Tensor, mask_words: torch.Tensor,
                 scope_ids: torch.Tensor, k: int, score_of
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list-form (IVF) contract shared by the three plain versions, one
    query at a time: query b's candidates are the regions of its probed
    lists ``probe[b]``, list ``probe[b, p]``'s offset o at position
    ``p * max_aligned + o`` (offsets past a list's ``aligned`` length are
    padding). It admits the ids that are not padding (>= 0) and whose bit
    is set in its scope row (a scope id out of range admits nothing),
    scores them ``score_of(b, ids)`` -> (1, A), ranks them by (score
    descending, position ascending) and returns the winners' store ids."""
    B = probe.shape[0]
    dev = flat_ids.device
    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        s = int(scope_ids[b])
        if not 0 <= s < mask_words.shape[0]:
            continue
        cand, pos = [], []
        for p, lst in enumerate(probe[b].tolist()):
            start, width = int(offsets[lst]), int(aligned[lst])
            cand.append(flat_ids[start:start + width].long())
            pos.append(p * max_aligned + torch.arange(width, device=dev))
        cand, pos = torch.cat(cand), torch.cat(pos)
        safe = cand.clamp(min=0)
        bit = (mask_words[s][safe >> 5].long() >> (safe & 31)) & 1
        keep = (cand >= 0) & (bit != 0)
        cand, pos = cand[keep], pos[keep]
        if cand.numel() == 0:
            continue
        # positions ascend along ``cand``, so the stable sort's ties fall
        # to the lower position
        v, at = stable_topk(score_of(b, cand), k)
        vals[b] = v[0]
        ids[b] = torch.where(at[0] >= 0, cand[at[0].long().clamp(min=0)],
                             torch.full_like(cand[:1], -1)).to(torch.int32)
    return vals, ids


def ivf_probe_topk_ref(queries: torch.Tensor, rows: torch.Tensor,
                       offsets: torch.Tensor, aligned: torch.Tensor,
                       flat_ids: torch.Tensor, max_aligned: int,
                       probe: torch.Tensor, mask_words: torch.Tensor,
                       scope_ids: torch.Tensor, k: int = 10,
                       metric: str = "ip", sq: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9's list form at fp32: query b ranks the admitted rows of its
    probed lists of the padded-CSR layout (offsets, aligned, flat_ids);
    equal to :func:`ivf_gather_topk_ref` on the expanded (B, nprobe *
    max_aligned) candidate matrix."""
    def score(b, ids):
        return row_scores(queries[b:b + 1], rows[ids], metric,
                          None if sq is None else sq[ids])
    return _listed_topk(offsets, aligned, flat_ids, max_aligned, probe,
                        mask_words, scope_ids, k, score)


def ivf_probe_topk_i8_ref(q_i8: torch.Tensor, q_scale: torch.Tensor,
                          rows_i8: torch.Tensor, row_scale: torch.Tensor,
                          sq: Optional[torch.Tensor], offsets: torch.Tensor,
                          aligned: torch.Tensor, flat_ids: torch.Tensor,
                          max_aligned: int, probe: torch.Tensor,
                          mask_words: torch.Tensor, scope_ids: torch.Tensor,
                          k: int = 10, metric: str = "ip"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 mode of :func:`ivf_probe_topk_ref` (scores as
    :func:`i8_scores`)."""
    def score(b, ids):
        return i8_scores(q_i8[b:b + 1], q_scale[b:b + 1], rows_i8[ids],
                         row_scale[ids], metric,
                         None if sq is None else sq[ids])
    return _listed_topk(offsets, aligned, flat_ids, max_aligned, probe,
                        mask_words, scope_ids, k, score)


def ivf_probe_topk_pq_ref(lut: torch.Tensor, codes: torch.Tensor,
                          offsets: torch.Tensor, aligned: torch.Tensor,
                          flat_ids: torch.Tensor, max_aligned: int,
                          probe: torch.Tensor, mask_words: torch.Tensor,
                          scope_ids: torch.Tensor, k: int = 10
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ/ADC mode of :func:`ivf_probe_topk_ref` (scores as
    :func:`pq_scores`)."""
    def score(b, ids):
        return pq_scores(lut[b:b + 1], codes[ids])
    return _listed_topk(offsets, aligned, flat_ids, max_aligned, probe,
                        mask_words, scope_ids, k, score)


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


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length_mask: torch.Tensor) -> torch.Tensor:
    """Plain GQA attention for one query token (no flash blocking), the
    PyTorch form of ``repro/kernels/ref.py::flash_decode_ref``: q (b, h, d),
    k, v (b, kv_h, s, d), length_mask (b, s) -> (b, h, d) in q's type. fp32
    einsums and softmax; masked scores are ``NEG_INF`` and masked weights 0,
    so a row with no admitted position gives zeros."""
    b, h, d = q.shape
    kv_h = k.shape[1]
    qg = q.reshape(b, kv_h, h // kv_h, d).float()
    scale = 1.0 / float(np.sqrt(d))
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    valid = length_mask.bool()[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length_mask: torch.Tensor,
                           n_split: int) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch, a test oracle (never
    on the main path): each split of ``flash_decode.split_ranges(s,
    n_split)`` walks its 64-position tiles with ``_kernel``'s running fp32
    (m, l, acc), p rounded to the cache's type against the split's running
    max; then the splits merge in order, M = max m_i, l = sum l_i
    e^(m_i - M), acc = sum acc_i e^(m_i - M), and the output is
    acc / max(l, 1e-30) in q's type. A split that admits nothing keeps
    (finfo.min, 0, 0) and drops out."""
    b, h, d = q.shape
    kv_h = k.shape[1]
    qg = q.reshape(b, kv_h, h // kv_h, d).float()
    scale = 1.0 / float(np.sqrt(d))
    valid_all = length_mask.bool()[:, None, None, :]
    parts = []
    for start, stop in split_ranges(k.shape[2], n_split):
        m = torch.full((*qg.shape[:3], 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qg)
        for p0 in range(start, stop, SPLIT_TILE):
            p1 = min(p0 + SPLIT_TILE, stop)
            valid = valid_all[..., p0:p1]
            sc = torch.einsum("bkgd,bksd->bkgs", qg,
                              k[:, :, p0:p1].float()) * scale
            sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(sc - m_new),
                            torch.zeros_like(sc))
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgs,bksd->bkgd", p.to(v.dtype).float(),
                v[:, :, p0:p1].float())
            m = m_new
        parts.append((m, l, acc))
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    l_all = torch.zeros_like(top)
    acc_all = torch.zeros_like(qg)
    for m, l, acc in parts:
        f = torch.exp(m - top)
        l_all = l_all + l * f
        acc_all = acc_all + acc * f
    out = acc_all / torch.clamp(l_all, min=1e-30)
    return out.reshape(b, h, d).to(q.dtype)


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
