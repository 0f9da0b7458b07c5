"""Flat (brute-force) masked top-k executor — exact oracle + baseline, at
fp32, int8 and PQ precision.

Two execution plans, chosen by scope selectivity exactly as selective-filter
vector databases do (pre- vs post-filter):

* ``gather``: gather the |C| candidate rows on the device and score only
  those — optimal for selective scopes (|C| << N);
* ``scan``: score all N rows with out-of-scope lanes masked — optimal for
  broad scopes.

Both plans rank through the hand-written scan kernels (the gather plan with
an all-ones mask over its gathered rows), and a batch of scan-plan requests
through one ``multi_scope_topk*`` launch. ``precision="int8"`` / ``"pq"``
run the two-phase plan: the int8 (or PQ/ADC) scan or gather keeps
``rescore_k >= k`` candidates, and :func:`gather_rescore` ranks exactly
those in exact fp32, so the final scores are true fp32 scores and the only
approximation is which candidates survive phase 1.

The kernels score every (query, row) pair with one fixed-order chain (fp32
FMAs, exact int32 sums, or LUT adds in subspace order), and the rescore
scores its gathered rows through the same fp32 kernel, so a request's
scores do not depend on how many requests share a launch: ``dsq_batch``
stays bit-identical to a loop of ``dsq`` at every precision. (A cuBLAS
matmul or a torch reduction picks other kernels for other batch sizes and
could not promise that.)

Sentinels: the kernels return ``finfo(float32).min`` / -1 for empty lanes;
this executor returns ``-inf`` / -1 like the reference executor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..kernels import ops as kops
from ..kernels.common import unpack_words
# the hand-set crossover lives in costmodel (re-exported here because this
# module owns the decision *rule* that consumes it)
from .costmodel import GATHER_THRESHOLD, model_of
from .quant import quantize_rows, resolve_rescore_k
from .store import VectorStore, pack_ids_to_words

PRECISIONS = ("fp32", "int8", "pq")


def choose_plan(m: int, n: int, k: int,
                threshold: float = GATHER_THRESHOLD) -> str:
    """THE gather/scan decision rule. ``FlatExecutor.search`` and the
    ``BatchPlanner`` both delegate here — the batch==loop bit-identity
    contract requires every path to pick the same plan for the same scope.
    Calibrated deployments pass ``threshold=model.gather_threshold(n, k)``;
    the rule itself never changes, only the measured crossover."""
    return "gather" if m <= max(k, threshold * n) else "scan"


def pad_topk(scores: np.ndarray, ids: np.ndarray,
             k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad (q, kk) results to (q, k) with the -inf / -1 sentinels."""
    kk = scores.shape[1]
    if kk >= k:
        return scores, np.asarray(ids, dtype=np.int64)
    q = scores.shape[0]
    pad_s = np.full((q, k - kk), -np.inf, np.float32)
    pad_i = np.full((q, k - kk), -1, np.int64)
    return (np.concatenate([scores, pad_s], axis=1),
            np.concatenate([np.asarray(ids, np.int64), pad_i], axis=1))


def _to_host(vals: Optional[torch.Tensor], ids: torch.Tensor,
             tiles: Optional[trace.Tiles] = None):
    """The ranking layer's copies back to the host: ``ids`` as int64 and,
    given ``vals``, (scores, ids) with the kernels' sentinels (finfo.min,
    -1) turned into the executor's (-inf, -1). Inside an executor call
    (``tiles``) the copies run in its ``rank.get`` phase and are counted:
    each waits for the device work queued before it."""
    if tiles is not None:
        tiles.to(trace.GET)
    host_vals = None if vals is None else vals.cpu().numpy()
    host_ids = ids.cpu().numpy().astype(np.int64)
    if tiles is not None:
        tiles.synced(1 if vals is None else 2)
    if host_vals is None:
        return host_ids
    host_vals[host_ids < 0] = -np.inf
    return host_vals, host_ids


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def _window_words(valid: np.ndarray) -> np.ndarray:
    """(B, R) bool -> (B, ceil(B*R/32)) packed words in which row b admits
    exactly its own valid lanes of the concatenated (B*R) candidates."""
    B, R = valid.shape
    dense = np.zeros((B, -(-B * R // 32) * 32), dtype=bool)
    cols = np.arange(B)[:, None] * R + np.arange(R)[None, :]
    dense[np.repeat(np.arange(B), R), cols.ravel()] = valid.ravel()
    return np.packbits(dense, axis=1, bitorder="little").view(np.uint32)


def gather_rescore(store: VectorStore, queries: np.ndarray,
                   cand_ids: np.ndarray, k: int, fetch: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact fp32 gather-rescore of approximate-phase candidates — the back
    half of every two-phase path. ``cand_ids`` is (B, R) int64 store ids
    with -1 padding; returns (scores, ids) both (B, k), -1/-inf padded.

    The (B, R) windows are gathered as one (B*R, d) block and ranked by one
    ``multi_scope_topk`` launch in which query b's scope row admits its own
    R-slice: the fixed-order fp32 kernel scores each (query, row) pair the
    same whatever B is, so the rescore keeps ``dsq_batch`` bitwise equal to
    a loop of ``dsq``. In a tiered store the rows come from host RAM, and
    every valid candidate outside the device-pinned hot set counts as a
    host->device fetch. ``fetch=False`` ranks rows that are not a rescore
    window (the IVF executor's exact fp32 candidates in a tiered store):
    they are read as the flat gather plan reads its rows, neither counted
    as fetched nor behind the ``store.host_fetch`` seam."""
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    cand_ids = np.asarray(cand_ids, dtype=np.int64)
    cand_ids = np.where(cand_ids < len(store), cand_ids, -1)
    B, R = cand_ids.shape
    if fetch and store.tiered_active():
        fetched = cand_ids >= 0
        pm = store.pinned_mask()
        if pm is not None:
            fetched = fetched & ~pm[np.maximum(cand_ids, 0)]
        n_fetch = int(np.count_nonzero(fetched))
        store.rescore_fetch_rows += n_fetch
        store.rescore_fetch_bytes += n_fetch * store.dim * 4
    kk = min(k, R)
    if kk == 0:
        return pad_topk(np.zeros((B, 0), np.float32),
                        np.zeros((B, 0), np.int64), k)
    with trace.Tiles() as tiles:
        flat_ids = np.maximum(cand_ids, 0).reshape(-1)
        dev = store.device
        q = torch.from_numpy(queries).to(dev)
        words = torch.from_numpy(
            _window_words(cand_ids >= 0).view(np.int32)).to(dev)
        sq_idx = (torch.from_numpy(flat_ids).to(dev)
                  if store.metric == "l2" else None)
        tiles.to(trace.RUN)
        rows = store.device_rows(flat_ids, fetch=fetch)     # (B*R, d)
        sq = (None if sq_idx is None
              else store.device_sq_norms().index_select(0, sq_idx))
        sids = torch.arange(B, dtype=torch.int32, device=dev)
        vals, loc = kops.multi_scope_topk(q, rows, words, sids, kk,
                                          store.metric, sq=sq)
        vals, loc = _to_host(vals, loc, tiles)
        tiles.to(trace.RUN)
        ids = np.where(loc >= 0, cand_ids.reshape(-1)[np.maximum(loc, 0)],
                       -1)
        return pad_topk(vals, ids, k)


class FlatExecutor:
    name = "flat"

    def __init__(self, store: VectorStore):
        self.store = store

    def _sq(self) -> Optional[torch.Tensor]:
        """Cached device squared norms for l2, None for ip/cos."""
        return (self.store.device_sq_norms()
                if self.store.metric == "l2" else None)

    def _q_sq(self) -> Optional[torch.Tensor]:
        """int8-tier counterpart of :meth:`_sq` (dequantized-row norms)."""
        return (self.store.device_q_sq_norms()
                if self.store.metric == "l2" else None)

    def _to_dev(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.store.device)

    def _scope_words(self, candidate_ids: np.ndarray) -> torch.Tensor:
        """A scope's packed words, uploaded."""
        return self._to_dev(pack_ids_to_words(
            candidate_ids, len(self.store)).view(np.int32))

    def _scope_mask(self, words: torch.Tensor) -> torch.Tensor:
        """(n,) int8 device mask of a scope, from its packed words."""
        return unpack_words(words, len(self.store)).to(torch.int8)

    def search(self, queries: np.ndarray, k: int,
               candidate_ids: Optional[np.ndarray] = None,
               plan: Optional[str] = None, precision: str = "fp32",
               rescore_k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores, ids), both (q, k); ids == -1 past the scope
        size. ``precision="int8"`` / ``"pq"`` run the two-phase plan
        (``rescore_k`` candidates, exact fp32 rescore); a gather scope the
        rescore window covers entirely stays exact fp32 (the rule the
        ``BatchPlanner`` applies per group)."""
        _check_precision(precision)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        n = len(self.store)
        if candidate_ids is None:
            candidate_ids = np.arange(n, dtype=np.uint32)
        m = len(candidate_ids)
        if m == 0:
            q = queries.shape[0]
            return (np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int64))
        if plan is None:
            plan = choose_plan(
                m, n, k, model_of(self.store).gather_threshold(n, k))
        if precision != "fp32":
            r = resolve_rescore_k(k, rescore_k, m)
            if not (plan == "gather" and m <= r):
                cand = self._select(queries, candidate_ids, plan, r,
                                    precision)
                return gather_rescore(self.store, queries, cand, k)
        kk = min(k, m)
        with trace.Tiles() as tiles:
            q = self._to_dev(queries)
            if plan == "gather":
                cand_np = np.asarray(candidate_ids, dtype=np.int64)
                cand = self._to_dev(cand_np)
                tiles.to(trace.RUN)
                rows = self.store.device_rows(cand_np)
                sq = self._sq()
                if sq is not None:
                    sq = sq.index_select(0, cand)
                ones = torch.ones(m, dtype=torch.int8, device=q.device)
                vals, local = kops.scoped_topk(q, rows, ones, kk,
                                               self.store.metric, sq=sq)
                ids = torch.where(local >= 0,
                                  cand[local.long().clamp(min=0)],
                                  torch.full_like(cand[:1], -1))
            else:
                words = self._scope_words(candidate_ids)
                tiles.to(trace.RUN)
                vals, ids = kops.scoped_topk(q, self.store.device_vectors(),
                                             self._scope_mask(words), kk,
                                             self.store.metric, sq=self._sq())
            vals, ids = _to_host(vals, ids, tiles)
        return pad_topk(vals, ids, k)

    def _select(self, queries: np.ndarray, candidate_ids: np.ndarray,
                plan: str, r: int, precision: str) -> np.ndarray:
        """Phase 1 of the two-phase plan: (q, r') int64 store ids, -1
        padded, that the int8 or PQ scan (or gather) keeps."""
        st = self.store
        n = len(st)
        with trace.Tiles() as tiles:
            if plan == "gather":
                cand = self._to_dev(np.asarray(candidate_ids,
                                               dtype=np.int64))
                words = None
                r_eff = r
            else:
                cand = None
                words = self._scope_words(candidate_ids)
                r_eff = min(r, n)
            if precision == "int8":
                q_i8, q_s = quantize_rows(queries)
                q_dev = (self._to_dev(q_i8), self._to_dev(q_s))
            else:
                q_dev = (self._to_dev(st.pq_lut(queries)),)
            tiles.to(trace.RUN)
            mask = (torch.ones(len(candidate_ids), dtype=torch.int8,
                               device=cand.device)
                    if words is None else self._scope_mask(words))

            def rows_of(t: torch.Tensor) -> torch.Tensor:
                return t if cand is None else t.index_select(0, cand)

            if precision == "int8":
                sq = self._q_sq()
                _, ids = kops.scoped_topk_i8(
                    *q_dev, rows_of(st.device_q_vectors()),
                    rows_of(st.device_q_scales()),
                    None if sq is None else rows_of(sq), mask, r_eff,
                    st.metric)
            else:
                _, ids = kops.scoped_topk_pq(
                    *q_dev, rows_of(st.device_pq_codes()), mask, r_eff)
            if cand is not None:
                ids = torch.where(ids >= 0, cand[ids.long().clamp(min=0)],
                                  torch.full_like(cand[:1], -1))
            return _to_host(None, ids, tiles)

    def search_multi(self, queries: np.ndarray, mask_words: torch.Tensor,
                     scope_ids: np.ndarray, k: int, precision: str = "fp32",
                     rescore_k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One launch for a heterogeneous scan-plan batch: queries (B, d),
        packed masks (n_scopes, ceil(n/32)) as an int32 tensor on the
        store's device, per-query scope row ids (B,). Returns (scores, ids)
        both (B, k), ids int64, -1 / -inf where the scope had no candidate.
        ``precision="int8"`` / ``"pq"`` swap the launch for the quantized
        scan and finish with the shared exact fp32 rescore."""
        _check_precision(precision)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        st = self.store
        with trace.Tiles() as tiles:
            words = kops.as_words(mask_words).to(st.device)
            sids = self._to_dev(np.asarray(scope_ids, dtype=np.int32))
            if precision == "fp32":
                q = self._to_dev(queries)
                tiles.to(trace.RUN)
                vals, ids = kops.multi_scope_topk(
                    q, st.device_vectors(), words, sids, k, st.metric,
                    sq=self._sq())
                return _to_host(vals, ids, tiles)
            r = resolve_rescore_k(k, rescore_k, len(st))
            if precision == "int8":
                q_i8, q_s = quantize_rows(queries)
                q_dev = (self._to_dev(q_i8), self._to_dev(q_s))
                tiles.to(trace.RUN)
                _, cand = kops.multi_scope_topk_i8(
                    *q_dev, st.device_q_vectors(), st.device_q_scales(),
                    self._q_sq(), words, sids, r, st.metric)
            else:
                q_dev = self._to_dev(st.pq_lut(queries))
                tiles.to(trace.RUN)
                _, cand = kops.multi_scope_topk_pq(
                    q_dev, st.device_pq_codes(), words, sids, r)
            cand = _to_host(None, cand, tiles)
        return gather_rescore(st, queries, cand, k)
