"""Flat (brute-force) masked top-k executor at fp32 — exact oracle + baseline.

Two execution plans, chosen by scope selectivity exactly as selective-filter
vector databases do (pre- vs post-filter):

* ``gather``: gather the |C| candidate rows on the device and score only
  those — optimal for selective scopes (|C| << N);
* ``scan``: score all N rows with out-of-scope lanes masked — optimal for
  broad scopes.

Both plans rank through the hand-written ``scoped_topk`` kernel (the gather
plan with an all-ones mask over its gathered rows), and a batch of scan-plan
requests through ``multi_scope_topk``. The kernels score every (query, row)
pair with the same fixed-order fp32 FMA chain, so a request's scores do not
depend on how many requests share a launch: ``dsq_batch`` stays
bit-identical to a loop of ``dsq``. (A cuBLAS matmul picks other kernels for
other batch sizes and could not promise that.)

Sentinels: the kernels return ``finfo(float32).min`` / -1 for empty lanes;
this executor returns ``-inf`` / -1 like the reference executor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.common import unpack_words
# the hand-set crossover lives in costmodel (re-exported here because this
# module owns the decision *rule* that consumes it)
from .costmodel import GATHER_THRESHOLD, model_of
from .store import VectorStore, pack_ids_to_words

_QUANTIZED = ("int8", "pq")


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


def _to_host(vals: torch.Tensor, ids: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Kernel sentinels (finfo.min, -1) -> executor sentinels (-inf, -1)."""
    vals = vals.cpu().numpy()
    ids = ids.cpu().numpy().astype(np.int64)
    vals[ids < 0] = -np.inf
    return vals, ids


def _fp32_only(precision: str) -> None:
    if precision in _QUANTIZED:
        raise NotImplementedError(
            f"precision={precision!r} waits for the int8/PQ slice of the "
            f"port (ROADMAP queue 1 item 4)")
    if precision != "fp32":
        raise ValueError(f"precision {precision!r} not in (fp32, int8, pq)")


class FlatExecutor:
    name = "flat"

    def __init__(self, store: VectorStore):
        self.store = store

    def _sq(self) -> Optional[torch.Tensor]:
        """Cached device squared norms for l2, None for ip/cos."""
        return (self.store.device_sq_norms()
                if self.store.metric == "l2" else None)

    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(queries)).to(
            self.store.device)

    def search(self, queries: np.ndarray, k: int,
               candidate_ids: Optional[np.ndarray] = None,
               plan: Optional[str] = None, precision: str = "fp32",
               rescore_k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores, ids), both (q, k); ids == -1 past the scope
        size. Only ``precision="fp32"`` is ported; ``rescore_k`` is read by
        the quantized plans only."""
        _fp32_only(precision)
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
        kk = min(k, m)
        dev = self.store.device
        q = self._queries(queries)
        if plan == "gather":
            cand = torch.from_numpy(
                np.asarray(candidate_ids, dtype=np.int64)).to(dev)
            rows = self.store.device_vectors().index_select(0, cand)
            sq = self._sq()
            if sq is not None:
                sq = sq.index_select(0, cand)
            ones = torch.ones(m, dtype=torch.int8, device=dev)
            vals, local = kops.scoped_topk(q, rows, ones, kk,
                                           self.store.metric, sq=sq)
            ids = torch.where(local >= 0, cand[local.long().clamp(min=0)],
                              torch.full_like(cand[:1], -1))
        else:
            words = torch.from_numpy(
                pack_ids_to_words(candidate_ids, n).view(np.int32)).to(dev)
            mask = unpack_words(words, n).to(torch.int8)
            vals, ids = kops.scoped_topk(q, self.store.device_vectors(),
                                         mask, kk, self.store.metric,
                                         sq=self._sq())
        return pad_topk(*_to_host(vals, ids), k)

    def search_multi(self, queries: np.ndarray, mask_words: torch.Tensor,
                     scope_ids: np.ndarray, k: int, precision: str = "fp32",
                     rescore_k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One launch for a heterogeneous scan-plan batch: queries (B, d),
        packed masks (n_scopes, ceil(n/32)) as an int32 tensor on the
        store's device, per-query scope row ids (B,). Returns (scores, ids)
        both (B, k), ids int64, -1 / -inf where the scope had no
        candidate."""
        _fp32_only(precision)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        dev = self.store.device
        sids = torch.from_numpy(
            np.asarray(scope_ids, dtype=np.int32)).to(dev)
        vals, ids = kops.multi_scope_topk(
            self._queries(queries), self.store.device_vectors(),
            kops.as_words(mask_words).to(dev), sids, k, self.store.metric,
            sq=self._sq())
        return _to_host(vals, ids)
