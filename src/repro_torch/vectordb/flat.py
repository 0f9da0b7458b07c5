"""Flat (brute-force) masked top-k executor — exact oracle + baseline, at
fp32, int8 and PQ precision.

Two execution plans, chosen by scope selectivity exactly as selective-filter
vector databases do (pre- vs post-filter):

* ``gather``: gather the |C| candidate rows on the device and score only
  those — optimal for selective scopes (|C| << N);
* ``scan``: score all N rows with out-of-scope lanes masked — optimal for
  broad scopes.

Both plans rank through the hand-written scan kernels: a single request's
gather plan through kernel 1 with an all-ones mask over its gathered rows,
a batch's scan-plan requests through one ``multi_scope_topk*`` launch, and
a batch's fp32 gather-plan scopes through one launch of kernel 9's list
form (``search_multi(..., candidate_lists=...)``): each request ranks its
scope's id list, whose rows are read in place from the device mirror, with
no gathered copy. ``precision="int8"`` / ``"pq"`` run the two-phase plan:
the int8 (or PQ/ADC) scan or gather keeps ``rescore_k >= k`` candidates,
and :func:`gather_rescore` ranks exactly those in exact fp32, so the final
scores are true fp32 scores and the only approximation is which candidates
survive phase 1.

The kernels score every (query, row) pair with one fixed-order chain (fp32
FMAs, exact int32 sums, or LUT adds in subspace order), and the rescore
scores its gathered rows through the same fp32 kernel, so a request's
scores do not depend on how many requests share a launch, nor on which of
kernels 1, 2 and 9 ranks it: ``dsq_batch`` stays bit-identical to a loop of
``dsq`` at every precision. (A cuBLAS matmul or a torch reduction picks
other kernels for other batch sizes and could not promise that.)

Sentinels: the kernels return ``finfo(float32).min`` / -1 for empty lanes;
this executor returns ``-inf`` / -1 like the reference executor.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    as fetched nor behind the ``store.host_fetch`` seam. The whole call is
    the ``rank.rescore`` region (``rescore_ns``)."""
    with trace.rescore():
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


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int64): torch.int64}


def _staged(device: torch.device, parts):
    """One host->device copy of several 1-D arrays: ``parts`` is a list of
    (numpy dtype of 4 or 8 bytes, length). Returns (host views to fill,
    ``upload``), where ``upload()`` copies the filled buffer to ``device``
    and returns a device view of each part. The buffer is one int32
    tensor, pinned on a card so that the copy does not block the host
    (PyTorch's pinned allocator keeps the block until the copy has run);
    each part starts on a 16-byte boundary.

    Few torch calls: the executing thread shares the interpreter with the
    scheduler's staging thread, and a torch call releases the interpreter
    lock, which can take that thread's switch interval to come back. On
    an H100 host under a saturating closed loop this form took 4-5 ms less
    a list call than three pinned ``np.concatenate`` copies, one a dtype."""
    spans, total = [], 0
    for dtype, n in parts:
        words = np.dtype(dtype).itemsize // 4 * n
        spans.append((total, total + words))
        total += -(-words // 4) * 4
    host = torch.empty(max(total, 4), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    raw = host.numpy()
    views = [raw[a:b].view(dtype) for (a, b), (dtype, _) in zip(spans, parts)]

    def upload():
        dev = host.to(device, non_blocking=True)
        return [dev[a:b] if np.dtype(dtype) == np.int32
                else dev[a:b].view(_TORCH_DTYPES[np.dtype(dtype)])
                for (a, b), (dtype, _) in zip(spans, parts)]
    return views, upload


class FlatExecutor:
    name = "flat"

    def __init__(self, store: VectorStore):
        self.store = store
        self._ones: Optional[torch.Tensor] = None

    def _ones_row(self, n: int) -> torch.Tensor:
        """(1, ceil(n/32)) int32 packed row that admits every row of an
        n-row store, on the store's device (kept while n's word count
        holds)."""
        w = max(1, -(-n // 32))
        ones = self._ones
        if ones is None or ones.shape[1] != w or \
                ones.device != self.store.device:
            ones = torch.full((1, w), -1, dtype=torch.int32,
                              device=self.store.device)
            self._ones = ones
        return ones

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
                with trace.approx():
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

    def search_multi(self, queries: np.ndarray,
                     mask_words: Optional[torch.Tensor],
                     scope_ids: np.ndarray, k: int, precision: str = "fp32",
                     rescore_k: Optional[int] = None,
                     candidate_lists: Optional[Sequence[np.ndarray]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One launch for a heterogeneous batch: queries (B, d), per-query
        scope ids (B,). Returns (scores, ids) both (B, k), ids int64, -1 /
        -inf where the scope had no candidate.

        Scan-plan scopes: ``mask_words`` holds packed masks (n_scopes,
        ceil(n/32)) as an int32 tensor on the store's device, and
        ``scope_ids`` indexes its rows. ``precision="int8"`` / ``"pq"`` swap
        the launch for the quantized scan and finish with the shared exact
        fp32 rescore.

        Gather-plan scopes: ``candidate_lists`` holds each scope's sorted,
        distinct store ids, ``scope_ids`` indexes it and ``mask_words`` is
        None. One launch of kernel 9's list form ranks each query over its
        scope's rows, read in place from the device mirror (fp32 only, and
        not while the store is tiered, whose rows live in host RAM); a tie
        goes to the lower position in the list, the lower store id, as in
        :meth:`search`'s gather plan, so each request equals its own
        ``search`` bit for bit."""
        _check_precision(precision)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        st = self.store
        if candidate_lists is not None:
            if mask_words is not None or precision != "fp32":
                raise ValueError("candidate lists rank at fp32 and take no "
                                 "mask words")
            return self._search_listed(queries, candidate_lists, scope_ids,
                                       k)
        if precision != "fp32":
            with trace.approx():
                cand = self._select_multi(queries, mask_words, scope_ids,
                                          resolve_rescore_k(k, rescore_k,
                                                            len(st)),
                                          precision)
            return gather_rescore(st, queries, cand, k)
        with trace.Tiles() as tiles:
            words = kops.as_words(mask_words).to(st.device)
            sids = self._to_dev(np.asarray(scope_ids, dtype=np.int32))
            q = self._to_dev(queries)
            tiles.to(trace.RUN)
            vals, ids = kops.multi_scope_topk(
                q, st.device_vectors(), words, sids, k, st.metric,
                sq=self._sq())
            return _to_host(vals, ids, tiles)

    def _select_multi(self, queries: np.ndarray, mask_words: torch.Tensor,
                      scope_ids: np.ndarray, r: int,
                      precision: str) -> np.ndarray:
        """Phase 1 of :meth:`search_multi`'s two-phase plan: (B, r) int64
        store ids, -1 padded, that one int8 or PQ scan launch keeps."""
        st = self.store
        with trace.Tiles() as tiles:
            words = kops.as_words(mask_words).to(st.device)
            sids = self._to_dev(np.asarray(scope_ids, dtype=np.int32))
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
            return _to_host(None, cand, tiles)

    def _search_listed(self, queries: np.ndarray,
                       lists: Sequence[np.ndarray], scope_ids: np.ndarray,
                       k: int) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`search_multi` over candidate lists: list g of kernel 9's
        layout holds scope g's ids, unpadded, and query b probes list
        ``scope_ids[b]`` alone, under a scope row that admits every row.
        The layout, the queries and the probes go up in one copy."""
        st = self.store
        if st.tiered_active():
            raise RuntimeError("the store is over its device byte budget: "
                               "rank its gather scopes one by one")
        sids = np.asarray(scope_ids, dtype=np.int64)
        B, d = queries.shape
        G = len(lists)
        if B == 0 or G == 0:
            return (np.full((B, k), -np.inf, np.float32),
                    np.full((B, k), -1, np.int64))
        with trace.Tiles() as tiles:
            sizes = np.fromiter(map(len, lists), np.int64, G)
            ends = np.cumsum(sizes)
            (q, lay, probe, zeros, flat_ids), upload = _staged(
                st.device, [(np.float32, B * d), (np.int64, 2 * G),
                            (np.int32, B), (np.int32, B),
                            (np.int32, int(ends[-1]))])
            q[:] = queries.reshape(-1)
            lay[0] = 0
            lay[1:G] = ends[:-1]
            lay[G:] = sizes
            probe[:] = sids
            zeros[:] = 0
            # one join: numpy's concatenate releases the interpreter lock
            # once an input (and may wait to get it back each time)
            flat_ids[:] = np.frombuffer(b"".join(
                np.ascontiguousarray(ids, dtype=np.uint32) for ids in lists),
                dtype=np.int32)
            q, lay, probe, zeros, flat_ids = upload()
            tiles.to(trace.RUN)
            rows = st.device_vectors()
            vals, ids = kops.ivf_probe_topk(
                q.view(B, d), rows, lay[:G], lay[G:], flat_ids,
                int(sizes.max()), probe[:, None],
                self._ones_row(rows.shape[0]), zeros, k, st.metric,
                sq=self._sq(), check_ids=False,
                per_list=int(np.bincount(sids, minlength=G).max()))
            return _to_host(vals, ids, tiles)
