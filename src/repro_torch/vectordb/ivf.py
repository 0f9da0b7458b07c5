"""IVF (inverted-file) partition-based ANN executor on one torch device.

K-means (Lloyd) runs on the store's device. Partitions live in a
device-resident **padded-CSR layout**: one flat int32 id array where every
list occupies a TILE-aligned region (padding slots hold -1), plus per-list
offsets and lengths. Search is batched end to end: query-to-centroid
distances and ``nprobe`` selection for the whole batch, then ONE
``ivf_probe_topk*`` launch that reads the probed lists' ids from the layout
and their rows from the store in place, ANDs in each query's packed scope
words, scores at fp32, int8 or PQ and keeps the top-k. The reference
expands each query's probed regions into a (B, nprobe * max_aligned)
candidate matrix and feeds its Pallas kernel a gathered (B, C, d) block;
the card path builds neither (the tiered fork and the tests still expand,
:func:`_expand`).

Bitwise contracts (``dsq_batch`` == a loop of ``dsq``, and a replayed
``repartition`` == the first): the probe distances are elementwise and
summed by a fixed pairwise tree, so a query's probed set does not depend
on the batch; the kernel scores each (query, candidate) pair with one
fixed-order chain; k-means uses matmuls, reductions and an argmin, none with
atomics (a float ``index_add_`` on CUDA would be), so it repeats bit for
bit on one card. Torch and XLA round k-means differently, so the port's
partitions are not the reference's; ``convert.ivf_from_state`` hands the
port a reference index's lists without training.

``search_loop`` keeps the reference's per-query numpy host loop as the
oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .costmodel import model_of
from .flat import _check_precision, _to_host, gather_rescore, pad_topk
from .quant import quantize_rows, resolve_rescore_k
from .store import VectorStore, pack_ids_to_words

# Per-list padding granularity of the CSR layout (the reference's TILE).
TILE = 32


def _sq_dists(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, L) squared distances in the reference's expanded form
    ``|x|^2 - 2 x.c + |c|^2``."""
    return ((data * data).sum(1)[:, None] - 2.0 * data @ centers.T
            + (centers * centers).sum(1)[None, :])


def _assign(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest center per row; ties go to the lower center index."""
    return torch.argmin(_sq_dists(data, centers), dim=1)


def _lloyd(data: torch.Tensor, init: torch.Tensor,
           n_iters: int) -> torch.Tensor:
    """Plain Lloyd iterations; empty clusters keep their previous center.
    The cluster sums are a one-hot matmul, as in the reference, not a
    scatter-add (atomics would make runs differ)."""
    centers = init.clone()
    n, L = data.shape[0], centers.shape[0]
    rows = torch.arange(n, device=data.device)
    for _ in range(n_iters):
        assign = _assign(data, centers)
        one_hot = torch.zeros((n, L), dtype=data.dtype, device=data.device)
        one_hot[rows, assign] = 1.0
        counts = one_hot.sum(0)
        sums = one_hot.T @ data
        centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp(min=1)[:, None], centers)
    return centers


def probe_distances(queries: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """(B, L) squared query-center distances ``sum_j (q_j - c_j)^2``. Each
    element depends on its own (query, center) pair only: the squares are
    elementwise and summed by a fixed pairwise tree over j (zero-padded to
    an even width at each level), so the bits do not depend on B or on the
    device's reduction kernels."""
    diff = queries[:, None, :] - centers[None, :, :]
    acc = diff * diff
    while acc.shape[-1] > 1:
        if acc.shape[-1] % 2:
            acc = torch.nn.functional.pad(acc, (0, 1))
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


@dataclass(frozen=True)
class CSRLayout:
    """Device-resident padded-CSR partition layout. ``flat_ids`` is one flat
    int32 array; list ``c`` occupies ``[offsets[c], offsets[c]+aligned[c])``
    with its ``aligned[c] - len`` padding slots, and the final extra slot
    that out-of-region expansion clamps to, holding -1 (the reference holds
    the store size there and maps it to -1 before its kernel).

    A query's candidate axis gives every probed list ``max_aligned``
    positions (the reference's expansion); the card path reads each probed
    list's own region only, once per tile of the queries that probe it."""
    offsets: torch.Tensor    # (n_lists,) int64, TILE-aligned region starts
    aligned: torch.Tensor    # (n_lists,) int64, padded region lengths
    flat_ids: torch.Tensor   # (sum(aligned) + 1,) int32
    max_aligned: int         # widest padded region
    n: int                   # store size the layout was built for


def _probe(queries: torch.Tensor, centers: torch.Tensor,
           nprobe: int) -> torch.Tensor:
    """Whole-batch probe selection: (B, nprobe) int64 center ids by
    ascending distance, ties to the lower center index (a stable sort, as
    ``lax.top_k(-d2)``)."""
    d2 = probe_distances(queries, centers)
    return torch.sort(d2, dim=1, stable=True).indices[:, :nprobe]


def _expand(lay: CSRLayout, probe: torch.Tensor) -> torch.Tensor:
    """The reference's candidate expansion: (B, C) int32 store ids,
    C = nprobe * max_aligned, probed list p's region at positions
    p * max_aligned + o, -1 for padding."""
    within = torch.arange(lay.max_aligned, device=probe.device)
    idx = lay.offsets[probe][..., None] + within
    idx = torch.where(within < lay.aligned[probe][..., None], idx,
                      lay.flat_ids.shape[0] - 1)     # clamp to the sentinel
    return lay.flat_ids[idx].reshape(probe.shape[0], -1)


def _admitted(cand: torch.Tensor, words: torch.Tensor,
              sids: torch.Tensor) -> np.ndarray:
    """(B, A) int64 store ids each query's scope row admits among its
    candidates, in candidate order, -1 padded (A = the most any query
    admits; a scope id out of range admits nothing)."""
    S = words.shape[0]
    in_range = (sids >= 0) & (sids < S)
    qwords = words[sids.long().clamp(0, max(S - 1, 0))]
    safe = cand.clamp(min=0).long()
    bit = (torch.gather(qwords, 1, safe >> 5).long() >> (safe & 31)) & 1
    adm = (cand >= 0) & (bit != 0) & in_range[:, None]
    width = int(adm.sum(1).max()) if adm.numel() else 0
    first = torch.sort((~adm).to(torch.uint8), dim=1, stable=True).indices
    first = first[:, :width]
    return torch.where(torch.gather(adm, 1, first),
                       torch.gather(cand, 1, first),
                       -1).cpu().numpy().astype(np.int64)


def _member_arrays(sorted_ids: np.ndarray, counts: np.ndarray
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Amortized-capacity member arrays from ids grouped by list."""
    starts = np.concatenate([[0], np.cumsum(counts)])
    data: List[np.ndarray] = []
    lens = np.zeros(len(counts), dtype=np.int64)
    for c in range(len(counts)):
        members = sorted_ids[starts[c]: starts[c + 1]]
        arr = np.empty(max(8, len(members)), dtype=np.uint32)
        arr[: len(members)] = members
        data.append(arr)
        lens[c] = len(members)
    return data, lens


class IVFIndex:
    name = "ivf"

    def __init__(self, store: VectorStore, n_lists: int = 64,
                 n_iters: int = 10, seed: int = 0):
        self.store = store
        self.n_lists = n_lists
        data = store.vectors
        rng = np.random.default_rng(seed)
        init = data[rng.choice(len(data), size=min(n_lists, len(data)),
                               replace=False)]
        if len(init) < n_lists:  # degenerate tiny stores
            init = np.concatenate(
                [init, rng.normal(size=(n_lists - len(init), store.dim))
                 .astype(np.float32)])
        rows = self._device_rows()
        centers = _lloyd(rows, self._to_dev(init), n_iters)
        assign = _assign(rows, centers).cpu().numpy()
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=n_lists)
        self._adopt(centers.cpu().numpy(), *_member_arrays(
            order.astype(np.uint32), counts))
        self.assign = assign

    @classmethod
    def from_lists(cls, store: VectorStore, centers: np.ndarray,
                   lists: Sequence[np.ndarray],
                   repartition_gen: int = 0) -> "IVFIndex":
        """An index over given centers and member lists (ids in list
        order), without training."""
        self = cls.__new__(cls)
        self.store = store
        self.n_lists = len(lists)
        lists = [np.asarray(m, dtype=np.uint32) for m in lists]
        self._adopt(np.array(centers, dtype=np.float32), *_member_arrays(
            np.concatenate(lists), np.array([len(m) for m in lists])))
        self.repartition_gen = int(repartition_gen)
        self.assign = self._current_assign(len(store))
        return self

    def _adopt(self, centers: np.ndarray, data: List[np.ndarray],
               lens: np.ndarray) -> None:
        self.centers = centers
        self._data = data
        self._len = lens
        self._layout: Optional[CSRLayout] = None
        self._centers_dev: Optional[torch.Tensor] = None
        # bumped by every completed repartition(); the maintenance journal's
        # idempotence probe on crash replay
        self.repartition_gen = 0

    # ------------------------------------------------------------ devices
    def _to_dev(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.store.device)

    def _device_rows(self, ids: Optional[np.ndarray] = None) -> torch.Tensor:
        """fp32 store rows on the device (all, or ``ids``): the device
        mirror, or host rows uploaded while the store is tiered."""
        st = self.store
        if st.tiered_active():
            return self._to_dev(st.vectors if ids is None else st.vectors[ids])
        rows = st.device_vectors()
        if ids is None:
            return rows
        return rows.index_select(0, self._to_dev(np.asarray(ids, np.int64)))

    def _centers_device(self) -> torch.Tensor:
        if self._centers_dev is None:
            self._centers_dev = self._to_dev(self.centers)
        return self._centers_dev

    @property
    def lists(self) -> List[np.ndarray]:
        """Trimmed per-partition id views (capacity tails excluded)."""
        return [d[: int(ln)] for d, ln in zip(self._data, self._len)]

    def _append(self, c: int, new: np.ndarray) -> None:
        ln = int(self._len[c])
        need = ln + len(new)
        cur = self._data[c]
        if need > len(cur):           # amortized doubling, not per-call concat
            grown = np.empty(max(2 * len(cur), need), dtype=np.uint32)
            grown[:ln] = cur[:ln]
            self._data[c] = cur = grown
        cur[ln:need] = new
        self._len[c] = need

    def add(self, ids: np.ndarray) -> None:
        """Route freshly-added store rows into their partitions."""
        ids = np.asarray(ids, dtype=np.uint32)
        if len(ids) == 0:
            return
        assign = _assign(self._device_rows(ids.astype(np.int64)),
                         self._centers_device()).cpu().numpy()
        for c in np.unique(assign):
            self._append(int(c), ids[assign == c])
        self._layout = None

    def layout(self) -> CSRLayout:
        """Build (or reuse) the device-resident padded-CSR layout."""
        if self._layout is None or self._layout.n != len(self.store):
            aligned = ((self._len + TILE - 1) // TILE) * TILE
            offsets = np.zeros(self.n_lists, dtype=np.int64)
            if self.n_lists > 1:
                np.cumsum(aligned[:-1], out=offsets[1:])
            flat = np.full(int(aligned.sum()) + 1, -1, dtype=np.int32)
            for c in range(self.n_lists):
                ln = int(self._len[c])
                flat[offsets[c]: offsets[c] + ln] = self._data[c][:ln]
            # checked once here, so the search launches skip the check of
            # the candidate ids expanded from these
            if flat.min() < -1 or flat.max() >= len(self.store):
                raise ValueError(f"list members in [{flat.min()}, "
                                 f"{flat.max()}], outside [-1, "
                                 f"{len(self.store)})")
            self._layout = CSRLayout(
                offsets=self._to_dev(offsets), aligned=self._to_dev(aligned),
                flat_ids=self._to_dev(flat),
                max_aligned=int(aligned.max()) if self.n_lists else 0,
                n=len(self.store))
        return self._layout

    def nbytes(self) -> int:
        return self.centers.nbytes + sum(d.nbytes for d in self._data)

    # ------------------------------------------------------------ maintenance
    def pad_waste(self) -> int:
        """Padding slots the current partition occupancy forces into the CSR
        layout (sum of TILE-aligned region lengths minus live list lengths).
        Grows under churn: tombstoned members keep their slots and drifted
        ingest piles into a few hot lists, whose ragged tails all round up."""
        aligned = ((self._len + TILE - 1) // TILE) * TILE
        return int(aligned.sum() - self._len.sum())

    def partition_stats(self) -> dict:
        """Occupancy summary for the maintenance planner's drift detector."""
        lens = self._len
        aligned = ((lens + TILE - 1) // TILE) * TILE
        return {
            "n_lists": self.n_lists,
            "pad_waste": int(aligned.sum() - lens.sum()),
            "max_len": int(lens.max()) if self.n_lists else 0,
            "mean_len": float(lens.mean()) if self.n_lists else 0.0,
            "max_aligned": int(aligned.max()) if self.n_lists else 0,
        }

    def _current_assign(self, n: int) -> np.ndarray:
        """Per-row partition of record, derived from the member lists (the
        ``assign`` array goes stale after :meth:`add`)."""
        cur = np.full(n, -1, dtype=np.int64)
        for c in range(self.n_lists):
            cur[self._data[c][: int(self._len[c])].astype(np.int64)] = c
        return cur

    def repartition(self, seed: int = 0, n_iters: int = 10,
                    sample: Optional[int] = None) -> dict:
        """Retrain centroids on a seeded sample of the *alive* rows, re-assign
        every row, and rebuild the member lists aside before one atomic
        attribute swap (readers see either the old partitioning or the new,
        never a mix). Tombstoned rows are dropped from the rebuilt lists, so
        repartitioning also reclaims their CSR slots. Deterministic for a
        fixed (store contents, seed, n_iters, sample) on one device — crash
        replay re-runs it bit-identically."""
        n = len(self.store)
        waste_before = self.pad_waste()
        if n == 0:
            self.repartition_gen += 1
            return {"gen": self.repartition_gen, "moved": 0,
                    "pad_waste_before": waste_before, "pad_waste_after": 0}
        alive = self.store.alive_bool()
        pool = np.nonzero(alive)[0] if alive is not None else np.arange(n)
        rng = np.random.default_rng(seed)
        if sample is not None and 0 < sample < len(pool):
            pool = np.sort(pool[rng.choice(len(pool), size=sample,
                                           replace=False)])
        centers = self._centers_device()
        rows = self._device_rows()
        if len(pool):
            sub = rows if len(pool) == n else self._device_rows(pool)
            centers = _lloyd(sub, centers, n_iters)
        assign = _assign(rows, centers).cpu().numpy()
        old_assign = self._current_assign(n)
        # rebuild member lists aside: alive rows only, ascending id per list
        keep = np.ones(n, dtype=bool) if alive is None else alive
        order = np.argsort(assign, kind="stable")
        order = order[keep[order]]
        counts = np.bincount(assign[keep], minlength=self.n_lists)
        new_data, new_len = _member_arrays(order.astype(np.uint32), counts)
        moved = int(np.sum((old_assign >= 0) & keep & (old_assign != assign)))
        gen = self.repartition_gen + 1
        self._adopt(centers.cpu().numpy(), new_data, new_len)
        self.assign = assign
        self.repartition_gen = gen
        return {"gen": gen, "moved": moved,
                "pad_waste_before": waste_before,
                "pad_waste_after": self.pad_waste()}

    def remap_ids(self, mapping) -> None:
        """Rewrite member ids through a store-compaction ``mapping`` (old row
        -> new row, -1 = reclaimed). Centers are untouched — compaction moves
        encodings, not vectors — and dropped rows leave their lists, so the
        rebuilt CSR sheds their padding."""
        m = np.asarray(mapping, dtype=np.int64)
        for c in range(self.n_lists):
            ln = int(self._len[c])
            members = m[self._data[c][:ln].astype(np.int64)]
            members = members[members >= 0].astype(np.uint32)
            arr = np.empty(max(8, len(members)), dtype=np.uint32)
            arr[: len(members)] = members
            self._data[c] = arr
            self._len[c] = len(members)
        new_n = int(np.sum(m >= 0))
        self.assign = self._current_assign(new_n)
        self._layout = None

    # ----------------------------------------------------------------- search
    def search(self, queries: np.ndarray, k: int,
               candidate_ids: Optional[np.ndarray] = None,
               nprobe: Optional[int] = None, precision: str = "fp32",
               rescore_k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe nprobe partitions per query; returns (scores, ids) (q, k).
        Device-batched single-scope front door over :meth:`search_multi`.
        ``nprobe=None`` asks the store's cost model (hand-set 8 under the
        heuristic model)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        words = pack_ids_to_words(candidate_ids, len(self.store))
        sids = np.zeros(queries.shape[0], dtype=np.int32)
        return self.search_multi(queries, words[None, :], sids, k,
                                 nprobe=nprobe, precision=precision,
                                 rescore_k=rescore_k)

    def search_multi(self, queries: np.ndarray, mask_words, scope_ids,
                     k: int, nprobe: Optional[int] = None,
                     precision: str = "fp32",
                     rescore_k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One launch for a heterogeneous scope batch: queries (B, d), packed
        scope masks (n_scopes, ceil(n/32)) (uint32 numpy or an int32 tensor),
        per-query scope row ids (B,). Tombstoned rows are ANDed out of every
        scope before the launch. Returns (scores, ids) both (B, k); ids
        int64 with -1 padding.

        ``precision="int8"`` / ``"pq"`` score the probed candidates' int8
        or PQ codes, keep the scope-masked top-``rescore_k`` (capped at the
        probed window) per query, and finish with the shared exact fp32
        gather-rescore; the probe stays fp32, so every precision explores
        the same partitions. A tiered store has no fp32 rows on the
        device: there fp32 ranks the admitted candidates' host rows (the
        database sends it only gather-sized scopes)."""
        _check_precision(precision)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        out_scores = np.full((B, k), -np.inf, dtype=np.float32)
        out_ids = np.full((B, k), -1, dtype=np.int64)
        st = self.store
        n = len(st)
        if n == 0:
            return out_scores, out_ids
        lay = self.layout()
        if nprobe is None:
            nprobe = model_of(st).default_nprobe(self.n_lists)
        nprobe = int(max(1, min(nprobe, self.n_lists)))
        C = nprobe * lay.max_aligned
        if C == 0:
            return out_scores, out_ids
        words = kops.as_words(mask_words).to(st.device)
        alive = st.alive_words()
        if alive is not None:
            words = words & self._to_dev(alive.view(np.int32))[None, :]
        sids = self._to_dev(np.asarray(scope_ids, dtype=np.int32))
        q = self._to_dev(queries)
        probe = _probe(q, self._centers_device(), nprobe)
        # the layout's ids were checked when it was built, and the probes
        # are distinct center ids (by ascending distance)
        listed = (lay.offsets, lay.aligned, lay.flat_ids, lay.max_aligned,
                  probe)
        l2 = st.metric == "l2"
        if precision != "fp32":
            r = min(resolve_rescore_k(k, rescore_k, n), C)
            if precision == "int8":
                q_i8, q_s = quantize_rows(queries)
                _, top = kops.ivf_probe_topk_i8(
                    self._to_dev(q_i8), self._to_dev(q_s),
                    st.device_q_vectors(), st.device_q_scales(),
                    st.device_q_sq_norms() if l2 else None, *listed, words,
                    sids, r, st.metric, check_ids=False)
            else:
                _, top = kops.ivf_probe_topk_pq(
                    self._to_dev(st.pq_lut(queries)), st.device_pq_codes(),
                    *listed, words, sids, r, check_ids=False)
            return gather_rescore(st, queries,
                                  top.cpu().numpy().astype(np.int64), k)
        if st.tiered_active():
            # the fp32 rows live in host RAM: rank the admitted candidates'
            # rows in candidate order (the same scores and tie rule)
            return gather_rescore(st, queries,
                                  _admitted(_expand(lay, probe), words, sids),
                                  k, fetch=False)
        kk = min(k, C)
        vals, ids = kops.ivf_probe_topk(
            q, st.device_vectors(), *listed, words, sids, kk, st.metric,
            sq=st.device_sq_norms() if l2 else None, check_ids=False)
        return pad_topk(*_to_host(vals, ids), k)

    def search_loop(self, queries: np.ndarray, k: int,
                    candidate_ids: Optional[np.ndarray] = None,
                    nprobe: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query host loop — the pre-batching reference oracle the
        device path is tested against."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        nq = queries.shape[0]
        # same elementwise (q-c)^2 form as the device probe stage, so both
        # paths rank near-equidistant centroids identically
        qc = np.sum((queries[:, None, :] - self.centers[None, :, :]) ** 2,
                    axis=-1)
        if nprobe is None:
            nprobe = model_of(self.store).default_nprobe(self.n_lists)
        nprobe = int(max(1, min(nprobe, self.n_lists)))
        # stable sort breaks exact-distance ties by lowest index, same as the
        # device path's lax.top_k
        probe = np.argsort(qc, axis=1, kind="stable")[:, :nprobe]
        cand_mask: Optional[np.ndarray] = None
        if candidate_ids is not None:
            cand_mask = np.zeros(len(self.store), dtype=bool)
            cand_mask[candidate_ids] = True
        alive = self.store.alive_bool()
        if alive is not None:
            cand_mask = alive if cand_mask is None else cand_mask & alive
        out_scores = np.full((nq, k), -np.inf, dtype=np.float32)
        out_ids = np.full((nq, k), -1, dtype=np.int64)
        metric = self.store.metric
        data = self.store.vectors
        lists = self.lists
        for qi in range(nq):
            cands = np.concatenate([lists[c] for c in probe[qi]])
            if cand_mask is not None and len(cands):
                cands = cands[cand_mask[cands]]
            if len(cands) == 0:
                continue
            rows = data[cands]
            if metric in ("ip", "cos"):
                scores = rows @ queries[qi]
            else:
                scores = 2.0 * rows @ queries[qi] - np.sum(rows * rows, axis=1)
            kk = min(k, len(cands))
            sel = np.argpartition(scores, -kk)[-kk:]
            order = sel[np.argsort(scores[sel])[::-1]]
            out_scores[qi, :kk] = scores[order]
            out_ids[qi, :kk] = cands[order]
        return out_scores, out_ids
