"""Sharded serving executor — the row-sharded store as a ``dsq_batch``
executor, the port of ``repro/vectordb/sharded.py``.

``dsq_batch(..., executor="sharded")`` plans exactly like the flat path
(gather below the selectivity threshold, scan above; the same
epoch-validated ``ScopeMaskCache``), but every scan-plan group of the batch
ranks on the row shards of a :class:`~repro_torch.launch.mesh.ShardMesh`:
one launch of kernel 2, 6 or 8 per shard, then the shard merge
(:mod:`repro_torch.distributed.search`):

* the store rows live in a :class:`ShardedStoreView` (incremental row
  copies on ingest, a doubled capacity and a re-shard past it);
* each unique scope's packed uint32 words occupy a *slot* of a resident
  scope table, split per shard on the word dimension (each shard holds the
  words covering its rows) with a host mirror, validated by the same
  scope-epoch tokens as the host cache, so a repeated scope never
  re-uploads;
* TrieHI ``DSMDelta`` events patch surviving slots in place, copying only
  the words ``[w_lo, w_hi)`` that span the moved aggregate, to the shards
  that hold them;
* the store's tombstones ride the packed alive words, ANDed with the used
  slots before each shard's launch.

Gather-plan groups (selective scopes, |C| << N) stay on the flat
executor's gather launch, by delegating to a :class:`FlatExecutor` twin.
The scan side equals the flat batch bit for bit at fp32, int8 and PQ: each
shard's kernel scores a (query, row) pair with the flat launch's
fixed-order chain, and the merge keeps the flat top-k's tie order, so the
fp32 results, and the int8 / PQ candidate sets the exact rescore ranks,
are the flat executor's.

Threads: the reference patches its immutable device table with a donated
update on the serving thread and a copying one on the DSM thread. Here
the table is patched in place under ``self._lock``, from either thread, on
the legacy default stream that the launches also use, which orders a
patch after every launch issued before it. A batch holds the lock from
its first pin to its launch (:meth:`pinned`), so the scheduler's staging
thread cannot evict a slot between the two (the reference can).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed import search as dsearch
from ..launch.mesh import ShardMesh, make_mesh_for_devices
from .costmodel import model_of
from .flat import (FlatExecutor, _to_host, choose_plan, gather_rescore,
                   pad_topk)
from .quant import quantize_rows, resolve_rescore_k
from .store import (ShardedStoreView, VectorStore, pack_ids_to_words,
                    shard_spans)


class _Slot:
    """One scope table row with its validity evidence (the scope-epoch
    token contract of ``planner.CachedScope``)."""
    __slots__ = ("slot", "tokens", "n")

    def __init__(self, slot: int, tokens, n: int):
        self.slot = slot
        self.tokens = tokens     # None == never valid (uncacheable scope)
        self.n = n


class ShardedExecutor:
    name = "sharded"

    def __init__(self, store: VectorStore, mesh=None, table_slots: int = 64,
                 n_shards: Optional[int] = None):
        """``mesh`` is a :class:`ShardMesh` or a sequence of devices, one
        per shard. Without one, a CPU store gets ``n_shards`` (default 1)
        shards on the CPU and a CUDA store one shard per visible card, or
        ``n_shards`` round-robin over them. A mesh naming a CUDA device
        raises when there is no card."""
        if mesh is None:
            mesh = make_mesh_for_devices(
                device="cpu" if store.device.type == "cpu" else None,
                n_shards=n_shards)
        elif n_shards is not None and n_shards != len(mesh):
            raise ValueError(f"n_shards={n_shards} for a mesh of "
                             f"{len(mesh)} shards")
        self.store = store
        self.mesh = ShardMesh(mesh)
        self.view = ShardedStoreView(store, self.mesh)
        self.flat = FlatExecutor(store)      # gather-plan twin
        self.table_slots = table_slots
        self._slots: "OrderedDict[Tuple[str, object], _Slot]" = OrderedDict()
        self._free: List[int] = []
        self._host_table: Optional[np.ndarray] = None   # (S, W) uint32
        self._table: Optional[list] = None    # per shard (S, n_loc/32) int32
        # serving, staging and DSM delta threads; re-entrant, so that a
        # batch holds it from its first pin to its launch (``pinned``)
        self._lock = threading.RLock()
        # lifetime accounting (the per-batch deltas land in BatchAccounting)
        self.mask_bytes_uploaded = 0
        self.mask_bytes_patched = 0
        self.masks_patched = 0
        self.masks_evicted = 0
        self.launches = 0

    @property
    def n_shards(self) -> int:
        return self.view.n_shards

    # --------------------------------------------------------------- syncing
    def sync(self) -> None:
        """Mirror store growth onto the shards; a capacity re-shard changes
        the word count, so the whole scope table rebuilds (under the lock:
        a DSM delta thread may be walking the slots, and the scheduler's
        staging thread syncs too)."""
        with self._lock:
            changed = self.view.sync()
            if changed or self._table is None:
                self._reset_table()

    def reserve(self, n_scopes: int) -> None:
        """Grow the scope table so one batch's scan groups all fit: pinning
        scope ``table_slots + 1`` of a batch would otherwise evict a slot
        pinned earlier in the same batch, whose requests would then rank
        against the wrong words."""
        if n_scopes <= self.table_slots:
            return
        with self._lock:
            while self.table_slots < n_scopes:
                self.table_slots *= 2
            self._reset_table()

    def _reset_table(self) -> None:
        W = max(self.view.n_words, 1)
        wl = max(self.view.n_loc // 32, 1)
        self._host_table = np.zeros((self.table_slots, W), dtype=np.uint32)
        self._table = [torch.zeros((self.table_slots, wl), dtype=torch.int32,
                                   device=dev) for dev in self.mesh]
        self._slots.clear()
        self._free = list(range(self.table_slots))

    def _upload_row(self, slot: int, w_lo: int, w_hi: int) -> None:
        """Copy host-table words ``[w_lo, w_hi)`` of ``slot`` to the shards
        holding them (caller holds the lock)."""
        row = self._host_table[slot]
        for s, a, b, la, lb in shard_spans(w_lo, w_hi,
                                           self.view.n_loc // 32):
            self._table[s][slot, la:lb] = torch.from_numpy(
                row[a:b].view(np.int32)).to(self.mesh[s])

    # ----------------------------------------------------------- scope table
    def pinned(self):
        """Context in which one batch pins its scopes and launches: no other
        thread pins, evicts or patches a slot until it ends."""
        return self._lock

    def ensure_scope(self, namespace: str, key, entry) -> Tuple[int, bool]:
        """Pin a planned scope into the table; returns ``(slot, hit)``. A
        slot whose stored tokens still equal the entry's is served with no
        upload (``hit=True``), also after a DSM delta advanced both to the
        same epoch."""
        with self._lock:
            assert self._table is not None, "sync() before ensure_scope()"
            tk = (namespace, key)
            si = self._slots.get(tk)
            tokens = entry.tokens if entry.tokens else None
            if (si is not None and si.tokens is not None
                    and si.tokens == tokens and si.n == entry.n):
                self._slots.move_to_end(tk)
                return si.slot, True
            if si is None:
                if not self._free:
                    _, old = self._slots.popitem(last=False)   # LRU evict
                    self._free.append(old.slot)
                    self.masks_evicted += 1
                slot = self._free.pop()
            else:
                slot = si.slot                                 # refresh
            W = self._host_table.shape[1]
            self._host_table[slot] = entry.scope.to_words(W * 32)
            self._upload_row(slot, 0, W)
            self.mask_bytes_uploaded += W * 4
            self._slots[tk] = _Slot(slot, tokens, entry.n)
            self._slots.move_to_end(tk)
            return slot, False

    # --------------------------------------------------------- delta patching
    def apply_delta(self, event, namespace: str = "fs") -> None:
        """``DSMDelta`` listener (one subscription per namespace): patch the
        words of every surviving slot in place, copying only the
        ``[w_lo, w_hi)`` words spanning the moved aggregate, and advance the
        slot's token to the patched epoch. Slots whose stored epoch is not
        the event's pre-op epoch, or whose scope composes non-trivially
        (exclusions, non-recursive anchors), evict instead: the rules of
        ``ScopeMaskCache.apply_delta``."""
        removed = {id(n): (o, e) for n, o, e in event.removed_from}
        added = {id(n): (o, e) for n, o, e in event.added_to}
        if not removed and not added:
            return
        with self._lock:
            if self._table is None or not self._slots:
                return
            arr = event.delta.to_array()
            if len(arr):
                w_lo = int(arr[0]) >> 5
                w_hi = (int(arr[-1]) >> 5) + 1
                dw = event.delta.to_words(w_hi * 32)[w_lo:w_hi]
            else:
                w_lo = w_hi = 0
                dw = None
            evict = []
            for tk, si in self._slots.items():
                ns, key = tk
                if ns != namespace or si.tokens is None:
                    continue
                hit = [t for t in si.tokens
                       if (id(t[0]) in removed or id(t[0]) in added)]
                if not hit:
                    continue                   # off-chain slot: untouched
                if (len(si.tokens) == 1 and not key.exclude and key.recursive
                        and w_hi <= self._host_table.shape[1]):
                    # (a delta reaching past the table's words means the
                    # store outgrew the view since the last sync; the next
                    # sync re-shards and rebuilds the table, so such slots
                    # evict rather than half-patch)
                    node, cur_epoch = si.tokens[0]
                    sign = 1 if id(node) in added else -1
                    old_e, new_e = (added[id(node)] if sign > 0
                                    else removed[id(node)])
                    if cur_epoch == old_e:
                        if dw is not None:
                            cur = self._host_table[si.slot, w_lo:w_hi]
                            self._host_table[si.slot, w_lo:w_hi] = (
                                (cur | dw) if sign > 0 else (cur & ~dw))
                            self._upload_row(si.slot, w_lo, w_hi)
                            self.mask_bytes_patched += (w_hi - w_lo) * 4
                        si.tokens = ((node, new_e),)
                        self.masks_patched += 1
                        continue
                evict.append(tk)
            for tk in evict:
                si = self._slots.pop(tk)
                self._free.append(si.slot)
                self.masks_evicted += 1

    def apply_remap(self, mapping) -> int:
        """Store-compaction id remap: re-mirror the compacted rows at the
        unchanged capacity (``ShardedStoreView.apply_remap``, no re-shard,
        so the table's word layout survives) and rewrite every pinned
        slot's words through ``mapping`` instead of evicting. Tokens carry
        over: compaction moves ids, not directory membership, and the
        paired ``ScopeMaskCache.apply_remap`` keeps the host cache's tokens
        the same way, so slot hits keep validating. Returns the number of
        slots patched."""
        self.view.apply_remap()
        m = np.asarray(mapping, dtype=np.int64)
        old_n = len(m)
        alive_old = np.nonzero(m >= 0)[0]
        new_n = len(alive_old)
        with self._lock:
            if self._table is None or not self._slots:
                return 0
            W = self._host_table.shape[1]
            patched = 0
            for _, si in self._slots.items():
                bits = np.unpackbits(self._host_table[si.slot].view(np.uint8),
                                     bitorder="little")[:old_n]
                new_bits = np.zeros(W * 32, dtype=np.uint8)
                new_bits[m[alive_old]] = bits[alive_old]
                self._host_table[si.slot] = np.packbits(
                    new_bits, bitorder="little").view(np.uint32)
                self._upload_row(si.slot, 0, W)
                si.n = new_n
                self.mask_bytes_patched += W * 4
                patched += 1
            self.masks_patched += patched
            return patched

    # --------------------------------------------------------------- queries
    def phase_depth(self, k: int, precision: str = "fp32",
                    rescore_k: Optional[int] = None) -> int:
        """Per-shard top-k depth of the scan launch: ``k`` for the exact
        fp32 scan, the effective ``rescore_k`` for the int8 / PQ phase."""
        if precision in ("int8", "pq"):
            return resolve_rescore_k(k, rescore_k, len(self.store))
        return k

    def scan_on_mesh(self, k: int, precision: str = "fp32",
                     rescore_k: Optional[int] = None) -> bool:
        """A per-shard top-``depth`` needs that many local rows; small
        stores (or a large k / rescore_k) run the flat twin instead, which
        launches the same kernels on the store's device."""
        depth = self.phase_depth(k, precision, rescore_k)
        return 0 < depth <= self.view.n_loc

    def search_slots(self, queries: np.ndarray, slot_ids: np.ndarray,
                     k: int, precision: str = "fp32",
                     rescore_k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One launch per shard ranking every scan-plan request of a batch
        against the resident scope table. The result contract of
        ``FlatExecutor.search_multi``: (B, k) scores / ids, -inf / -1 where
        the scope ran out of candidates. At int8 / PQ each shard keeps
        ``rescore_k`` local candidates, the merge the global ``rescore_k``,
        and one exact fp32 ``gather_rescore`` ranks the final k."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        table = self._table
        if precision in ("int8", "pq"):
            r = self.phase_depth(k, precision, rescore_k)
            launch = self._launch_i8 if precision == "int8" else \
                self._launch_pq
            cand = launch(queries, table, slot_ids, r)
            return gather_rescore(self.store, queries, cand, k)
        return self._launch(queries, table, slot_ids, k)

    def _launch(self, queries, table, sids, k):
        st = self.store
        fn = dsearch.make_sharded_batch_search(self.mesh, self.view.cap,
                                               st.dim, k, st.metric)
        sq = self.view.sq_device() if st.metric == "l2" else None
        vals, ids = fn(self.view.db, table, self.view.alive_device(), sids,
                       torch.from_numpy(queries), sq=sq)
        self.launches += 1
        return _to_host(vals, ids)

    def _launch_i8(self, queries, table, sids, r) -> np.ndarray:
        """int8 scan phase on the shards: the merged (B, r) global candidate
        ids, -1 where a scope ran dry."""
        st = self.store
        qdb, qscale = self.view.q_device()
        sq = self.view.q_sq_device() if st.metric == "l2" else None
        q_i8, q_s = quantize_rows(queries)
        fn = dsearch.make_sharded_batch_search_i8(self.mesh, self.view.cap,
                                                  st.dim, r, st.metric)
        _, ids = fn(qdb, qscale, table, self.view.alive_device(), sids,
                    torch.from_numpy(q_i8), torch.from_numpy(q_s), sq=sq)
        self.launches += 1
        return ids.cpu().numpy()

    def _launch_pq(self, queries, table, sids, r) -> np.ndarray:
        """PQ/ADC scan phase on the shards: the per-query LUTs build on the
        host against the frozen codebook, each shard sums its slice of the
        code mirror, and the merge gives the (B, r) global candidate ids
        (-1 where a scope ran dry). The caller's rescore is the only read
        of fp32 rows on this path."""
        lut = self.store.pq_lut(queries)
        fn = dsearch.make_sharded_batch_search_pq(
            self.mesh, self.view.cap, self.store.pq_codebook.m, r)
        _, ids = fn(self.view.pq_device(), table, self.view.alive_device(),
                    sids, torch.from_numpy(lut))
        self.launches += 1
        return ids.cpu().numpy()

    def search(self, queries: np.ndarray, k: int,
               candidate_ids: Optional[np.ndarray] = None,
               plan: Optional[str] = None, precision: str = "fp32",
               rescore_k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Single-scope front door with ``FlatExecutor.search``'s plan
        decision; the scan plan runs on the shards against an ad-hoc
        one-row table (no slot pinned). Equal to the flat executor for any
        candidate set free of tombstoned ids, which every DSQ path
        guarantees (scope resolution drops deleted entries); the shards
        also AND the store's tombstones, so a stale caller-supplied set
        never resurfaces a deleted row on the scan plan."""
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
        if plan == "gather":
            return self.flat.search(queries, k, candidate_ids=candidate_ids,
                                    plan=plan, precision=precision,
                                    rescore_k=rescore_k)
        with self._lock:
            self.sync()
            if not self.scan_on_mesh(kk, precision, rescore_k):
                return self.flat.search(queries, k,
                                        candidate_ids=candidate_ids,
                                        plan=plan, precision=precision,
                                        rescore_k=rescore_k)
            words = np.zeros(self.view.n_words, dtype=np.uint32)
            w = pack_ids_to_words(candidate_ids, n)
            words[: len(w)] = w
            table = dsearch.shard_words(self.mesh, words[None, :],
                                        self.view.cap)
            sids = np.zeros(queries.shape[0], np.int32)
            if precision in ("int8", "pq"):
                r = self.phase_depth(kk, precision, rescore_k)
                launch = self._launch_i8 if precision == "int8" else \
                    self._launch_pq
                cand = launch(queries, table, sids, r)
                return gather_rescore(self.store, queries, cand, k)
            return pad_topk(*self._launch(queries, table, sids, kk), k)

    # ------------------------------------------------------------ inspection
    def stats(self) -> Dict[str, int]:
        return {"n_shards": self.n_shards, "cap": self.view.cap,
                "reshards": self.view.reshards,
                "db_bytes_uploaded": self.view.db_bytes_uploaded,
                "q_bytes_uploaded": self.view.q_bytes_uploaded,
                "pq_bytes_uploaded": self.view.pq_bytes_uploaded,
                "alive_bytes_uploaded": self.view.alive_bytes_uploaded,
                "slots": len(self._slots),
                "mask_bytes_uploaded": self.mask_bytes_uploaded,
                "mask_bytes_patched": self.mask_bytes_patched,
                "masks_patched": self.masks_patched,
                "masks_evicted": self.masks_evicted,
                "launches": self.launches}
