"""Vector store: host-resident fp32 rows, their int8 and PQ code tiers,
and incrementally synced mirrors of each on the database's device.

Entry ids are row indices (uint32), the same ids the scope indexes keep in
their RoaringBitmaps, so the hand-off between the directory layer and the
executor is a pure id set / packed bitmask (§II-A of the paper).

Each device mirror copies a prefix of a host array and grows by amortised
doubling: a reader's sync uploads only the rows added since the last one,
so an ingest never re-uploads the rows already there. The int8 codes and
scales and the PQ codebook and codes are computed on the host by the numpy
copied from the reference (``quant.py``), through the same lazy watermarks,
so both packages hold the same codes.

Tiered storage: with a device byte budget set and the fp32 rows over it,
the store releases its fp32 device mirror; the fp32 rows stay in host RAM
and every read of exact rows is a host read (:meth:`device_rows`). The
squared row norms (4 bytes a row) stay on the device.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import faults
from ..device import resolve_device
from ..kernels.common import row_sq_norms
from .quant import PQCodebook, quantize_rows

METRICS = ("ip", "l2", "cos")


def pack_ids_to_words(candidate_ids: Optional[np.ndarray],
                      n: int) -> np.ndarray:
    """Pack an id array into ``ceil(n/32)`` little-endian uint32 mask words
    (the same layout as ``RoaringBitmap.to_words``). ``None`` packs the full
    ``[0, n)`` range; out-of-range ids are dropped."""
    n_words = max((n + 31) // 32, 1)
    if candidate_ids is None:
        words = np.full(n_words, 0xFFFFFFFF, dtype=np.uint32)
        if n % 32:
            words[-1] = np.uint32((1 << (n % 32)) - 1)
        if n == 0:
            words[:] = 0
        return words
    ids = np.asarray(candidate_ids, dtype=np.int64)
    ids = ids[(ids >= 0) & (ids < n)]
    if len(ids) * 16 > n:
        # broad scope: dense mask + packbits beats the per-id scattered
        # bitwise_or.at
        mask = np.zeros(n_words * 32, dtype=bool)
        mask[ids] = True
        return np.packbits(mask, bitorder="little").view(np.uint32)
    words = np.zeros(n_words, dtype=np.uint32)
    np.bitwise_or.at(words, ids >> 5,
                     np.uint32(1) << (ids & 31).astype(np.uint32))
    return words


class _Mirror:
    """Device copy of a prefix ``[0, n)`` of a host array: grows by doubling
    and uploads only the rows past its watermark."""

    def __init__(self) -> None:
        self.t: Optional[torch.Tensor] = None
        self.n = 0

    def sync(self, host: np.ndarray, device: torch.device) -> torch.Tensor:
        n = host.shape[0]
        cap = 0 if self.t is None else self.t.shape[0]
        if cap < n:
            grown = torch.empty((max(n, 2 * cap, 1024), *host.shape[1:]),
                                dtype=torch.from_numpy(host[:0]).dtype,
                                device=device)
            if self.n:
                grown[: self.n] = self.t[: self.n]
            self.t = grown
        if n > self.n:
            self.t[self.n:n] = torch.from_numpy(
                np.ascontiguousarray(host[self.n:n])).to(device)
        self.n = n
        return self.t[:n]

    def reset(self) -> None:
        """Rows moved (compaction): re-upload from row 0 on the next sync."""
        self.n = 0

    def release(self) -> None:
        self.t = None
        self.n = 0


class VectorStore:
    def __init__(self, dim: int, metric: str = "ip", capacity: int = 1024,
                 device=None, pq_m: Optional[int] = None):
        if metric not in METRICS:
            raise ValueError(f"metric {metric!r} not in {METRICS}")
        self.dim = dim
        self.metric = metric
        self.device = resolve_device(device)
        # attached cost model (vectordb.costmodel.CostModel) — None means
        # the heuristic constants; every decision site reads it through
        # costmodel.model_of(store)
        self.cost_model = None
        self._rows = np.zeros((capacity, dim), dtype=np.float32)
        self._n = 0
        # device mirrors: fp32 rows, their squared norms (computed on the
        # device from the uploaded rows, once per row), int8 codes / scales
        # / dequantized norms, PQ codes
        self._dev_rows_m = _Mirror()
        self._dev_sq: Optional[torch.Tensor] = None
        self._sq_n = 0
        self._dev_q = _Mirror()
        self._dev_q_scale = _Mirror()
        self._dev_q_norms = _Mirror()
        self._dev_pq = _Mirror()
        # int8 scalar-quantized tier: rows [0, _q_n) are quantized; any
        # accessor catches the tier up to _n first, so a pure-fp32 workload
        # never pays the quantization and each ingest batch is quantized
        # once. Tombstones need no mirror: the packed alive/scope words mask
        # deleted rows at every precision.
        self._q_rows: Optional[np.ndarray] = None
        self._q_scale: Optional[np.ndarray] = None
        self._q_n = 0
        self._q_norms_cache: Optional[np.ndarray] = None
        # PQ/ADC tier: a codebook trained once on the rows present at first
        # use and then frozen (quant.PQCodebook), so codes of ingested rows
        # never change; rows [0, _pq_n) are encoded.
        self._pq_m = pq_m
        self._pq: Optional[PQCodebook] = None
        self._pq_codes: Optional[np.ndarray] = None
        self._pq_n = 0
        # Tiered storage: past the device byte budget the fp32 rows live in
        # host RAM only; the device keeps the PQ codes (plus the rows the
        # planner pins, accounted but not yet held apart) and rescore
        # windows fetch exact rows on demand. Fetch counters are
        # cumulative; per-batch accounting takes deltas.
        self._device_budget: Optional[int] = None
        self._pinned: Optional[np.ndarray] = None
        self.rescore_fetch_bytes = 0
        self.rescore_fetch_rows = 0
        # transient faults at the ``store.host_fetch`` seam are retried with
        # exponential backoff (bounded) and counted here
        self.host_fetch_retries = 0
        self.host_fetch_failures = 0
        # Tombstones: rows are append-only, so a delete marks the id dead
        # here (scoped searches already drop deleted ids via the directory
        # layer).
        self._deleted = np.zeros(capacity, dtype=bool)
        self._n_deleted = 0
        self._alive_words: Optional[np.ndarray] = None
        # Tombstone id log: incremental consumers patch only the words these
        # ids touch. Consumers register a cursor and the prefix every
        # registered cursor has passed is dropped (``_deleted_log_base`` is
        # the absolute index of element 0). With no registered consumers the
        # log is kept whole.
        self._deleted_log: list = []
        self._deleted_log_base = 0
        self._log_cursors: dict = {}      # consumer handle -> absolute cursor
        self._next_log_consumer = 0
        # bumped by every completed compact()
        self.compact_gen = 0

    def __len__(self) -> int:
        return self._n

    @property
    def vectors(self) -> np.ndarray:
        return self._rows[: self._n]

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append rows (unit-normalised first for cos); returns the assigned
        entry ids."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if vectors.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vectors.shape[1]} != {self.dim}")
        if self.metric == "cos":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = vectors / np.maximum(norms, 1e-12)
        return self.append_rows(vectors)

    def append_rows(self, vectors: np.ndarray) -> np.ndarray:
        """Append rows exactly as given (already normalised for cos): the
        state-restore path of ``convert.from_state``."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if vectors.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vectors.shape[1]} != {self.dim}")
        n_new = vectors.shape[0]
        while self._n + n_new > self._rows.shape[0]:
            grown = np.zeros((max(2 * self._rows.shape[0], self._n + n_new),
                              self.dim), dtype=np.float32)
            grown[: self._n] = self._rows[: self._n]
            self._rows = grown
        if self._n + n_new > self._deleted.shape[0]:
            grown_d = np.zeros(self._rows.shape[0], dtype=bool)
            grown_d[: self._n] = self._deleted[: self._n]
            self._deleted = grown_d
        self._rows[self._n: self._n + n_new] = vectors
        ids = np.arange(self._n, self._n + n_new, dtype=np.uint32)
        self._n += n_new
        self._alive_words = None
        self._apply_budget()
        return ids

    # ----------------------------------------------------------- tombstones
    def mark_deleted(self, ids) -> None:
        """Tombstone rows (append-only store; the rows stay but no scope
        holds them any more)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        ids = ids[(ids >= 0) & (ids < self._n)]
        fresh = ids[~self._deleted[ids]]
        if len(fresh) == 0:
            return
        self._deleted[fresh] = True
        self._n_deleted += len(fresh)
        self._deleted_log.extend(int(i) for i in fresh)
        self._alive_words = None

    @property
    def n_deleted(self) -> int:
        return self._n_deleted

    @property
    def deleted_log(self) -> list:
        """Tombstoned ids (in mark order) not yet truncated; prefer the
        cursor API (:meth:`register_log_consumer`) which bounds the log."""
        return self._deleted_log

    @property
    def deleted_log_end(self) -> int:
        """Absolute length of the tombstone history (survives truncation)."""
        return self._deleted_log_base + len(self._deleted_log)

    def register_log_consumer(self) -> int:
        """Register an incremental tombstone-log consumer whose cursor starts
        at the current end."""
        h = self._next_log_consumer
        self._next_log_consumer += 1
        self._log_cursors[h] = self.deleted_log_end
        return h

    def unregister_log_consumer(self, handle: int) -> None:
        self._log_cursors.pop(handle, None)
        self._truncate_deleted_log()

    def log_consumer_reset(self, handle: int) -> None:
        """Skip the handle to the log end without reading."""
        self._log_cursors[handle] = self.deleted_log_end
        self._truncate_deleted_log()

    def consume_deleted_log(self, handle: int) -> list:
        """Tombstone ids appended since this handle's cursor; advances the
        cursor to the end and drops any prefix every consumer has passed."""
        start = max(0, self._log_cursors[handle] - self._deleted_log_base)
        out = self._deleted_log[start:]
        self._log_cursors[handle] = self.deleted_log_end
        self._truncate_deleted_log()
        return out

    def _truncate_deleted_log(self) -> None:
        if not self._log_cursors:
            return
        low = min(self._log_cursors.values())
        drop = low - self._deleted_log_base
        if drop > 0:
            del self._deleted_log[:drop]
            self._deleted_log_base = low

    def deleted_mask(self) -> np.ndarray:
        return self._deleted[: self._n]

    def alive_bool(self) -> Optional[np.ndarray]:
        """(n,) bool alive mask, or None when nothing is deleted."""
        if self._n_deleted == 0:
            return None
        return ~self._deleted[: self._n]

    def alive_words(self) -> Optional[np.ndarray]:
        """Packed uint32 alive mask, ceil(n/32) words, or None when nothing
        is deleted. Cached until the next add/mark_deleted."""
        if self._n_deleted == 0:
            return None
        if (self._alive_words is None
                or self._alive_words.shape[0] != (self._n + 31) // 32):
            padded = np.zeros(((self._n + 31) // 32) * 32, dtype=bool)
            padded[: self._n] = ~self._deleted[: self._n]
            self._alive_words = np.packbits(
                padded, bitorder="little").view(np.uint32)
        return self._alive_words

    # ----------------------------------------------------------- compaction
    def compact(self) -> Optional[np.ndarray]:
        """Reclaim tombstoned rows: slide every alive row down (order
        preserved) and clear the tombstone set. Returns the id remap
        ``mapping[old_id] -> new_id`` (int64, -1 for reclaimed rows), or
        ``None`` when there was nothing to reclaim; the caller propagates it
        to every id-keyed structure."""
        if self._n_deleted == 0:
            return None
        old_n = self._n
        alive = ~self._deleted[:old_n]
        new_n = int(np.count_nonzero(alive))
        mapping = np.full(old_n, -1, dtype=np.int64)
        mapping[alive] = np.arange(new_n, dtype=np.int64)
        self._rows[:new_n] = self._rows[:old_n][alive]
        # code slabs: the encoded prefixes are compacted (codes are copied,
        # never re-encoded; the frozen codebook is untouched), and each
        # watermark moves to how many encoded rows survived
        if self._q_rows is not None:
            q_n = min(self._q_n, old_n)
            keep = alive[:q_n]
            new_q = int(np.count_nonzero(keep))
            self._q_rows[:new_q] = self._q_rows[:q_n][keep]
            self._q_scale[:new_q] = self._q_scale[:q_n][keep]
            self._q_n = new_q
        if self._pq_codes is not None:
            pq_n = min(self._pq_n, old_n)
            keep = alive[:pq_n]
            new_pq = int(np.count_nonzero(keep))
            self._pq_codes[:new_pq] = self._pq_codes[:pq_n][keep]
            self._pq_n = new_pq
        if self._pinned is not None:
            pinned = np.zeros(self._pinned.shape[0], dtype=bool)
            pinned[:new_n] = self.pinned_mask()[:old_n][alive]
            self._pinned = pinned
        self._n = new_n
        self._deleted[:old_n] = False
        self._n_deleted = 0
        # every tombstone in the log is now reclaimed; consumers rebuild
        # from the remap, not the log
        self._deleted_log.clear()
        self._deleted_log_base = 0
        for h in self._log_cursors:
            self._log_cursors[h] = 0
        # rows moved: every device mirror re-syncs from row 0
        for mirror in (self._dev_rows_m, self._dev_q, self._dev_q_scale,
                       self._dev_q_norms, self._dev_pq):
            mirror.reset()
        self._sq_n = 0
        self._q_norms_cache = None
        self._alive_words = None
        self._apply_budget()
        self.compact_gen += 1
        return mapping

    # --------------------------------------------------------- device mirror
    @property
    def _dev_rows(self) -> Optional[torch.Tensor]:
        """The fp32 device mirror's buffer (None once released)."""
        return self._dev_rows_m.t

    def device_vectors(self) -> torch.Tensor:
        """(n, d) fp32 rows on the store's device. A tiered store has
        released this mirror; reading it then raises."""
        if self.tiered_active():
            raise RuntimeError(
                "the store is over its device byte budget: its fp32 rows "
                "live in host RAM (read them through fetch_rows)")
        return self._dev_rows_m.sync(self.vectors, self.device)

    def device_sq_norms(self) -> torch.Tensor:
        """(n,) fp32 squared row norms on the store's device (the l2 term;
        every executor path reads these same values). Each row's norm is
        computed once, on the device, from its uploaded fp32 row."""
        lo, hi = self._sq_n, self._n
        cap = 0 if self._dev_sq is None else self._dev_sq.shape[0]
        if cap < hi:
            grown = torch.empty(max(hi, 2 * cap, 1024), dtype=torch.float32,
                                device=self.device)
            if lo:
                grown[:lo] = self._dev_sq[:lo]
            self._dev_sq = grown
        if hi > lo:
            fresh = (torch.from_numpy(self._rows[lo:hi]).to(self.device)
                     if self.tiered_active()
                     else self.device_vectors()[lo:hi])
            self._dev_sq[lo:hi] = row_sq_norms(fresh)
            self._sq_n = hi
        return self._dev_sq[:hi]

    # ----------------------------------------------------- int8 scalar tier
    def _ensure_quantized(self) -> None:
        """Catch the int8 mirror up to the current row count: quantizes only
        the fresh ``[_q_n, _n)`` slice (post-normalization rows, so the
        codes always mirror exactly what the fp32 scan would score)."""
        if self._q_n == self._n and self._q_rows is not None:
            return
        cap = self._rows.shape[0]
        if self._q_rows is None or self._q_rows.shape[0] < cap:
            grown_q = np.zeros((cap, self.dim), dtype=np.int8)
            grown_s = np.ones(cap, dtype=np.float32)
            if self._q_rows is not None:
                grown_q[: self._q_n] = self._q_rows[: self._q_n]
                grown_s[: self._q_n] = self._q_scale[: self._q_n]
            self._q_rows, self._q_scale = grown_q, grown_s
        if self._q_n < self._n:
            codes, scales = quantize_rows(self._rows[self._q_n: self._n])
            self._q_rows[self._q_n: self._n] = codes
            self._q_scale[self._q_n: self._n] = scales
        self._q_n = self._n

    @property
    def q_vectors(self) -> np.ndarray:
        """(n, d) int8 codes (see :mod:`.quant` for the scoring contract)."""
        self._ensure_quantized()
        return self._q_rows[: self._n]

    @property
    def q_scales(self) -> np.ndarray:
        """(n,) fp32 per-row dequantization scales."""
        self._ensure_quantized()
        return self._q_scale[: self._n]

    def q_sq_norms(self) -> np.ndarray:
        """(n,) fp32 squared norms of the *dequantized* rows — the ``||x||^2``
        term the int8 l2 scan subtracts, so int8 scores are exact for the
        quantized operands (scale^2 * sum(codes^2), int32-accumulated)."""
        if (self._q_norms_cache is None
                or self._q_norms_cache.shape[0] != self._n):
            codes = self.q_vectors.astype(np.int32)
            self._q_norms_cache = (
                np.einsum("nd,nd->n", codes, codes).astype(np.float32)
                * self.q_scales * self.q_scales)
        return self._q_norms_cache

    def device_q_vectors(self) -> torch.Tensor:
        return self._dev_q.sync(self.q_vectors, self.device)

    def device_q_scales(self) -> torch.Tensor:
        return self._dev_q_scale.sync(self.q_scales, self.device)

    def device_q_sq_norms(self) -> torch.Tensor:
        return self._dev_q_norms.sync(self.q_sq_norms(), self.device)

    # ------------------------------------------------------------ PQ tier
    def _ensure_pq(self) -> None:
        """Catch the PQ mirror up to the current row count: trains the
        codebook once (on the rows present at first use), then encodes only
        the fresh ``[_pq_n, _n)`` slice with the frozen centroids."""
        if self._pq is None:
            self._pq = PQCodebook(self.dim, self._pq_m)
        cap = self._rows.shape[0]
        if self._pq_codes is None or self._pq_codes.shape[0] < cap:
            grown = np.zeros((cap, self._pq.m), dtype=np.uint8)
            if self._pq_codes is not None:
                grown[: self._pq_n] = self._pq_codes[: self._pq_n]
            self._pq_codes = grown
        if self._pq_n < self._n:
            if not self._pq.trained:
                self._pq.train(self._rows[: self._n])
            self._pq_codes[self._pq_n: self._n] = self._pq.encode(
                self._rows[self._pq_n: self._n])
            self._pq_n = self._n

    def set_pq_codebook(self, centroids: np.ndarray,
                        encoded: int = 0) -> None:
        """Adopt a trained codebook ((M, 256, dsub) centroids) instead of
        training one: the state carried across from another database. Rows
        ``[0, encoded)`` are encoded now, later rows lazily, all with these
        frozen centroids, so the codes equal the source's whatever it
        ingested after it trained."""
        cents = np.asarray(centroids, dtype=np.float32)
        self._pq = PQCodebook(self.dim, cents.shape[0])
        self._pq.centroids = cents.copy()
        self._pq_codes = np.zeros((self._rows.shape[0], self._pq.m),
                                  dtype=np.uint8)
        self._pq_n = min(int(encoded), self._n)
        self._pq_codes[: self._pq_n] = self._pq.encode(
            self._rows[: self._pq_n])
        self._dev_pq.release()

    @property
    def pq_codebook(self) -> PQCodebook:
        self._ensure_pq()
        return self._pq

    @property
    def pq_codes(self) -> np.ndarray:
        """(n, M) uint8 PQ codes (see :class:`.quant.PQCodebook`)."""
        self._ensure_pq()
        return self._pq_codes[: self._n]

    def pq_lut(self, queries: np.ndarray) -> np.ndarray:
        """(nq, M, 256) fp32 per-query ADC tables for this store's metric."""
        return self.pq_codebook.lut(queries, self.metric)

    def device_pq_codes(self) -> torch.Tensor:
        return self._dev_pq.sync(self.pq_codes, self.device)

    # ------------------------------------------------------ tiered storage
    def set_device_budget(self, nbytes: Optional[int]) -> None:
        """Configure the device byte budget. Once the fp32 rows outgrow it,
        the store is *tiered*: fp32 rows live in host RAM (the device
        mirror is released), the device holds PQ codes (plus hot-pinned
        fp32 rows), and rescore windows fetch host rows on demand."""
        self._device_budget = None if nbytes is None else int(nbytes)
        self._apply_budget()

    @property
    def device_budget(self) -> Optional[int]:
        return self._device_budget

    def tiered_active(self) -> bool:
        return (self._device_budget is not None
                and self.nbytes() > self._device_budget)

    def _apply_budget(self) -> None:
        """Release the fp32 device mirror while the store is tiered."""
        if self.tiered_active() and self._dev_rows_m.t is not None:
            self._dev_rows_m.release()

    def pin_rows(self, ids) -> None:
        """Replace the set of device-pinned fp32 rows (scope-aware hot
        placement, chosen by the planner's access stats). Pins are
        accounting only, as in the reference: a pinned row is not fetched
        in the rescore's byte count, but its read goes the same way."""
        mask = np.zeros(self._rows.shape[0], dtype=bool)
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        ids = ids[(ids >= 0) & (ids < self._n)]
        mask[ids] = True
        self._pinned = mask

    def pinned_mask(self) -> Optional[np.ndarray]:
        """(n,) bool mask of device-pinned rows, or None when nothing is
        pinned. Rows ingested after a pin are unpinned until the next pin
        refresh, so the mask is padded with False up to the row count."""
        if self._pinned is None:
            return None
        if self._pinned.shape[0] < self._n:
            grown = np.zeros(self._rows.shape[0], dtype=bool)
            grown[: self._pinned.shape[0]] = self._pinned
            self._pinned = grown
        return self._pinned[: self._n]

    def placement(self) -> Tuple[int, int]:
        """``(rows_device_pinned, rows_host)`` for alive rows. When the
        store is not tiered every row is device-resident (the fp32 device
        mirror), so the host count is 0."""
        alive = self.alive_count()
        if not self.tiered_active():
            return alive, 0
        pm = self.pinned_mask()
        if pm is None:
            return 0, alive
        pinned = int(np.count_nonzero(pm & ~self._deleted[: self._n]))
        return pinned, alive - pinned

    #: bounded-retry policy for transient host-fetch faults (a stalled or
    #: flaky host-RAM/disk read in the tiered store): up to FETCH_RETRIES
    #: re-attempts with exponential backoff starting at FETCH_BACKOFF_S.
    FETCH_RETRIES = 3
    FETCH_BACKOFF_S = 1e-3

    def _with_fetch_retry(self, read):
        """Run ``read()`` behind the ``store.host_fetch`` fault seam:
        transient faults are retried with exponential backoff up to
        :data:`FETCH_RETRIES` times (counted in ``host_fetch_retries``);
        exhaustion or a non-transient fault escalates to the caller."""
        attempt = 0
        while True:
            try:
                faults.fire("store.host_fetch")
                return read()
            except faults.TransientFault:
                if attempt >= self.FETCH_RETRIES:
                    self.host_fetch_failures += 1
                    raise faults.FaultError(
                        "store.host_fetch",
                        f"transient fault persisted past "
                        f"{self.FETCH_RETRIES} retries") from None
                time.sleep(self.FETCH_BACKOFF_S * (2 ** attempt))
                attempt += 1
                self.host_fetch_retries += 1

    def fetch_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Exact fp32 host rows by store id, behind the ``store.host_fetch``
        seam with bounded retry (the I/O edge of a tiered store)."""
        return self._with_fetch_retry(lambda: self.vectors[row_ids])

    def device_rows(self, row_ids: np.ndarray,
                    fetch: bool = False) -> torch.Tensor:
        """Exact fp32 rows by store id, on the device: gathered from the
        device mirror, or read from host RAM and uploaded when the store is
        tiered. ``fetch=True`` (a rescore window) puts the read behind the
        ``store.host_fetch`` seam with bounded retry, as every rescore of
        the reference is, so a fault plan trips as often in both packages."""
        ids = np.asarray(row_ids, dtype=np.int64)
        if self.tiered_active():
            host = self.fetch_rows(ids) if fetch else self.vectors[ids]
            return torch.from_numpy(host).to(self.device)
        idx = torch.from_numpy(ids).to(self.device)

        def read():
            return self.device_vectors().index_select(0, idx)
        return self._with_fetch_retry(read) if fetch else read()

    # -------------------------------------------------------------- bytes
    def alive_count(self) -> int:
        return self._n - self._n_deleted

    def nbytes(self) -> int:
        return self._n * self.dim * 4

    def q_nbytes(self) -> int:
        """Device bytes of the int8 tier: codes + one fp32 scale per row."""
        return self._n * self.dim + self._n * 4

    def alive_nbytes(self) -> int:
        """fp32 bytes of rows that are actually alive — what accounting
        reports, so tombstoned rows can't flatter compression ratios."""
        return self.alive_count() * self.dim * 4

    def q_alive_nbytes(self) -> int:
        return self.alive_count() * (self.dim + 4)

    def pq_nbytes(self) -> int:
        """Device bytes of the PQ tier: uint8 codes of alive rows only.
        The O(1) codebook is reported separately
        (:meth:`pq_codebook_nbytes`), not amortized into per-row bytes."""
        self._ensure_pq()
        return self.alive_count() * self._pq.m

    def pq_codebook_nbytes(self) -> int:
        return self._pq.nbytes() if self._pq is not None else 0


def shard_spans(lo: int, hi: int, per: int):
    """The pieces of the global range ``[lo, hi)`` over shards of ``per``
    items each: ``(shard, first, end, local first, local end)``."""
    for s in range(lo // per, (hi - 1) // per + 1 if hi > lo else 0):
        a, b = max(lo, s * per), min(hi, (s + 1) * per)
        yield s, a, b, a - s * per, b - s * per


class ShardedStoreView:
    """Row-sharded mirror of a :class:`VectorStore` over a shard mesh.

    The mirror is sized to a padded *capacity* (a multiple of
    ``32 * n_shards``, so every shard's rows stay whole mask words) and
    shard ``s`` permanently owns rows ``[s*n_loc, (s+1)*n_loc)``, held as
    one tensor per shard on ``mesh[s]``. That fixed block layout makes
    ingest incremental: new rows are copied into the shards that cover
    them, and only growth *past* the capacity re-shards, at a doubled
    capacity, so re-shard cost is amortised O(1) a row. Capacity-padding
    rows are zero and are masked by the packed alive words
    (:meth:`alive_device`), which also carry the store's tombstones. The
    int8 (codes + scales) and PQ mirrors are built on first use and kept
    up the same way. Counters: ``*_bytes_uploaded`` count the bytes
    copied to the shards (a full rebuild counts the padded capacity, an
    incremental copy only the new rows), ``reshards`` the capacity
    rebuilds."""

    def __init__(self, store: VectorStore, mesh):
        self.store = store
        self.mesh = tuple(mesh)
        self.n_shards = len(self.mesh)
        self.row_align = 32 * self.n_shards
        self._db: Optional[list] = None      # per shard (n_loc, dim) f32
        self._sq: Optional[list] = None      # per shard (n_loc,) f32, l2
        self._sq_n = 0
        self._cap = 0
        self._synced = 0
        self._alive: Optional[list] = None   # per shard (n_loc/32,) int32
        self._alive_host: Optional[np.ndarray] = None   # (cap/32,) uint32
        self._alive_n = 0                    # rows covered by the words
        # registered tombstone-log cursor: consuming through the store's
        # API lets the store drop the consumed prefix of its log
        self._log_consumer = store.register_log_consumer()
        self._compact_gen = store.compact_gen
        self._qdb: Optional[list] = None     # per shard (n_loc, dim) int8
        self._qscale: Optional[list] = None  # per shard (n_loc,) f32
        self._qsq: Optional[list] = None     # per shard (n_loc,) f32, l2
        self._q_synced = 0
        self._pqdb: Optional[list] = None    # per shard (n_loc, M) uint8
        self._pq_synced = 0
        self.db_bytes_uploaded = 0
        self.alive_bytes_uploaded = 0
        self.q_bytes_uploaded = 0
        self.pq_bytes_uploaded = 0
        self.reshards = 0

    @property
    def cap(self) -> int:
        return self._cap

    @property
    def n_loc(self) -> int:
        return self._cap // self.n_shards if self._cap else 0

    @property
    def n_words(self) -> int:
        return self._cap // 32

    @property
    def db(self) -> list:
        assert self._db is not None, "call sync() before reading the view"
        return self._db

    # ------------------------------------------------------------ copying
    def _blank(self, tail: tuple, dtype: torch.dtype) -> list:
        return [torch.zeros((self.n_loc,) + tail, dtype=dtype, device=dev)
                for dev in self.mesh]

    def _copy_rows(self, shards: list, host: np.ndarray, lo: int,
                   hi: int) -> None:
        """Copy host rows ``[lo, hi)`` (global ids) into the shards that
        cover them."""
        for s, a, b, la, lb in shard_spans(lo, hi, self.n_loc):
            shards[s][la:lb] = torch.from_numpy(
                np.ascontiguousarray(host[a:b])).to(self.mesh[s])

    def sync(self) -> bool:
        """Mirror any new store rows onto the shards. Returns True when the
        padded capacity changed (a full re-shard: masks packed for the old
        capacity are invalid and must be rebuilt)."""
        n = len(self.store)
        # Seam: the shards' host-to-device staging edge. A fault here models
        # a stalled or failed transfer; callers (staging, the sharded
        # launch) surface it to the scheduler's degradation ladder, which
        # downshifts the group to the flat executor.
        faults.fire("sharded.h2d")
        if self._compact_gen != self.store.compact_gen:
            # the store compacted without apply_remap (no maintenance
            # manager attached): every row moved, so rebuild below
            self._compact_gen = self.store.compact_gen
            self._db = None
        if self._db is None or n > self._cap:
            cap = max(self._cap, self.row_align)
            while cap < n:
                cap *= 2
            self._cap = cap
            self._db = self._blank((self.store.dim,), torch.float32)
            self._copy_rows(self._db, self.store.vectors, 0, n)
            self._synced = n
            self._sq, self._sq_n = None, 0
            self.db_bytes_uploaded += cap * self.store.dim * 4
            self.reshards += 1
            self._alive = None
            self._qdb = self._qscale = self._qsq = None
            self._pqdb = None
            return True
        if n > self._synced:
            self._copy_rows(self._db, self.store.vectors, self._synced, n)
            self.db_bytes_uploaded += (n - self._synced) * self.store.dim * 4
            self._synced = n
        return False

    def sq_device(self) -> list:
        """Per-shard fp32 squared row norms (the l2 term), computed on each
        shard from its own rows for the rows copied since the last call."""
        db = self.db
        if self._sq is None:
            self._sq = self._blank((), torch.float32)
            self._sq_n = 0
        for s, _, _, la, lb in shard_spans(self._sq_n, self._synced,
                                           self.n_loc):
            self._sq[s][la:lb] = row_sq_norms(db[s][la:lb])
        self._sq_n = self._synced
        return self._sq

    def q_device(self) -> Tuple[list, list]:
        """Per-shard int8 mirror ``(codes (n_loc, d) int8, scales (n_loc,)
        f32)``, built on the first quantized scan and then kept up by
        copying only the new rows. Padding rows are zero codes with zero
        scale (masked by the alive words anyway). Call :meth:`sync`
        first."""
        assert self._db is not None, "call sync() before q_device()"
        n = len(self.store)
        st = self.store
        if self._qdb is None:
            self._qdb = self._blank((st.dim,), torch.int8)
            self._qscale = self._blank((), torch.float32)
            self._q_synced = 0
            self.q_bytes_uploaded += self._cap * (st.dim + 4)
            lo = 0
        else:
            lo = self._q_synced
            self.q_bytes_uploaded += (n - lo) * (st.dim + 4)
        if n > lo:
            self._copy_rows(self._qdb, st.q_vectors, lo, n)
            self._copy_rows(self._qscale, st.q_scales, lo, n)
            if self._qsq is not None:
                self._copy_rows(self._qsq, st.q_sq_norms(), lo, n)
        self._q_synced = n
        return self._qdb, self._qscale

    def q_sq_device(self) -> list:
        """Per-shard squared norms of the dequantized rows (the int8 l2
        term): the store's host values, so every shard reads the flat
        executor's bits."""
        self.q_device()
        if self._qsq is None:
            self._qsq = self._blank((), torch.float32)
            self._copy_rows(self._qsq, self.store.q_sq_norms(), 0,
                            len(self.store))
        return self._qsq

    def pq_device(self) -> list:
        """Per-shard PQ code mirror ``(n_loc, M) uint8``, same lazy build
        and incremental copy as :meth:`q_device`. Call :meth:`sync`
        first."""
        assert self._db is not None, "call sync() before pq_device()"
        n = len(self.store)
        m = self.store.pq_codebook.m
        if self._pqdb is None:
            self._pqdb = self._blank((m,), torch.uint8)
            self.pq_bytes_uploaded += self._cap * m
            lo = 0
        else:
            lo = self._pq_synced
            self.pq_bytes_uploaded += (n - lo) * m
        if n > lo:
            self._copy_rows(self._pqdb, self.store.pq_codes, lo, n)
        self._pq_synced = n
        return self._pqdb

    def apply_remap(self) -> None:
        """Re-mirror a just-compacted store at the SAME capacity. Not a
        re-shard: the scope table's word layout (``cap/32`` words a scope)
        survives, which is what lets ``ShardedExecutor.apply_remap`` patch
        its slots through the id remap instead of evicting them."""
        self._compact_gen = self.store.compact_gen
        if self._db is None:
            return
        n = len(self.store)
        for t in self._db:
            t.zero_()
        self._copy_rows(self._db, self.store.vectors, 0, n)
        self.db_bytes_uploaded += self._cap * self.store.dim * 4
        self._synced = n
        self._sq, self._sq_n = None, 0
        self._alive = None                  # rebuilt from the store next read
        self._qdb = self._qscale = self._qsq = None
        self._pqdb = None
        self.store.log_consumer_reset(self._log_consumer)

    # -------------------------------------------------------------- alive
    def _upload_alive(self, w_lo: int, w_hi: int) -> None:
        for s, a, b, la, lb in shard_spans(w_lo, w_hi, self.n_loc // 32):
            self._alive[s][la:lb] = torch.from_numpy(
                self._alive_host[a:b].view(np.int32)).to(self.mesh[s])
        self.alive_bytes_uploaded += (w_hi - w_lo) * 4

    def _patch_alive_range(self, w_lo: int, w_hi: int) -> None:
        """Recompute words ``[w_lo, w_hi)`` from the store's state and copy
        only that range to the shards that hold it."""
        n = len(self.store)
        g0, g1 = w_lo * 32, w_hi * 32
        seg = np.zeros(g1 - g0, dtype=bool)
        hi = min(n, g1)
        if hi > g0:
            seg[: hi - g0] = ~self.store.deleted_mask()[g0:hi]
        self._alive_host[w_lo:w_hi] = np.packbits(
            seg, bitorder="little").view(np.uint32)
        self._upload_alive(w_lo, w_hi)

    def alive_device(self) -> list:
        """Per-shard ``(n_loc/32,)`` int32 alive ∧ in-range words:
        capacity-padding rows and tombstoned rows are 0. Appended rows and
        newly tombstoned ids (the store's tombstone log) patch only the
        word range they touch; the whole mask is rebuilt only after a
        re-shard or a compaction."""
        n = len(self.store)
        if self._alive is None:
            padded = np.zeros(self._cap, dtype=bool)
            ab = self.store.alive_bool()
            padded[:n] = True if ab is None else ab
            self._alive_host = np.packbits(
                padded, bitorder="little").view(np.uint32)
            self._alive = [torch.zeros(self.n_loc // 32, dtype=torch.int32,
                                       device=dev) for dev in self.mesh]
            self._upload_alive(0, self.n_words)
            self._alive_n = n
            self.store.log_consumer_reset(self._log_consumer)
            return self._alive
        dirty: Optional[Tuple[int, int]] = None
        if n > self._alive_n:
            dirty = (self._alive_n >> 5, ((n - 1) >> 5) + 1)
            self._alive_n = n
        fresh = self.store.consume_deleted_log(self._log_consumer)
        if fresh:
            lo, hi = min(fresh) >> 5, (max(fresh) >> 5) + 1
            dirty = ((min(dirty[0], lo), max(dirty[1], hi))
                     if dirty else (lo, hi))
        if dirty is not None:
            self._patch_alive_range(*dirty)
        return self._alive
