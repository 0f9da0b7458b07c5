"""Vector store: host-resident fp32 rows + an incrementally synced mirror on
the database's device.

Entry ids are row indices (uint32), the same ids the scope indexes keep in
their RoaringBitmaps, so the hand-off between the directory layer and the
executor is a pure id set / packed bitmask (§II-A of the paper).

The device mirror holds the rows and their squared norms. It grows by
amortised doubling and takes new rows with ``index_copy_`` when a reader
asks for it, so an ingest never re-uploads the rows already there. The
int8/PQ/tiered tiers of the reference store arrive with their own slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.common import row_sq_norms

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


class VectorStore:
    def __init__(self, dim: int, metric: str = "ip", capacity: int = 1024,
                 device=None):
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
        # device mirror: rows [0, _dev_n) are uploaded
        self._dev_rows: Optional[torch.Tensor] = None
        self._dev_sq: Optional[torch.Tensor] = None
        self._dev_n = 0
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
        self._n = new_n
        self._deleted[:old_n] = False
        self._n_deleted = 0
        # every tombstone in the log is now reclaimed; consumers rebuild
        # from the remap, not the log
        self._deleted_log.clear()
        self._deleted_log_base = 0
        for h in self._log_cursors:
            self._log_cursors[h] = 0
        self._dev_n = 0                   # rows moved: the mirror re-syncs
        self._alive_words = None
        self.compact_gen += 1
        return mapping

    # --------------------------------------------------------- device mirror
    def _sync_device(self) -> None:
        """Upload rows [_dev_n, _n) and their squared norms, doubling the
        mirror's capacity when it is full."""
        if self._dev_n == self._n and self._dev_rows is not None:
            return
        cap = 0 if self._dev_rows is None else self._dev_rows.shape[0]
        if cap < self._n:
            new_cap = max(self._n, 2 * cap, 1024)
            rows = torch.empty((new_cap, self.dim), dtype=torch.float32,
                               device=self.device)
            sq = torch.empty(new_cap, dtype=torch.float32, device=self.device)
            if self._dev_n:
                rows[: self._dev_n] = self._dev_rows[: self._dev_n]
                sq[: self._dev_n] = self._dev_sq[: self._dev_n]
            self._dev_rows, self._dev_sq = rows, sq
        lo, hi = self._dev_n, self._n
        if hi > lo:
            fresh = torch.from_numpy(self._rows[lo:hi]).to(self.device)
            idx = torch.arange(lo, hi, device=self.device)
            self._dev_rows.index_copy_(0, idx, fresh)
            self._dev_sq.index_copy_(0, idx, row_sq_norms(fresh))
        self._dev_n = self._n

    def device_vectors(self) -> torch.Tensor:
        """(n, d) fp32 rows on the store's device."""
        self._sync_device()
        return self._dev_rows[: self._n]

    def device_sq_norms(self) -> torch.Tensor:
        """(n,) fp32 squared row norms on the store's device (the l2 term;
        every executor path reads these same values)."""
        self._sync_device()
        return self._dev_sq[: self._n]

    def tiered_active(self) -> bool:
        """Tiered storage arrives with the PQ slice: the fp32 rows are
        always device-resident here."""
        return False

    # -------------------------------------------------------------- bytes
    def alive_count(self) -> int:
        return self._n - self._n_deleted

    def placement(self) -> Tuple[int, int]:
        """``(rows_device_pinned, rows_host)`` for alive rows: every row is
        device-resident (no tiered storage yet)."""
        return self.alive_count(), 0

    def nbytes(self) -> int:
        return self._n * self.dim * 4
