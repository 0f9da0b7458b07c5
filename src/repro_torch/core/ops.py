"""DSQ / DSM operator layer (§II-C) with the consistency protocol of §IV-A.

* :class:`DSQ` — declarative query op: anchor path, recursive flag, exclusion
  branches, top-k; resolved against any :class:`ScopeIndex` into a candidate
  entry-ID set for the ANN executor.
* :class:`DSM` — declarative structural mutation (MOVE / MERGE / MKDIR /
  REMOVE), applied under a prefix-region lock with a write-ahead journal so a
  crashed mutation can be detected and replayed/rolled forward on restart.
* :class:`DSMExecutor` — single-op and group-committed batched application
  with FIFO-fair region scheduling and idempotent crash recovery.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import faults
from . import paths as P
from .idset import RoaringBitmap
from .interface import DSMStats, ResolveStats, ScopeIndex


# --------------------------------------------------------------------- DSQ
@dataclass(frozen=True)
class DSQ:
    path: str
    recursive: bool = True
    exclude: Tuple[str, ...] = ()
    k: int = 10

    def resolve(self, index: ScopeIndex,
                stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        if self.exclude:
            return index.resolve_exclusion(
                self.path, list(self.exclude), recursive=self.recursive,
                stats=stats)
        return index.resolve(self.path, recursive=self.recursive, stats=stats)


# --------------------------------------------------------------------- DSM
#: DSM kinds with this prefix are *background-maintenance* intents
#: (IVF re-partition, PG repair, tombstone compaction). They are journaled
#: and region-locked through the same machinery as structural mutations,
#: but applied by a ``MaintenanceManager`` rather than ``DSM.apply`` — the
#: ``src`` field carries an opaque ``k=v&k=v`` payload, not a path.
MAINT_PREFIX = "maint_"


@dataclass(frozen=True)
class DSM:
    kind: str                 # "move" | "merge" | "mkdir" | "remove" | maint_*
    src: str
    dst: str = ""             # move: new parent; merge: target subtree

    @property
    def is_maintenance(self) -> bool:
        return self.kind.startswith(MAINT_PREFIX)

    def affected_region(self) -> List[P.Path]:
        """Prefix regions this mutation touches (for overlap serialization):
        move covers the source subtree + destination path; merge covers the
        source and target subtrees; remove covers the removed subtree
        (§IV-A Consistency During Updates). Maintenance ops rebuild
        store-global structures (layouts, id space), so they claim the root
        region and serialize against every structural mutation."""
        if self.is_maintenance:
            return [P.ROOT]
        regions = [P.parse(self.src)]
        if self.dst:
            regions.append(P.parse(self.dst))
        return regions

    def payload(self) -> Dict[str, str]:
        """Decode a maintenance op's ``k=v&k=v`` ``src`` payload."""
        out: Dict[str, str] = {}
        for part in self.src.split("&"):
            if "=" in part:
                k, _, v = part.partition("=")
                out[k] = v
        return out

    def apply(self, index: ScopeIndex,
              stats: Optional[DSMStats] = None) -> Optional[RoaringBitmap]:
        if self.kind == "move":
            index.move(self.src, self.dst, stats=stats)
        elif self.kind == "merge":
            index.merge(self.src, self.dst, stats=stats)
        elif self.kind == "mkdir":
            index.mkdir(self.src)
            if stats is not None:
                stats.ops += 1
        elif self.kind == "remove":
            return index.remove(self.src, stats=stats)
        else:
            raise ValueError(f"unknown DSM kind {self.kind!r}")
        return None


def regions_overlap(a: Sequence[P.Path], b: Sequence[P.Path]) -> bool:
    """Two mutations conflict when any affected prefix regions are nested."""
    for ra in a:
        for rb in b:
            if P.is_ancestor(ra, rb) or P.is_ancestor(rb, ra):
                return True
    return False


class RegionLockManager:
    """Serializes DSM ops on overlapping trie regions; disjoint regions may
    proceed concurrently (the paper serializes overlapping paths only).

    Admission is FIFO-fair: a waiter may acquire only when its regions
    overlap neither a held lock nor an *earlier-enqueued* waiter. The
    previous implementation let whichever thread woke first barge past
    earlier waiters, which both starved writers under a stream of small
    overlapping ops and could reorder two dependent mutations (apply a
    later op before an earlier one it overlaps — a correctness hole for
    ``apply_many`` batches, whose semantics are submission order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._held: Dict[int, List[P.Path]] = {}
        self._waiting: List[Tuple[int, List[P.Path]]] = []   # FIFO arrival
        self._next = 0

    def enqueue(self, regions: List[P.Path]) -> int:
        """Reserve a FIFO slot without blocking; pair with :meth:`wait`."""
        with self._cond:
            token = self._next
            self._next += 1
            self._waiting.append((token, regions))
            return token

    def _admissible(self, token: int, regions: List[P.Path]) -> bool:
        if any(regions_overlap(regions, r) for r in self._held.values()):
            return False
        for t2, r2 in self._waiting:     # arrival order
            if t2 == token:
                return True
            if regions_overlap(regions, r2):
                return False
        return True

    def wait(self, token: int) -> int:
        """Block until the enqueued slot ``token`` may hold its regions."""
        with self._cond:
            regions = next(r for t, r in self._waiting if t == token)
            while not self._admissible(token, regions):
                self._cond.wait()
            self._waiting.remove((token, regions))
            self._held[token] = regions
            return token

    def acquire(self, regions: List[P.Path]) -> int:
        return self.wait(self.enqueue(regions))

    def release(self, token: int) -> None:
        with self._cond:
            self._held.pop(token, None)
            self._cond.notify_all()

    def cancel(self, token: int) -> None:
        """Withdraw an enqueued-but-never-acquired slot (batch setup failed
        partway); waiters queued behind it must not defer to it forever."""
        with self._cond:
            self._waiting = [(t, r) for t, r in self._waiting if t != token]
            self._cond.notify_all()


class DSMJournal:
    """Write-ahead intent journal: BEGIN is durable before the mutation runs,
    COMMIT (or ABORT, for mutations that raised) after. Recovery surfaces
    uncommitted ops for replay.

    Sequence numbers are monotonic across reopens: construction scans the
    persisted file and continues from the highest seq found, so a restarted
    process can never re-issue a seq that an old COMMIT record already pairs
    with (the reopen collision that silently masked crash suspects). A
    partially-written trailing record (crash mid-append) is *truncated* on
    reopen — merely skipping it would glue the next append onto the torn
    line and lose every post-reopen record to future scans.

    Only the live intent set (BEGINs without a COMMIT/ABORT) is retained in
    memory: resolved pairs are dropped as they pair up, so a long-lived
    maintenance process stays O(outstanding ops), not O(history), and
    ``uncommitted()`` never rescans the file.

    The *file* is bounded the same way: every ``auto_compact_every``
    resolved (committed/aborted) records the journal rewrites itself down
    to the outstanding BEGINs plus a ``seq`` watermark record. The
    watermark is what keeps sequence numbers monotonic across a
    compact-to-empty + reopen — without it a compacted file with no
    pending intents is empty and a reopen would restart seqs at 0,
    recreating the reopen-collision bug the scan-for-max exists to
    prevent."""

    def __init__(self, path: Optional[str] = None,
                 auto_compact_every: int = 512,
                 fsync_on_commit: bool = False):
        self.path = path
        self.auto_compact_every = auto_compact_every
        self.fsync_on_commit = fsync_on_commit
        self._resolved_since_compact = 0
        self._pending: Dict[int, DSM] = {}
        self._seq = 0
        self._lock = threading.Lock()
        if path:
            # A crash between writing the compaction tmp and os.replace
            # leaves a stray sibling behind; the journal itself is still
            # the authority (the replace never happened), so the tmp is
            # dead weight — drop it before it can shadow a later compact.
            for stale in (path + ".compact", path + ".tmp"):
                if os.path.exists(stale):
                    os.remove(stale)
        if path and os.path.exists(path):
            valid_bytes = 0
            with open(path, "rb") as f:
                data = f.read()
            for line in data.splitlines(keepends=True):
                if not line.endswith(b"\n"):
                    break                    # torn tail: crash mid-append
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break
                valid_bytes += len(line)
                self._replay_record(rec)
            if valid_bytes < len(data):
                with open(path, "rb+") as f:
                    f.truncate(valid_bytes)  # future appends start clean

    def _replay_record(self, rec: dict) -> None:
        ev = rec.get("event")
        if ev == "begin":
            self._pending[rec["seq"]] = DSM(rec["kind"], rec["src"],
                                            rec.get("dst", ""))
        elif ev in ("commit", "abort"):
            for s in rec.get("seqs", [rec.get("seq")]):
                self._pending.pop(s, None)
        for s in rec.get("seqs", [rec.get("seq", -1)]):
            self._seq = max(self._seq, int(s) + 1)

    def _write(self, recs: List[dict]) -> None:
        now = time.time()
        for rec in recs:
            rec["ts"] = now
        if self.path:
            payload = "".join(json.dumps(r) + "\n" for r in recs)
            # Seam: raises ENOSPC/crash before any byte lands (intent lost,
            # in-memory state untouched by our callers' ordering), or
            # returns a short_write rule — then a payload *prefix* lands
            # and the simulated process dies, leaving the torn tail that
            # reopen-truncation must repair.
            rule = faults.fire("journal.write")
            with open(self.path, "a") as f:
                if rule is not None and rule.kind == "short_write":
                    f.write(payload[:max(1, int(len(payload)
                                               * rule.fraction))])
                    f.flush()
                    raise faults.InjectedCrash("journal.write")
                f.write(payload)
                f.flush()
                if self.fsync_on_commit:
                    faults.fire("journal.fsync")
                    os.fsync(f.fileno())

    def begin(self, op: DSM) -> int:
        return self.begin_many([op])[0]

    def begin_many(self, ops: Sequence[DSM]) -> List[int]:
        """Durably record intent for a whole batch in ONE append+flush
        (group commit's front half)."""
        with self._lock:
            seqs = list(range(self._seq, self._seq + len(ops)))
            self._seq += len(ops)
            self._write([{"event": "begin", "seq": s, "kind": op.kind,
                          "src": op.src, "dst": op.dst}
                         for s, op in zip(seqs, ops)])
            self._pending.update(zip(seqs, ops))
            return seqs

    def commit(self, seq: int) -> None:
        with self._lock:
            self._write([{"event": "commit", "seq": seq}])
            self._pending.pop(seq, None)
            self._note_resolved(1)

    def commit_many(self, seqs: Sequence[int]) -> None:
        """Group commit: one record, one append+flush for the whole batch."""
        if not seqs:
            return
        with self._lock:
            self._write([{"event": "commit", "seqs": list(seqs)}])
            for s in seqs:
                self._pending.pop(s, None)
            self._note_resolved(len(seqs))

    def abort(self, seq: int) -> None:
        """Record that a journaled mutation raised before changing anything,
        so recovery does not treat it as a crash suspect."""
        with self._lock:
            self._write([{"event": "abort", "seq": seq}])
            self._pending.pop(seq, None)
            self._note_resolved(1)

    def _note_resolved(self, n: int) -> None:
        """Count resolved intents and auto-compact past the threshold
        (called with ``_lock`` held)."""
        self._resolved_since_compact += n
        if (self.path and self.auto_compact_every
                and self._resolved_since_compact >= self.auto_compact_every):
            self._compact_locked()

    def uncommitted(self) -> List[Tuple[int, DSM]]:
        """(seq, op) pairs whose BEGIN has no matching COMMIT/ABORT, in seq
        order — the crash suspects recovery must replay."""
        with self._lock:
            return sorted(self._pending.items())

    def compact(self) -> None:
        """Rewrite the file down to the outstanding BEGINs (resolved pairs
        dropped), bounding on-disk growth for long-lived processes. Safe at
        any quiesced point; the rewrite is atomic (tmp file + rename)."""
        if not self.path:
            return
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.path + ".compact"
        now = time.time()
        with open(tmp, "w") as f:
            if self._seq > 0:
                # seq watermark: keeps seqs monotonic across reopen even
                # when every intent below resolved (file otherwise empty)
                f.write(json.dumps({"event": "seq", "seq": self._seq - 1,
                                    "ts": now}) + "\n")
            for seq, op in sorted(self._pending.items()):
                f.write(json.dumps(
                    {"event": "begin", "seq": seq, "kind": op.kind,
                     "src": op.src, "dst": op.dst, "ts": now}) + "\n")
            f.flush()
        # Kill point: tmp fully written, old journal still authoritative.
        # A crash here leaves the stray tmp that __init__ cleans on reopen.
        faults.fire("journal.compact.tmp")
        os.replace(tmp, self.path)
        # Kill point: replace done — the compacted file IS the journal now;
        # reopen must recover identically from it.
        faults.fire("journal.compact.done")
        self._resolved_since_compact = 0

    @staticmethod
    def recover(path: str) -> List[DSM]:
        """Return ops whose BEGIN has no matching COMMIT (crash suspects)."""
        return [op for _, op in DSMJournal(path).uncommitted()]


@dataclass
class DSMBatchResult:
    """Outcome of one group-committed :meth:`DSMExecutor.apply_many` call."""
    results: List[Optional[RoaringBitmap]]   # per-op (REMOVE returns ids)
    errors: List[Optional[Exception]]        # per-op rejection, None if ok
    stats: DSMStats

    @property
    def applied(self) -> int:
        return sum(1 for e in self.errors if e is None)


class DSMExecutor:
    """Applies DSM ops with region locking + journaling, in the fixed order
    of §IV-A: lock region -> journal BEGIN -> mutate (collect affected set,
    relink, refresh catalog/aggregates inside the index) -> journal COMMIT."""

    def __init__(self, index: ScopeIndex, journal: Optional[DSMJournal] = None):
        self.index = index
        self.journal = journal or DSMJournal()
        self.locks = RegionLockManager()
        # Optional ``fn(op) -> replayed`` hook for ``maint_*`` crash
        # suspects; set by the MaintenanceManager that owns the op kinds
        # (the scope index alone cannot probe or re-run a layout rebuild).
        self.maintenance_replay = None

    def apply(self, op: DSM,
              stats: Optional[DSMStats] = None) -> Optional[RoaringBitmap]:
        t0 = time.perf_counter_ns()
        token = self.locks.acquire(op.affected_region())
        t1 = time.perf_counter_ns()
        try:
            seq = self.journal.begin(op)
            t2 = time.perf_counter_ns()
            try:
                result = op.apply(self.index, stats)
            except Exception:
                self.journal.abort(seq)
                raise
            self.journal.commit(seq)
            if stats is not None:
                t3 = time.perf_counter_ns()
                st = stats.stage_ns
                st["lock_wait"] = st.get("lock_wait", 0) + t1 - t0
                st["journal"] = st.get("journal", 0) + t2 - t1
                st["apply"] = st.get("apply", 0) + t3 - t2
            return result
        finally:
            self.locks.release(token)

    def apply_many(self, ops: Sequence[DSM],
                   stats: Optional[DSMStats] = None,
                   max_workers: int = 4) -> DSMBatchResult:
        """Group-commit a batch of DSM ops under region-lock scheduling.

        All BEGIN intents land in one journal append, then ops run through
        the FIFO region scheduler — overlapping regions apply strictly in
        submission order, disjoint regions concurrently — and every op that
        applied cleanly shares ONE COMMIT record (ops the index rejected are
        ABORTed individually and surfaced in ``errors``, not raised: a
        workload replayed against a drifted tree legitimately loses some
        sources to earlier merges)."""
        ops = list(ops)
        out = DSMBatchResult(results=[None] * len(ops),
                             errors=[None] * len(ops),
                             stats=stats if stats is not None else DSMStats())
        if not ops:
            return out
        # regions parse BEFORE anything is journaled or enqueued: a
        # malformed op fails the whole batch cleanly (no dangling BEGINs,
        # no stranded FIFO tickets for later acquirers to defer to)
        regions = [op.affected_region() for op in ops]
        t0 = time.perf_counter_ns()
        seqs = self.journal.begin_many(ops)
        # FIFO slots reserved in submission order BEFORE any worker runs:
        # this is what pins overlapping ops to batch order regardless of
        # which worker thread wakes first.
        tokens = [self.locks.enqueue(r) for r in regions]
        per_op = [DSMStats() for _ in ops]     # thread-private, merged after

        def work(i: int) -> None:
            self.locks.wait(tokens[i])
            try:
                out.results[i] = ops[i].apply(self.index, per_op[i])
            except Exception as e:
                # any failure is recorded per-op, never raised: an escaping
                # exception on the sequential path would abandon the
                # remaining tickets and wedge the region queue
                out.errors[i] = e
            finally:
                self.locks.release(tokens[i])

        t1 = time.perf_counter_ns()
        if max_workers <= 1 or len(ops) == 1:
            for i in range(len(ops)):
                work(i)
        else:
            # submission order == token order, so a waiting task's blockers
            # are always already started (no pool-slot deadlock)
            with ThreadPoolExecutor(
                    max_workers=min(max_workers, len(ops))) as pool:
                list(pool.map(work, range(len(ops))))
        t2 = time.perf_counter_ns()
        self.journal.commit_many(
            [s for s, e in zip(seqs, out.errors) if e is None])
        for s, e in zip(seqs, out.errors):
            if e is not None:
                self.journal.abort(s)
        for ps in per_op:
            out.stats.merge(ps)
        st = out.stats.stage_ns
        st["journal"] = (st.get("journal", 0) + (t1 - t0)
                         + time.perf_counter_ns() - t2)
        st["apply"] = st.get("apply", 0) + t2 - t1
        return out

    # ------------------------------------------------------------- recovery
    def _needs_replay(self, op: DSM) -> bool:
        """Idempotence probe: did the crashed mutation already reach the
        index before the COMMIT was lost? Source-missing / destination-
        present implies the op (or an equivalent later one) took effect."""
        if op.kind == "move":
            # src still present -> the relocation never ran: replay. src
            # missing means either the moved name now sits under dst
            # (applied) or the BEGIN belonged to an op the index rejected —
            # nothing to replay in both cases.
            return self.index.has_dir(op.src)
        if op.kind == "merge":
            return self.index.has_dir(op.src)
        if op.kind == "mkdir":
            return not self.index.has_dir(op.src)
        if op.kind == "remove":
            return self.index.has_dir(op.src)
        return False

    def recover(self, stats: Optional[DSMStats] = None
                ) -> List[Tuple[DSM, bool, Optional[RoaringBitmap]]]:
        """Roll forward every uncommitted journal op, idempotently: ops the
        probe shows already applied are only re-COMMITted; ops the index
        rejects (the BEGIN belonged to a mutation that raised pre-crash) are
        ABORTed. Ends with a full ``check_invariants`` pass. Returns
        ``(op, replayed, result)`` triples for every resolved suspect —
        ``result`` is a replayed REMOVE's entry-id set, which the caller
        must tombstone/purge exactly as a live remove would be."""
        outcome: List[Tuple[DSM, bool, Optional[RoaringBitmap]]] = []
        for seq, op in self.journal.uncommitted():
            token = self.locks.acquire(op.affected_region())
            try:
                replayed = False
                result: Optional[RoaringBitmap] = None
                try:
                    if op.is_maintenance:
                        # the maintenance manager owns the probe+apply: its
                        # generation counters tell whether the crashed
                        # rebuild reached the swap before the COMMIT was
                        # lost. Without a registered manager the intent is
                        # dropped (re-triggered by the next due check).
                        if self.maintenance_replay is not None:
                            replayed = bool(self.maintenance_replay(op))
                    elif self._needs_replay(op):
                        result = op.apply(self.index, stats)
                        replayed = True
                    self.journal.commit(seq)
                except (KeyError, ValueError):
                    self.journal.abort(seq)
                outcome.append((op, replayed, result))
            finally:
                self.locks.release(token)
        self.index.check_invariants()
        return outcome
