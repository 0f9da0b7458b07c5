"""Online index maintenance under streaming churn — the port's copy of
``repro/vectordb/maintenance.py``.

Streaming ingest/delete workloads degrade every layer that was built once
and then served: IVF partitions drift away from their frozen centroids and
accumulate tombstoned members (CSR pad waste + probe-recall loss), PG
adjacency rows fill with dead neighbors and pruned one-way edges (beam
recall loss), and the append-only store grows tombstoned rows that every
scan still streams past. :class:`MaintenanceManager` runs the three
counter-moves *online*, between serving batches:

* ``maint_pg_repair`` — :meth:`PGIndex.repair`: drop dead edges, heal
  asymmetric (one-way) edges, re-seed a dead entry point, re-link damaged
  nodes with a fresh beam search.
* ``maint_compact`` — :meth:`VectorStore.compact`: slide alive rows down
  over tombstones, then propagate the returned old->new id mapping through
  **every** id-bearing structure: each namespace's scope index
  (``remap_ids`` — deliberately *without* epoch bumps, membership did not
  change), each planner's :class:`ScopeMaskCache`, the sharded executor's
  device-resident mask table (word-patched at unchanged capacity, no slot
  eviction), and the IVF member lists / PG adjacency.
* ``maint_repartition`` — :meth:`IVFIndex.repartition`: retrain centroids
  on a seeded sample of the live rows and atomically swap in a rebuilt,
  tombstone-free partitioning.

Every op is journaled through the namespace's DSM machinery — root
region lock, BEGIN before any mutation, COMMIT after — so a crash at any
point is recovered by :meth:`DSMExecutor.recover` via the manager's
:meth:`replay` hook. Idempotence probes are *generation counters*
(``store.compact_gen``, ``ivf.repartition_gen``, ``pg.repair_gen``)
snapshotted into the intent payload: a suspect whose counter already
advanced only re-COMMITs; one that never reached its atomic swap re-runs
bit-identically (all three ops are deterministic functions of the
journaled payload + current state).

Device state follows the remap: ``store.compact`` resets every device
mirror (they re-upload from row 0 on the next read), the mask caches
rebuild each entry without its device words (the word count changed), and
the IVF index drops its device CSR layout, so nothing on the device keeps
the old numbering; the sharded executor re-mirrors its shards at the same
capacity and rewrites its resident scope slots through the mapping.

Concurrency contract: :meth:`step` serializes against structural DSM via
the root region lock, but it mutates store arrays the DSQ paths read — run
it from the serving scheduler's execute thread (``ContinuousScheduler``'s
``maintenance`` hook does exactly this, between device batches) or from
the only querying thread.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .. import faults
from ..core import DSM
from .graph import PGIndex
from .ivf import IVFIndex

DEFAULT_NS = "fs"


@dataclass
class MaintenancePolicy:
    """When is each op worth its cost? Fractions are of the live store
    size; ``*_min`` floors stop tiny stores from thrashing."""
    tombstone_fraction: float = 0.25     # compact when dead/total exceeds
    tombstone_min: int = 64
    pad_waste_fraction: float = 0.5      # repartition when pad/alive exceeds
    pad_waste_min: int = 256
    repair_deletes: int = 32             # PG repair every N observed deletes
    # relink budget per repair slice (bounds the serving-slot stall; 0 =
    # unbounded). Deferred damage keeps the op due until drained. Each
    # relink costs one beam search (~ms at serving graph sizes), so this
    # is the dominant term of a maintenance slot's latency.
    repair_budget: int = 32
    # cost-benefit horizon: an op also becomes due when the predicted
    # per-query waste (tombstone scan tax, CSR pad reads) summed over this
    # many queries exceeds the CostModel's predicted rebuild cost — the
    # fractional thresholds above remain as floors against thrash
    amortize_queries: int = 1000
    # repartition training knobs (journaled into the intent payload)
    seed: int = 0
    n_iters: int = 4
    sample: int = 4096


class MaintenanceManager:
    """Background maintenance driver for one :class:`DirectoryVectorDB`.

    One manager per database (anchored to ``namespace``'s journal; the ops
    themselves span all namespaces — a compaction remaps every id-bearing
    structure the db owns). Construct via :meth:`DirectoryVectorDB
    .maintenance`, which also wires :meth:`replay` into the executor so
    ``db.recover()`` can roll crashed maintenance forward."""

    def __init__(self, db, namespace: str = DEFAULT_NS,
                 policy: Optional[MaintenancePolicy] = None):
        self.db = db
        self.namespace = namespace
        self.policy = policy or MaintenancePolicy()
        self._dsm = db._dsm[namespace]
        # registered tombstone-log consumer: how much churn PG repair has
        # not yet looked at (registering also bounds the log — see
        # VectorStore._truncate_deleted_log)
        self._log_consumer = db.store.register_log_consumer()
        # tombstones that predate this manager still degrade the graph
        self._unrepaired_deletes = db.store.n_deleted
        # pad waste measured right after the last repartition: CSR tiling
        # has an irreducible waste floor (partial tiles), so re-triggering
        # below it would loop forever making zero progress
        self._waste_floor: Optional[int] = None
        self.ops_run: Dict[str, int] = {}
        self.ops_replayed: Dict[str, int] = {}
        self.last_result: Dict[str, dict] = {}
        self.maintenance_ns = 0          # total wall-clock spent in step()

    # ------------------------------------------------------------- scheduling
    def _ivf(self) -> Optional[IVFIndex]:
        ex = self.db.executors.get("ivf")
        return ex if isinstance(ex, IVFIndex) else None

    def _pg(self) -> Optional[PGIndex]:
        ex = self.db.executors.get("pg")
        return ex if isinstance(ex, PGIndex) else None

    def due(self) -> List[str]:
        """Due op kinds, in execution order: repair first (it wants the
        tombstones still visible), then compaction (changes the id space),
        then repartition (rebuilds on the compacted ids).

        Compaction and repartition trigger on EITHER the policy fraction
        OR the CostModel's amortized verdict: the per-query waste those
        ops remove (tombstone rows every scan streams past, CSR pad reads)
        summed over ``policy.amortize_queries`` queries against the
        predicted one-off rebuild cost. The ``*_min`` floors always apply
        — a cheap rebuild of a tiny store is still not worth thrashing."""
        from .costmodel import model_of
        store = self.db.store
        pol = self.policy
        model = model_of(store)
        dim = store.dim
        out: List[str] = []
        self._unrepaired_deletes += len(
            store.consume_deleted_log(self._log_consumer))
        if (self._pg() is not None
                and self._unrepaired_deletes >= pol.repair_deletes):
            out.append("maint_pg_repair")
        n = len(store)
        dead = store.n_deleted
        if dead >= pol.tombstone_min:
            tax = (dead / max(n, 1)) * model.scan_ns(n, "fp32", dim) \
                * pol.amortize_queries
            if (dead >= pol.tombstone_fraction * max(n, 1)
                    or tax > model.compact_ns(n, dim)):
                out.append("maint_compact")
        ivf = self._ivf()
        if ivf is not None and n > 0:
            waste = ivf.pad_waste()
            alive = max(n - dead, 1)
            tax = (waste / alive) * model.scan_ns(alive, "fp32", dim) \
                * pol.amortize_queries
            if (waste >= pol.pad_waste_min
                    and (waste >= pol.pad_waste_fraction * alive
                         or tax > model.repartition_ns(alive, dim,
                                                       pol.n_iters))
                    and (self._waste_floor is None
                         or waste > self._waste_floor)):
                out.append("maint_repartition")
        return out

    def predicted_ns(self, kind: str) -> float:
        """CostModel's predicted cost of one ``kind`` slot (observability;
        schedulers can budget a slot against it before committing)."""
        from .costmodel import model_of
        store = self.db.store
        model = model_of(store)
        n, dim = len(store), store.dim
        if kind == "maint_compact":
            return model.compact_ns(n, dim)
        if kind == "maint_repartition":
            return model.repartition_ns(max(n - store.n_deleted, 1), dim,
                                        self.policy.n_iters)
        if kind == "maint_pg_repair":
            pg = self._pg()
            damaged = self.policy.repair_budget or (
                len(pg._pending_relink) if pg else 0) or 1
            return model.pg_repair_ns(n, damaged,
                                      ef=pg.ef_construction if pg else 32,
                                      dim=dim)
        return 0.0

    def step(self) -> Optional[dict]:
        """Run AT MOST one due maintenance op (bounded work per serving
        slot). Returns ``{"kind", "result", "us", "predicted_us"}`` or
        None when idle."""
        due = self.due()
        if not due:
            return None
        kind = due[0]
        pred = self.predicted_ns(kind)
        t0 = time.perf_counter_ns()
        result = self._run(kind)
        dt = time.perf_counter_ns() - t0
        self.maintenance_ns += dt
        self.ops_run[kind] = self.ops_run.get(kind, 0) + 1
        self.last_result[kind] = result
        return {"kind": kind, "result": result, "us": dt / 1e3,
                "predicted_us": pred / 1e3}

    def run_all(self, max_ops: int = 16) -> List[dict]:
        """Drain every due op (the offline / test entry point)."""
        out = []
        for _ in range(max_ops):
            r = self.step()
            if r is None:
                break
            out.append(r)
        return out

    def stats(self) -> Dict[str, object]:
        return {"ops_run": dict(self.ops_run),
                "ops_replayed": dict(self.ops_replayed),
                "maintenance_us": self.maintenance_ns // 1000,
                "unrepaired_deletes": self._unrepaired_deletes,
                "journal_pending": len(self._dsm.journal.uncommitted())}

    # -------------------------------------------------------------- execution
    def _intent(self, kind: str) -> DSM:
        """Build the journaled intent: generation snapshot + the op's full
        deterministic parameterization, so crash replay re-runs the exact
        same mutation."""
        store = self.db.store
        pol = self.policy
        if kind == "maint_compact":
            return DSM(kind, f"gen={store.compact_gen}")
        if kind == "maint_pg_repair":
            pg = self._pg()
            return DSM(kind, f"gen={pg.repair_gen if pg else 0}"
                             f"&budget={pol.repair_budget}")
        if kind == "maint_repartition":
            ivf = self._ivf()
            gen = ivf.repartition_gen if ivf else 0
            return DSM(kind, f"gen={gen}&seed={pol.seed}"
                             f"&n_iters={pol.n_iters}&sample={pol.sample}")
        raise ValueError(f"unknown maintenance kind {kind!r}")

    def _run(self, kind: str) -> dict:
        """Journal + apply one op under the root region lock (BEGIN before
        mutation, COMMIT after — the §IV-A ordering, same as DSMExecutor
        .apply but with the manager as the mutator)."""
        ex = self._dsm
        op = self._intent(kind)
        token = ex.locks.acquire(op.affected_region())
        try:
            seq = ex.journal.begin(op)
            # Kill point: intent durable, mutation not yet applied — the
            # crash window recovery's gen-counter probe must roll forward.
            faults.fire("maint.apply")
            try:
                result = self._apply(op)
            except Exception:
                ex.journal.abort(seq)
                raise
            ex.journal.commit(seq)
            return result
        finally:
            ex.locks.release(token)

    def _apply(self, op: DSM) -> dict:
        if op.kind == "maint_compact":
            return self._apply_compact()
        if op.kind == "maint_pg_repair":
            return self._apply_pg_repair(op.payload())
        if op.kind == "maint_repartition":
            return self._apply_repartition(op.payload())
        raise ValueError(f"unknown maintenance kind {op.kind!r}")

    def _apply_pg_repair(self, payload: Dict[str, str]) -> dict:
        pg = self._pg()
        if pg is None:
            return {"skipped": "no pg executor"}
        budget = int(payload.get("budget", 0)) or None
        out = pg.repair(max_relink=budget)
        # deferred damage keeps the op due: the next slice drains it
        self._unrepaired_deletes = (self.policy.repair_deletes
                                    if out.get("remaining_damage") else 0)
        return out

    def _apply_repartition(self, payload: Dict[str, str]) -> dict:
        ivf = self._ivf()
        if ivf is None:
            return {"skipped": "no ivf executor"}
        out = ivf.repartition(seed=int(payload.get("seed", 0)),
                              n_iters=int(payload.get("n_iters", 4)),
                              sample=int(payload.get("sample", 0)) or None)
        self._waste_floor = int(out.get("pad_waste_after", 0))
        return out

    def _apply_compact(self) -> dict:
        store = self.db.store
        old_n = len(store)
        mapping = store.compact()
        if mapping is None:
            return {"reclaimed": 0, "n": old_n}
        self._propagate_remap(mapping)
        return {"reclaimed": old_n - len(store), "n": len(store)}

    def _propagate_remap(self, mapping: np.ndarray) -> None:
        """Push the compaction id mapping through every structure that
        stores entry ids — the ``IdRemap`` event of the scope-epoch
        contract, orchestrated explicitly (no event bus): scope postings
        and catalogs move *without* epoch bumps, mask caches patch their
        packed words the same way, executors rewrite their member/adjacency
        ids. Order matters only for the sharded tier, whose view re-mirror
        must land before the next ``sync`` sees the shrunken store."""
        db = self.db
        new_n = len(db.store)
        for idx in db.namespaces.values():
            idx.remap_ids(mapping)
        for planner in db._planners.values():
            planner.cache.apply_remap(mapping, new_n)
        sharded = db.executors.get("sharded")
        if sharded is not None:
            sharded.apply_remap(mapping)
        ivf = self._ivf()
        if ivf is not None:
            ivf.remap_ids(mapping)
        pg = self._pg()
        if pg is not None:
            pg.remap_ids(mapping)
        # hot-pin candidate pools hold raw id arrays per scope key
        m = np.asarray(mapping, dtype=np.int64)
        for pool in db._hot_scope_ids.values():
            for key, ids in list(pool.items()):
                ids = m[np.asarray(ids, dtype=np.int64)]
                pool[key] = ids[ids >= 0]
        # nothing left in the tombstone log concerns any consumer: the dead
        # rows no longer exist (compact() already reset every cursor)
        self._unrepaired_deletes = 0

    # --------------------------------------------------------------- recovery
    def replay(self, op: DSM) -> bool:
        """``DSMExecutor.maintenance_replay`` hook: idempotent crash
        replay. The journaled ``gen`` is the generation counter *before*
        the mutation — if the live counter still equals it, the crash hit
        before the atomic swap and the op re-runs (deterministically, from
        the journaled payload); if the counter advanced, the op completed
        and only the COMMIT was lost, so nothing re-runs."""
        payload = op.payload()
        gen = int(payload.get("gen", 0))
        if op.kind == "maint_compact":
            cur = self.db.store.compact_gen
        elif op.kind == "maint_pg_repair":
            pg = self._pg()
            cur = pg.repair_gen if pg else gen + 1
        elif op.kind == "maint_repartition":
            ivf = self._ivf()
            cur = ivf.repartition_gen if ivf else gen + 1
        else:
            raise ValueError(f"unknown maintenance kind {op.kind!r}")
        if cur != gen:
            return False                 # already applied pre-crash
        self._apply(op)
        self.ops_replayed[op.kind] = self.ops_replayed.get(op.kind, 0) + 1
        return True


__all__ = ["MaintenanceManager", "MaintenancePolicy"]
