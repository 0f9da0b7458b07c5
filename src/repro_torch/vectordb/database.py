"""DirectoryVectorDB — the paper's system: scope index × ANN executor, on one
torch device.

Composes (1) one or more *namespaces* (independent directory hierarchies,
e.g. ARXIV-Dir's subject + temporal trees), each backed by a pluggable
ScopeIndex strategy, with (2) a vector store mirrored on the database's
device and the flat fp32 executor. DSQ runs scope resolution first, then
ranks inside the resolved candidate set; DSM goes through the journaled,
region-locked executor (§IV-A consistency ordering), and its delta events
patch the planner's device-resident scope masks.

This slice ports the flat fp32 path; the IVF, proximity-graph and sharded
executors, the quantized tiers and online maintenance raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (DSM, DSMBatchResult, DSMExecutor, DSMJournal, DSMStats,
                    ResolveStats, ScopeIndex, make_scope_index)
from ..core.interface import normalize_batch
from ..device import resolve_device
from .costmodel import install_kernel_tuning, model_of, resolve_calibration
from .flat import FlatExecutor
from .planner import BatchAccounting, BatchPlanner, ScopeMaskCache
from .store import VectorStore

DEFAULT_NS = "fs"


@dataclass
class DSQResult:
    ids: np.ndarray                  # (q, k) int64, -1 padded
    scores: np.ndarray               # (q, k) float32
    scope_size: int
    directory_ns: int                # directory-only latency (candidate set gen)
    ann_ns: int                      # executor latency
    resolve_stats: ResolveStats = field(default_factory=ResolveStats)
    plan: str = ""                   # "gather" | "scan" | "empty" (batch path)
    scope_shared: int = 1            # requests sharing this scope in the batch
    batch: Optional[BatchAccounting] = None   # shared-resolution accounting

    @property
    def total_ns(self) -> int:
        return self.directory_ns + self.ann_ns


class DirectoryVectorDB:
    def __init__(self, dim: int, metric: str = "ip",
                 scope_strategy: str = "triehi",
                 journal_path: Optional[str] = None,
                 calibration=None, device=None):
        """``device`` holds the store's mirror, the scope masks and every
        kernel launch; ``None`` means ``"cuda"``, and without a card only
        ``device="cpu"`` runs (the plain PyTorch path).

        ``journal_path`` makes every namespace's DSM executor journal to
        ``{journal_path}.{namespace}``. Reopening an existing journal
        continues its sequence numbers from the persisted tail; after the
        caller restores index state on restart, :meth:`recover` replays any
        op whose COMMIT was lost to a crash.

        ``calibration`` attaches the measured cost model that replaces the
        hand-set planner/executor constants: a calibration-artifact path,
        parsed artifact dict, or :class:`~repro_torch.vectordb.costmodel
        .CostModel`. ``None`` reads the ``REPRO_CALIBRATION`` env var,
        falling back to the heuristic model; ``False`` pins the heuristic
        model explicitly. An artifact calibrated on another backend than
        this device's degrades to the roofline model."""
        self.device = resolve_device(device)
        self.store = VectorStore(dim, metric, device=self.device)
        self.store.cost_model = resolve_calibration(calibration, self.device)
        if self.store.cost_model.source == "measured":
            install_kernel_tuning(self.store.cost_model)
        self.scope_strategy = scope_strategy
        self.namespaces: Dict[str, ScopeIndex] = {}
        self.executors: Dict[str, FlatExecutor] = {}
        self._dsm: Dict[str, DSMExecutor] = {}
        self._planners: Dict[str, BatchPlanner] = {}
        self._journal_path = journal_path
        self.namespace(DEFAULT_NS)  # default filesystem namespace

    # -------------------------------------------------------------- plumbing
    def namespace(self, name: str) -> ScopeIndex:
        if name not in self.namespaces:
            idx = make_scope_index(self.scope_strategy)
            self.namespaces[name] = idx
            journal = DSMJournal(
                f"{self._journal_path}.{name}" if self._journal_path else None)
            self._dsm[name] = DSMExecutor(idx, journal)
        return self.namespaces[name]

    def build_ann(self, kind: str, **params) -> None:
        if kind == "flat":
            self.executors["flat"] = FlatExecutor(self.store)
        elif kind in ("ivf", "pg", "sharded"):
            raise NotImplementedError(
                f"the {kind!r} executor is not ported yet (ROADMAP queue 1)")
        else:
            raise ValueError(f"unknown ANN executor {kind!r}")

    # ------------------------------------------------------------- ingestion
    def ingest(self, vectors: np.ndarray,
               dir_paths: Sequence[str],
               namespaces: Optional[Dict[str, Sequence[str]]] = None
               ) -> np.ndarray:
        """Bulk-insert vectors bound to directories. ``namespaces`` maps extra
        namespace name -> per-entry path (e.g. subject + temporal trees)."""
        ids = self.store.add(vectors)
        ns_paths = {DEFAULT_NS: dir_paths}
        if namespaces:
            ns_paths.update(namespaces)
        self._bind(ids, ns_paths)
        return ids

    def _bind(self, ids: np.ndarray,
              ns_paths: Dict[str, Sequence[Optional[str]]]) -> None:
        """Insert store ids into each namespace (``None`` paths skipped)."""
        for ns_name, paths in ns_paths.items():
            idx = self.namespace(ns_name)
            if len(paths) != len(ids):
                raise ValueError(f"namespace {ns_name}: {len(paths)} paths "
                                 f"for {len(ids)} vectors")
            keep = [i for i, p in enumerate(paths) if p is not None]
            if len(keep) == len(paths):
                idx.bulk_insert(ids, paths)
            elif keep:
                idx.bulk_insert(ids[keep], [paths[i] for i in keep])

    def delete(self, entry_id: int) -> None:
        for idx in self.namespaces.values():
            if idx.catalog.get(entry_id) is not None:
                idx.delete(entry_id)
        # Store rows are append-only: deleted ids leave every scope AND get a
        # store-level tombstone.
        self.store.mark_deleted(entry_id)

    # ------------------------------------------------------------------ DSQ
    def _executor(self, executor: str) -> FlatExecutor:
        ex = self.executors.get(executor)
        if ex is None:
            raise ValueError(f"executor {executor!r} not built "
                             f"(have {sorted(self.executors)})")
        return ex

    def _request_knobs(self, precision: str, k: int,
                       rescore_k: Optional[int]
                       ) -> Tuple[str, Optional[int]]:
        """Request-level cost-model decisions, shared by :meth:`dsq` and
        :meth:`dsq_batch` so both paths decide identically."""
        if precision not in ("fp32", "int8", "pq"):
            raise ValueError(
                f"precision {precision!r} not in (fp32, int8, pq)")
        model = model_of(self.store)
        precision = model.pick_precision(
            precision, len(self.store), k, rescore_k,
            tiered=self.store.tiered_active(), dim=self.store.dim)
        return precision, model.pick_rescore_k(k, rescore_k, len(self.store))

    def dsq(self, queries: np.ndarray, path: str, k: int = 10,
            recursive: bool = True, exclude: Sequence[str] = (),
            namespace: str = DEFAULT_NS, executor: str = "flat",
            precision: str = "fp32", rescore_k: Optional[int] = None,
            **executor_params) -> DSQResult:
        """Directory-scoped query: resolve the scope, then rank inside it.
        Only ``precision="fp32"`` is ported; int8/pq raise
        ``NotImplementedError``."""
        precision, rescore_k = self._request_knobs(precision, k, rescore_k)
        idx = self.namespaces[namespace]
        stats = ResolveStats()
        t0 = time.perf_counter_ns()
        if exclude:
            scope = idx.resolve_exclusion(path, list(exclude),
                                          recursive=recursive, stats=stats)
        else:
            scope = idx.resolve(path, recursive=recursive, stats=stats)
        candidate_ids = scope.to_array()
        t1 = time.perf_counter_ns()
        ex = self._executor(executor)
        scores, ids = ex.search(queries, k, candidate_ids=candidate_ids,
                                precision=precision, rescore_k=rescore_k,
                                **executor_params)
        t2 = time.perf_counter_ns()
        return DSQResult(ids=ids, scores=scores, scope_size=len(candidate_ids),
                         directory_ns=t1 - t0, ann_ns=t2 - t1,
                         resolve_stats=stats)

    def planner(self, namespace: str = DEFAULT_NS) -> BatchPlanner:
        """Per-namespace batch planner (owns the epoch-validated mask cache,
        subscribed to the namespace's DSM delta stream so surviving masks
        are patched in place instead of evicted)."""
        if namespace not in self._planners:
            cache = ScopeMaskCache(device=self.device)
            self.namespace(namespace).subscribe_dsm(cache.apply_delta)
            self._planners[namespace] = BatchPlanner(
                cache=cache, model=model_of(self.store), device=self.device)
        return self._planners[namespace]

    def dsq_batch(self, queries: np.ndarray, paths: Sequence[str],
                  k: int = 10, recursive=True,
                  exclude: Optional[Sequence[Sequence[str]]] = None,
                  namespace: str = DEFAULT_NS, executor: str = "flat",
                  precision: str = "fp32",
                  rescore_k: Optional[int] = None,
                  **executor_params) -> List[DSQResult]:
        """Batched multi-scope DSQ: one request per row of ``queries`` with
        its own anchor (and optionally its own ``recursive`` flag and
        ``exclude`` list). Repeated scopes across the batch resolve once;
        scan-plan scopes share a single ``multi_scope_topk`` launch; each
        gather-plan scope is one ``scoped_topk`` launch over its candidate
        rows. Results are bit-identical to calling :meth:`dsq` per request,
        but the directory and kernel work is amortized (see
        ``DSQResult.batch``). Executor params the planner cannot plan (e.g. a
        forced ``plan="scan"``) take the per-request fallback loop."""
        precision, rescore_k = self._request_knobs(precision, k, rescore_k)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        if len(paths) != B:
            raise ValueError(f"{len(paths)} paths for {B} query rows")
        if namespace not in self.namespaces:
            raise KeyError(namespace)
        ex = self._executor(executor)
        if executor_params:
            return self._dsq_batch_fallback(queries, paths, k, recursive,
                                            exclude, namespace, executor,
                                            precision=precision,
                                            rescore_k=rescore_k,
                                            **executor_params)

        def launch_flat(groups, out_scores, out_ids, acct):
            self._launch_gather(ex, queries, k, groups, out_scores, out_ids,
                                acct, rescore_k)
            # ONE launch for every scan-plan request in the batch
            scan_groups = [g for g in groups if g.plan == "scan"]
            if scan_groups:
                words = torch.stack([g.words for g in scan_groups])
                rows, sids = self._scan_assembly(scan_groups)
                s, i = ex.search_multi(queries[rows], words, sids, k,
                                       precision=scan_groups[0].precision,
                                       rescore_k=rescore_k)
                out_scores[rows] = s
                out_ids[rows] = i
                acct.launches += 1

        return self._dsq_batch_planned(queries, paths, k, recursive, exclude,
                                       namespace, launch_flat,
                                       precision=precision,
                                       rescore_k=rescore_k)

    @staticmethod
    def _launch_gather(flat_ex, queries, k, groups, out_scores, out_ids,
                       acct, rescore_k=None) -> None:
        """One gather launch per selective group."""
        for g in groups:
            if g.plan != "gather":
                continue
            rows = np.asarray(g.request_idx)
            s, i = flat_ex.search(queries[rows], k,
                                  candidate_ids=g.candidate_ids,
                                  plan="gather", precision=g.precision,
                                  rescore_k=rescore_k)
            out_scores[rows] = s
            out_ids[rows] = i
            acct.launches += 1

    @staticmethod
    def _scan_assembly(scan_groups) -> Tuple[np.ndarray, np.ndarray]:
        """(request rows, per-request group ordinals) for one scan launch."""
        rows, sids = [], []
        for si, g in enumerate(scan_groups):
            rows.extend(g.request_idx)
            sids.extend([si] * len(g.request_idx))
        return np.asarray(rows), np.asarray(sids, np.int32)

    def _dsq_batch_planned(self, queries, paths, k, recursive, exclude,
                           namespace, launch, precision: str = "fp32",
                           rescore_k: Optional[int] = None
                           ) -> List[DSQResult]:
        """Shared batch path: normalize → plan (cache-first) → timed executor
        launches via ``launch(groups, out_scores, out_ids, acct)`` →
        per-request result assembly."""
        B = queries.shape[0]
        idx = self.namespaces[namespace]
        acct = BatchAccounting()
        t0 = time.perf_counter_ns()
        specs = normalize_batch(paths, recursive, exclude)
        groups = self.planner(namespace).plan(
            idx, len(self.store), specs, k, acct, precision=precision,
            rescore_k=rescore_k)
        t1 = time.perf_counter_ns()
        acct.directory_ns = t1 - t0
        model = model_of(self.store)
        acct.plan_source = model.source
        acct.predicted_ann_ns = model.estimate_batch_ns(
            [(g.plan, g.precision, g.scope_size, len(g.request_idx))
             for g in groups],
            n=len(self.store), k=k, rescore_k=rescore_k, dim=self.store.dim)
        out_scores = np.full((B, k), -np.inf, np.float32)
        out_ids = np.full((B, k), -1, np.int64)
        launch(groups, out_scores, out_ids, acct)
        acct.ann_ns = time.perf_counter_ns() - t1
        acct.rows_device_pinned, acct.rows_host = self.store.placement()

        plan_of = {}
        for g in groups:
            for i in g.request_idx:
                plan_of[i] = g
        dir_share = acct.directory_ns // max(B, 1)
        ann_share = acct.ann_ns // max(B, 1)
        results = []
        for i in range(B):
            g = plan_of[i]
            results.append(DSQResult(
                ids=out_ids[i:i + 1], scores=out_scores[i:i + 1],
                scope_size=g.scope_size, directory_ns=dir_share,
                ann_ns=ann_share, resolve_stats=acct.resolve_stats,
                plan=g.plan, scope_shared=len(g.request_idx), batch=acct))
        return results

    def _dsq_batch_fallback(self, queries, paths, k, recursive, exclude,
                            namespace, executor, precision="fp32",
                            rescore_k=None, **executor_params
                            ) -> List[DSQResult]:
        """Shared resolution, per-request executor calls: repeated scopes
        still resolve once (``resolve_batch`` + shared ``to_array``), then
        the executor runs per request with its params forwarded verbatim —
        exactly what :meth:`dsq` would pass it."""
        idx = self.namespaces[namespace]
        ex = self.executors[executor]
        acct = BatchAccounting()
        t0 = time.perf_counter_ns()
        specs = normalize_batch(paths, recursive, exclude)
        scopes = idx.resolve_batch(paths, recursive, exclude,
                                   stats=acct.resolve_stats)
        cand: Dict[int, np.ndarray] = {}      # id(bitmap) -> shared id array
        t1 = time.perf_counter_ns()
        out = []
        for i, scope in enumerate(scopes):
            ids_arr = cand.get(id(scope))
            if ids_arr is None:
                ids_arr = cand[id(scope)] = scope.to_array()
            scores, ids = ex.search(queries[i], k, candidate_ids=ids_arr,
                                    precision=precision, rescore_k=rescore_k,
                                    **executor_params)
            out.append(DSQResult(
                ids=ids, scores=scores, scope_size=len(ids_arr),
                directory_ns=(t1 - t0) // max(len(specs), 1), ann_ns=0,
                resolve_stats=acct.resolve_stats, batch=acct))
        t2 = time.perf_counter_ns()
        acct.batch_size = len(specs)
        acct.unique_scopes = len(cand)
        acct.directory_ns = t1 - t0
        acct.ann_ns = t2 - t1
        acct.launches = len(specs)
        ann_share = acct.ann_ns // max(len(specs), 1)
        for r in out:
            r.ann_ns = ann_share
        return out

    # ---------------------------------------------------------- maintenance
    def maintenance(self, namespace: str = DEFAULT_NS, policy=None):
        raise NotImplementedError(
            "online maintenance is not ported yet (ROADMAP queue 1 item 6)")

    # ------------------------------------------------------------------ DSM
    def move(self, src: str, new_parent: str, namespace: str = DEFAULT_NS,
             stats: Optional[DSMStats] = None) -> None:
        self._dsm[namespace].apply(DSM("move", src, new_parent), stats=stats)

    def merge(self, src: str, dst: str, namespace: str = DEFAULT_NS,
              stats: Optional[DSMStats] = None) -> None:
        self._dsm[namespace].apply(DSM("merge", src, dst), stats=stats)

    def mkdir(self, path: str, namespace: str = DEFAULT_NS) -> None:
        self._dsm[namespace].apply(DSM("mkdir", path))

    def rmdir(self, path: str, namespace: str = DEFAULT_NS,
              stats: Optional[DSMStats] = None) -> np.ndarray:
        """Recursively remove subtree ``path``: drop its directories and
        postings in ``namespace`` (journaled + region-locked), delete the
        removed entries from every other namespace, and tombstone their
        store rows. Returns the removed entry ids."""
        removed = self._dsm[namespace].apply(DSM("remove", path), stats=stats)
        ids = removed.to_array() if removed is not None else np.empty(0, np.uint32)
        self._purge_entries(ids, exclude_ns=namespace)
        return ids

    def _purge_entries(self, ids: np.ndarray, exclude_ns: str) -> None:
        for name, idx in self.namespaces.items():
            if name == exclude_ns:
                continue
            for eid in ids:
                if idx.catalog.get(int(eid)) is not None:
                    idx.delete(int(eid))
        self.store.mark_deleted(ids)

    def dsm_batch(self, ops: Sequence[DSM | Tuple[str, ...]],
                  namespace: str = DEFAULT_NS,
                  stats: Optional[DSMStats] = None,
                  max_workers: int = 4) -> DSMBatchResult:
        """Group-committed batched maintenance: one journal BEGIN append for
        the whole batch, FIFO region-lock scheduling (disjoint subtrees
        apply concurrently, overlapping ones serialize in submission order),
        one shared COMMIT record. Ops may be :class:`DSM` instances or
        ``(kind, src[, dst])`` tuples. Ops the index rejects surface in
        ``result.errors``; REMOVE ops also purge their entries from the
        other namespaces and tombstone the store rows, like :meth:`rmdir`."""
        norm = [op if isinstance(op, DSM) else DSM(*op) for op in ops]
        result = self._dsm[namespace].apply_many(norm, stats=stats,
                                                 max_workers=max_workers)
        for op, removed in zip(norm, result.results):
            if op.kind == "remove" and removed is not None:
                self._purge_entries(removed.to_array(), exclude_ns=namespace)
        return result

    def recover(self, namespace: Optional[str] = None
                ) -> Dict[str, List[DSM]]:
        """Replay uncommitted journal ops (crash suspects) for one or every
        namespace. Call after restoring index state on restart; replay is
        idempotent and ends with a ``check_invariants`` pass. A replayed
        REMOVE finishes its :meth:`rmdir` contract. Returns the ops that
        actually replayed, per namespace."""
        names = [namespace] if namespace is not None else list(self._dsm)
        out: Dict[str, List[DSM]] = {}
        for name in names:
            replayed_ops = []
            for op, replayed, result in self._dsm[name].recover():
                if not replayed:
                    continue
                replayed_ops.append(op)
                if op.kind == "remove" and result is not None:
                    self._purge_entries(result.to_array(), exclude_ns=name)
            out[name] = replayed_ops
        return out

    # ------------------------------------------------------------ inspection
    def stats(self) -> Dict[str, object]:
        return {
            "entries": len(self.store),
            "dim": self.store.dim,
            "metric": self.store.metric,
            "scope_strategy": self.scope_strategy,
            "device": str(self.device),
            "namespaces": {
                name: {"dirs": len(idx.list_dirs()),
                       "dir_bytes": idx.memory_bytes()}
                for name, idx in self.namespaces.items()},
            "executors": sorted(self.executors),
            "vector_bytes": self.store.nbytes(),
        }

    def check_invariants(self) -> None:
        for idx in self.namespaces.values():
            idx.check_invariants()
