"""DirectoryVectorDB — the paper's system: scope index × ANN executor, on one
torch device.

Composes (1) one or more *namespaces* (independent directory hierarchies,
e.g. ARXIV-Dir's subject + temporal trees), each backed by a pluggable
ScopeIndex strategy, with (2) a vector store mirrored on the database's
device and the flat, IVF and proximity-graph executors at fp32, int8 or PQ
precision, with tiered storage past a device byte budget. DSQ runs scope
resolution first, then ranks inside the resolved candidate set; DSM goes
through the journaled, region-locked executor (§IV-A consistency ordering),
and its delta events patch the planner's device-resident scope masks.
Online maintenance (:meth:`DirectoryVectorDB.maintenance`) compacts the
store, repairs the graph and repartitions IVF under the same journal.

The sharded executor (``build_ann("sharded")``) splits the store's rows
over a shard mesh (one card or several) and ranks each batch's scan groups
with one launch per shard and a shard merge; its resident scope table
follows the same DSM deltas and compaction remaps.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..core import (DSM, DSMBatchResult, DSMExecutor, DSMJournal, DSMStats,
                    ResolveStats, ScopeIndex, make_scope_index)
from ..core.interface import normalize_batch
from ..device import resolve_device
from .costmodel import install_kernel_tuning, model_of, resolve_calibration
from .flat import PRECISIONS, FlatExecutor
from .graph import PGIndex
from .ivf import IVFIndex
from .planner import BatchAccounting, BatchPlanner, ScopeMaskCache
from .quant import resolve_rescore_k
from .sharded import ShardedExecutor
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
    plan: str = ""    # "gather" | "scan" | "ivf" | "pg" | "sharded" | "empty"
    scope_shared: int = 1            # requests sharing this scope in the batch
    batch: Optional[BatchAccounting] = None   # shared-resolution accounting

    @property
    def total_ns(self) -> int:
        return self.directory_ns + self.ann_ns


class DirectoryVectorDB:
    def __init__(self, dim: int, metric: str = "ip",
                 scope_strategy: str = "triehi",
                 journal_path: Optional[str] = None,
                 pq_m: Optional[int] = None, calibration=None,
                 device=None):
        """``device`` holds the store's mirror, the scope masks and every
        kernel launch; ``None`` means ``"cuda"``, and without a card only
        ``device="cpu"`` runs (the plain PyTorch path).

        ``journal_path`` makes every namespace's DSM executor journal to
        ``{journal_path}.{namespace}``. Reopening an existing journal
        continues its sequence numbers from the persisted tail; after the
        caller restores index state on restart, :meth:`recover` replays any
        op whose COMMIT was lost to a crash. ``pq_m`` overrides the PQ
        subspace count (default: the largest divisor of ``dim`` at or below
        ``dim // 4``).

        ``calibration`` attaches the measured cost model that replaces the
        hand-set planner/executor constants: a calibration-artifact path,
        parsed artifact dict, or :class:`~repro_torch.vectordb.costmodel
        .CostModel`. ``None`` reads the ``REPRO_CALIBRATION`` env var,
        falling back to the heuristic model; ``False`` pins the heuristic
        model explicitly. An artifact calibrated on another backend than
        this device's degrades to the roofline model."""
        self.device = resolve_device(device)
        self.store = VectorStore(dim, metric, device=self.device, pq_m=pq_m)
        self.store.cost_model = resolve_calibration(calibration, self.device)
        if self.store.cost_model.source == "measured":
            install_kernel_tuning(self.store.cost_model)
        self.scope_strategy = scope_strategy
        self.namespaces: Dict[str, ScopeIndex] = {}
        self.executors: Dict[str, object] = {}
        self._dsm: Dict[str, DSMExecutor] = {}
        self._planners: Dict[str, BatchPlanner] = {}
        self._journal_path = journal_path
        self._sharded_subs: Dict[str, object] = {}   # ns -> delta listener
        # ns -> {scope key -> last resolved candidate ids}: the candidate
        # pool the tiered hot-pin ranking draws from, so scopes absent from
        # the current batch keep competing for the pin budget
        self._hot_scope_ids: Dict[str, Dict[object, np.ndarray]] = {}
        self.namespace(DEFAULT_NS)  # default filesystem namespace

    # -------------------------------------------------------------- plumbing
    def namespace(self, name: str) -> ScopeIndex:
        if name not in self.namespaces:
            idx = make_scope_index(self.scope_strategy)
            self.namespaces[name] = idx
            journal = DSMJournal(
                f"{self._journal_path}.{name}" if self._journal_path else None)
            self._dsm[name] = DSMExecutor(idx, journal)
            ex = self.executors.get("sharded")
            if ex is not None:
                self._sharded_subs[name] = functools.partial(
                    ex.apply_delta, namespace=name)
                idx.subscribe_dsm(self._sharded_subs[name])
        return self.namespaces[name]

    def build_ann(self, kind: str, **params) -> None:
        if kind == "flat":
            self.executors["flat"] = FlatExecutor(self.store)
        elif kind == "ivf":
            self.executors["ivf"] = IVFIndex(self.store, **params)
        elif kind == "pg":
            self.executors["pg"] = PGIndex(self.store, **params)
        elif kind == "sharded":
            # the sharded serving tier: subscribed to every namespace's DSM
            # delta stream so its resident scope slots patch in place. A
            # rebuild drops the old executor's subscriptions first; they
            # would otherwise keep its shards and table alive. Without a
            # ``mesh`` a CPU database shards on the CPU and a CUDA one over
            # the visible cards (``n_shards`` round-robin over them).
            for name, fn in self._sharded_subs.items():
                self.namespaces[name].unsubscribe_dsm(fn)
            self._sharded_subs.clear()
            ex = ShardedExecutor(self.store, **params)
            self.executors["sharded"] = ex
            for name, idx in self.namespaces.items():
                self._sharded_subs[name] = functools.partial(
                    ex.apply_delta, namespace=name)
                idx.subscribe_dsm(self._sharded_subs[name])
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
        ivf = self.executors.get("ivf")
        if ivf is not None:
            ivf.add(ids)
        pg = self.executors.get("pg")
        if pg is not None:
            pg.add(ids)
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
        # store-level tombstone, so unscoped IVF probes (whose partition
        # lists still reference the row) mask them out too.
        self.store.mark_deleted(entry_id)

    # ------------------------------------------------------------------ DSQ
    def _executor(self, executor: str):
        ex = self.executors.get(executor)
        if ex is None:
            raise ValueError(f"executor {executor!r} not built "
                             f"(have {sorted(self.executors)})")
        return ex

    def _request_knobs(self, precision: str, k: int,
                       rescore_k: Optional[int]
                       ) -> Tuple[str, Optional[int]]:
        """Request-level decisions, shared by :meth:`dsq` and
        :meth:`dsq_batch` so both paths decide identically: a store over its
        device byte budget serves fp32 requests with the PQ plan (its fp32
        rows live in host RAM), then the cost model may retune the
        precision and the rescore window."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        if precision == "fp32" and self.store.tiered_active():
            precision = "pq"
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
        ``precision="int8"`` / ``"pq"`` run the executor's two-phase plan
        (the int8 or PQ/ADC scan keeps ``rescore_k >= k`` candidates, an
        exact fp32 rescore ranks the final top-k). Past a device byte budget
        (``store.set_device_budget``) fp32 requests take the PQ plan."""
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
        on the flat executor scan-plan scopes share a single
        ``multi_scope_topk`` launch and the fp32 gather-plan scopes a single
        launch of kernel 9's list form over their candidate ids (each
        gather scope of a tiered store, and each int8 / PQ one, is its own
        launch); on the IVF executor
        every request sharing an ``nprobe`` and a precision rides one
        ``ivf_probe_topk*`` launch (``nprobe`` may be one value or one per
        request). Results are bit-identical to calling :meth:`dsq` per
        request, but the directory and kernel work is amortized (see
        ``DSQResult.batch``). On the PG executor each unique scope's dense
        bool mask is built once and shared by its requests' beams (one
        ``search_batch`` per scope, ``ef_search`` planned); there a request
        equals :meth:`dsq` at its group's planned precision (a gather scope
        the rescore window covers runs exact fp32, as in the reference).
        Executor params
        the planner cannot plan (e.g. a forced ``plan="scan"``) take the
        per-request fallback loop.

        With ``precision="int8"`` / ``"pq"`` the planner picks the precision
        per scope group (scan groups quantize; gather groups only when they
        outsize the rescore window), each precision's scan groups share one
        launch plus one exact fp32 rescore, and ``DSQResult.batch`` reports
        the store bytes of each tier and the rescored candidates. Over the
        device byte budget fp32 batches take the PQ plan, and the batch
        also reports the rescore's host->device fetch bytes and the
        pinned vs host row placement; hot scopes' rows are pinned after
        each tiered batch."""
        precision, rescore_k = self._request_knobs(precision, k, rescore_k)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        if len(paths) != B:
            raise ValueError(f"{len(paths)} paths for {B} query rows")
        if namespace not in self.namespaces:
            raise KeyError(namespace)
        ex = self._executor(executor)
        if isinstance(ex, IVFIndex) and set(executor_params) <= {"nprobe"}:
            nprobe = executor_params.get("nprobe")
            if nprobe is None:
                nprobe = model_of(self.store).default_nprobe(ex.n_lists)
            return self._dsq_batch_ivf(ex, queries, paths, k, recursive,
                                       exclude, namespace, nprobe, precision,
                                       rescore_k)
        if isinstance(ex, PGIndex) and set(executor_params) <= {"ef_search"}:
            return self._dsq_batch_pg(ex, queries, paths, k, recursive,
                                      exclude, namespace,
                                      executor_params.get("ef_search", 64),
                                      precision, rescore_k)
        if isinstance(ex, ShardedExecutor) and not executor_params:
            return self._dsq_batch_sharded(ex, queries, paths, k, recursive,
                                           exclude, namespace, precision,
                                           rescore_k)
        if not isinstance(ex, FlatExecutor) or executor_params:
            return self._dsq_batch_fallback(queries, paths, k, recursive,
                                            exclude, namespace, executor,
                                            precision=precision,
                                            rescore_k=rescore_k,
                                            **executor_params)

        def launch_flat(groups, out_scores, out_ids, acct):
            # the batch's own dispatch between executor calls counts as
            # rank.run host time (no span: db.rank names it)
            with trace.Tiles(trace.RUN, spans=False):
                self._launch_gather(ex, queries, k, groups, out_scores,
                                    out_ids, acct, rescore_k)
                # ONE launch per precision for every scan-plan request in
                # the batch (a single-precision batch stays one launch)
                for prec in PRECISIONS:
                    scan_groups = [g for g in groups if g.plan == "scan"
                                   and g.precision == prec]
                    if not scan_groups:
                        continue
                    words = torch.stack([g.words for g in scan_groups])
                    rows, sids = self._scan_assembly(scan_groups)
                    s, i = ex.search_multi(queries[rows], words, sids, k,
                                           precision=prec,
                                           rescore_k=rescore_k)
                    out_scores[rows] = s
                    out_ids[rows] = i
                    acct.launches += 1
                    if prec != "fp32":
                        acct.rescore_candidates += (
                            len(rows) * resolve_rescore_k(
                                k, rescore_k, len(self.store)))

        return self._dsq_batch_planned(queries, paths, k, recursive, exclude,
                                       namespace, launch_flat,
                                       precision=precision,
                                       rescore_k=rescore_k)

    @staticmethod
    def _launch_gather(flat_ex, queries, k, groups, out_scores, out_ids,
                       acct, rescore_k=None) -> None:
        """The batch's selective groups. While every fp32 row is on the
        device (the store not tiered), the fp32 groups rank in one executor
        call, ``search_multi`` over their candidate lists: one launch of
        kernel 9's list form, one upload and one pair of copies back. Every
        other gather group, int8 / PQ (a scope that outsizes the rescore
        window) or of a tiered store, is one gather launch at the group's
        planned precision (``gather_alone`` counts them)."""
        resident = not flat_ex.store.tiered_active()
        listed, alone = [], []
        for g in groups:
            if g.plan == "gather":
                (listed if resident and g.precision == "fp32"
                 else alone).append(g)
        if listed:
            rows, sids = DirectoryVectorDB._scan_assembly(listed)
            s, i = flat_ex.search_multi(
                queries[rows], None, sids, k,
                candidate_lists=[g.candidate_ids for g in listed])
            out_scores[rows] = s
            out_ids[rows] = i
            acct.launches += 1
            acct.gather_listed += len(listed)
        acct.gather_alone += len(alone)
        for g in alone:
            rows = np.asarray(g.request_idx)
            s, i = flat_ex.search(queries[rows], k,
                                  candidate_ids=g.candidate_ids,
                                  plan="gather", precision=g.precision,
                                  rescore_k=rescore_k)
            out_scores[rows] = s
            out_ids[rows] = i
            acct.launches += 1
            if g.precision != "fp32":
                acct.rescore_candidates += len(rows) * resolve_rescore_k(
                    k, rescore_k, g.scope_size)

    @staticmethod
    def _scan_assembly(scan_groups) -> Tuple[np.ndarray, np.ndarray]:
        """(request rows, per-request group ordinals) for one launch over
        several groups (scan groups, or fp32 gather groups)."""
        rows, sids = [], []
        for si, g in enumerate(scan_groups):
            rows.extend(g.request_idx)
            sids.extend([si] * len(g.request_idx))
        return np.asarray(rows), np.asarray(sids, np.int32)

    def _dsq_batch_sharded(self, ex: ShardedExecutor, queries, paths, k,
                           recursive, exclude, namespace, precision="fp32",
                           rescore_k=None) -> List[DSQResult]:
        """Batched DSQ on the sharded tier: unique scopes resolve once
        (cache-first); scan-plan groups pin their packed words into the
        executor's resident scope table (token-validated: repeated and
        DSM-patched scopes never re-upload) and ride one launch per shard
        per precision; selective gather-plan groups stay on the flat
        executor's gather launch. Bitwise equal to ``executor="flat"``.
        When the per-shard depth does not fit the shards' rows
        (``scan_on_mesh``), the scan groups run on the flat twin."""

        def launch_sharded(groups, out_scores, out_ids, acct):
            db0 = (ex.view.db_bytes_uploaded + ex.view.q_bytes_uploaded
                   + ex.view.pq_bytes_uploaded)
            m0 = ex.mask_bytes_uploaded
            self._launch_gather(ex.flat, queries, k, groups, out_scores,
                                out_ids, acct, rescore_k)
            scan_all = [g for g in groups if g.plan == "scan"]
            if scan_all:
                # only the shard path reads the mirrors: a gather-only
                # batch never pays the store upload
                ex.sync()
            for prec in PRECISIONS:
                scan_groups = [g for g in scan_all if g.precision == prec]
                if not scan_groups:
                    continue
                if ex.scan_on_mesh(k, prec, rescore_k):
                    rows, sids = [], []
                    with ex.pinned():
                        ex.reserve(len(scan_all))
                        for g in scan_groups:
                            slot, hit = ex.ensure_scope(namespace, g.key,
                                                        g.entry)
                            acct.shard_mask_hits += int(hit)
                            rows.extend(g.request_idx)
                            sids.extend([slot] * len(g.request_idx))
                        rows = np.asarray(rows)
                        s, i = ex.search_slots(queries[rows],
                                               np.asarray(sids, np.int32), k,
                                               precision=prec,
                                               rescore_k=rescore_k)
                    # the merge moves k (fp32) or rescore_k (int8 / PQ)
                    # (score, id) pairs a request from every shard
                    depth = ex.phase_depth(k, prec, rescore_k)
                    acct.collective_bytes += (ex.n_shards * len(rows)
                                              * depth * 8)
                else:
                    # too few rows a shard for the depth: the flat twin
                    # runs the same kernels over the whole store
                    words = torch.stack([g.words for g in scan_groups])
                    rows, sids = self._scan_assembly(scan_groups)
                    s, i = ex.flat.search_multi(queries[rows], words, sids,
                                                k, precision=prec,
                                                rescore_k=rescore_k)
                out_scores[rows] = s
                out_ids[rows] = i
                acct.launches += 1
                if prec != "fp32":
                    acct.rescore_candidates += len(rows) * resolve_rescore_k(
                        k, rescore_k, len(self.store))
            acct.n_shards = ex.n_shards
            acct.shard_db_bytes += (ex.view.db_bytes_uploaded
                                    + ex.view.q_bytes_uploaded
                                    + ex.view.pq_bytes_uploaded - db0)
            acct.shard_mask_bytes += ex.mask_bytes_uploaded - m0

        return self._dsq_batch_planned(queries, paths, k, recursive, exclude,
                                       namespace, launch_sharded,
                                       label="sharded", precision=precision,
                                       rescore_k=rescore_k)

    def _dsq_batch_ivf(self, ex: IVFIndex, queries, paths, k, recursive,
                       exclude, namespace, nprobe, precision="fp32",
                       rescore_k=None) -> List[DSQResult]:
        """Batched IVF DSQ: unique scopes resolve once through the
        epoch-validated mask cache, their packed words stack into one mask
        matrix, and all requests sharing an ``nprobe`` and a precision ride
        ONE probe -> ``ivf_probe_topk*`` launch (one launch per distinct
        per-request ``nprobe`` when a sequence is passed)."""
        B = queries.shape[0]
        # clamp to the effective range up front so values the executor
        # would clamp anyway don't split into extra launches
        def clamp(v):
            return max(1, min(int(v), ex.n_lists))
        if np.ndim(nprobe) == 0:
            npr = [clamp(nprobe)] * B
        else:
            npr = [clamp(x) for x in nprobe]
            if len(npr) != B:
                raise ValueError(f"{len(npr)} nprobe values for {B} requests")

        def launch_ivf(groups, out_scores, out_ids, acct):
            live = [g for g in groups if g.plan != "empty"]
            if not live:
                return
            words = torch.stack([g.words for g in live])
            req = [(i, si, g.precision) for si, g in enumerate(live)
                   for i in g.request_idx]
            for val in sorted({npr[i] for i, _, _ in req}):
                for prec in PRECISIONS:
                    sel = [(i, si) for i, si, p in req
                           if npr[i] == val and p == prec]
                    if not sel:
                        continue
                    rows = np.asarray([i for i, _ in sel])
                    sids = np.asarray([si for _, si in sel], np.int32)
                    s, i = ex.search_multi(queries[rows], words, sids, k,
                                           nprobe=val, precision=prec,
                                           rescore_k=rescore_k)
                    out_scores[rows] = s
                    out_ids[rows] = i
                    acct.launches += 1
                    if prec != "fp32":
                        # the approximate phase is capped at the probed
                        # window
                        window = val * ex.layout().max_aligned
                        acct.rescore_candidates += len(rows) * min(
                            resolve_rescore_k(k, rescore_k, len(self.store)),
                            window)

        return self._dsq_batch_planned(queries, paths, k, recursive, exclude,
                                       namespace, launch_ivf, label="ivf",
                                       precision=precision,
                                       rescore_k=rescore_k)

    def _dsq_batch_pg(self, ex: PGIndex, queries, paths, k, recursive,
                      exclude, namespace, ef_search, precision="fp32",
                      rescore_k=None) -> List[DSQResult]:
        """Batched PG DSQ: unique scopes resolve once (cache-first), each
        group's dense bool mask is built once and shared by every request in
        the group — one ``search_batch`` call per unique scope."""

        def launch_pg(groups, out_scores, out_ids, acct):
            alive = self.store.alive_bool()
            for g in groups:
                if g.plan == "empty":
                    continue
                valid = g.bool_mask
                if alive is not None:
                    valid = valid & alive
                rows = np.asarray(g.request_idx)
                s, i = ex.search_batch(queries[rows], k, valid_mask=valid,
                                       ef_search=ef_search,
                                       precision=g.precision,
                                       rescore_k=rescore_k)
                out_scores[rows] = s
                out_ids[rows] = i
                acct.launches += 1
                if g.precision != "fp32":
                    # the quantized beam collects max(ef, window) per query
                    acct.rescore_candidates += len(rows) * max(
                        ef_search,
                        resolve_rescore_k(k, rescore_k, len(self.store)))

        return self._dsq_batch_planned(queries, paths, k, recursive, exclude,
                                       namespace, launch_pg, label="pg",
                                       precision=precision,
                                       rescore_k=rescore_k)

    def _dsq_batch_planned(self, queries, paths, k, recursive, exclude,
                           namespace, launch, label: Optional[str] = None,
                           precision: str = "fp32",
                           rescore_k: Optional[int] = None
                           ) -> List[DSQResult]:
        """Shared batch path: normalize → plan (cache-first) → timed executor
        launches via ``launch(groups, out_scores, out_ids, acct)`` →
        per-request result assembly. ``label`` names the plan of every
        non-empty request (``"ivf"``); ``None`` keeps each group's gather /
        scan plan."""
        B = queries.shape[0]
        idx = self.namespaces[namespace]
        acct = BatchAccounting()
        with trace.span("db.plan"):
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
                n=len(self.store), k=k, rescore_k=rescore_k,
                dim=self.store.dim)
            out_scores = np.full((B, k), -np.inf, np.float32)
            out_ids = np.full((B, k), -1, np.int64)
            store = self.store
            fetch0 = store.rescore_fetch_bytes
            retries0 = store.host_fetch_retries
        with trace.span("db.rank"), trace.counting(acct):
            launch(groups, out_scores, out_ids, acct)
            acct.ann_ns = time.perf_counter_ns() - t1
        with trace.span("db.finish"):
            # resident-store byte terms are *alive-row* bytes: tombstoned
            # rows still occupy buffer slots but are not part of the serving
            # corpus
            if any(g.precision == "int8" for g in groups):
                acct.db_bytes_fp32 = store.alive_nbytes()
                acct.db_bytes_int8 = store.q_alive_nbytes()
            if any(g.precision == "pq" for g in groups):
                acct.db_bytes_fp32 = store.alive_nbytes()
                acct.db_bytes_pq = store.pq_nbytes()
            acct.rescore_fetch_bytes = store.rescore_fetch_bytes - fetch0
            acct.host_fetch_retries = store.host_fetch_retries - retries0
            acct.tiered = store.tiered_active()
            if acct.tiered:
                self._update_hot_pins(namespace, groups)
            acct.rows_device_pinned, acct.rows_host = store.placement()

            plan_of = {}
            for g in groups:
                for i in g.request_idx:
                    plan_of[i] = g
            dir_share = acct.directory_ns // max(B, 1)
            ann_share = acct.ann_ns // max(B, 1)
            results = []
            for i in range(B):
                g = plan_of[i]
                plan = (g.plan if label is None or g.plan == "empty"
                        else label)
                results.append(DSQResult(
                    ids=out_ids[i:i + 1], scores=out_scores[i:i + 1],
                    scope_size=g.scope_size, directory_ns=dir_share,
                    ann_ns=ann_share, resolve_stats=acct.resolve_stats,
                    plan=plan, scope_shared=len(g.request_idx), batch=acct))
            return results

    def _update_hot_pins(self, namespace: str, groups) -> None:
        """Scope-aware tiered placement: pin the hottest directories' fp32
        rows. Heat is the planner's cumulative per-scope DSQ request count;
        the pin budget is whatever device capacity the PQ codes leave free.
        The ranking runs over every scope seen so far (the per-namespace
        pool), so a cold batch never unpins rows hotter scopes claimed
        earlier. Pins are accounting only, as in the reference."""
        store = self.store
        budget_rows = (store.device_budget - store.pq_nbytes()
                       - store.pq_codebook_nbytes()) // (store.dim * 4)
        if budget_rows <= 0:
            store.pin_rows(np.empty(0, np.int64))
            return
        hot = self._hot_scope_ids.setdefault(namespace, {})
        for g in groups:
            if g.plan != "empty":
                hot[g.key] = np.asarray(g.candidate_ids, np.int64)
        heat = self.planner(namespace).scope_access
        ranked = sorted(hot.items(), key=lambda kv: heat.get(kv[0], 0),
                        reverse=True)
        pinned: List[np.ndarray] = []
        total = 0
        for _, ids in ranked:
            room = budget_rows - total
            if room <= 0:
                break
            if len(ids) > room:
                ids = ids[:room]     # partial pin of the coldest scope
            pinned.append(ids)
            total += len(ids)
        store.pin_rows(np.unique(np.concatenate(pinned))
                       if pinned else np.empty(0, np.int64))

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
    def maintenance(self, namespace: str = DEFAULT_NS,
                    policy=None) -> "MaintenanceManager":
        """Per-namespace-journal :class:`~repro_torch.vectordb.maintenance
        .MaintenanceManager` (created on first access, and anew when another
        ``policy`` object is passed). Constructing it also wires its
        :meth:`replay` hook into the namespace's DSM executor, so call this
        *before* :meth:`recover` on restart — otherwise crashed ``maint_*``
        suspects are dropped (harmless: the next due check re-triggers them)
        instead of rolled forward."""
        if not hasattr(self, "_maintenance"):
            self._maintenance: Dict[str, object] = {}
        mgr = self._maintenance.get(namespace)
        if mgr is None or (policy is not None and mgr.policy is not policy):
            from .maintenance import MaintenanceManager
            self.namespace(namespace)
            mgr = MaintenanceManager(self, namespace=namespace, policy=policy)
            self._maintenance[namespace] = mgr
            self._dsm[namespace].maintenance_replay = mgr.replay
        return mgr

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
