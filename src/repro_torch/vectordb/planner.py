"""Batch DSQ query planner: scope dedup, epoch-validated packed-mask cache,
gather-vs-scan plan selection.

A request batch arrives as N ``(query, scope)`` pairs. The planner

  1. canonicalizes scopes and groups identical ones (repeated scopes across
     concurrent users are the common case in serving),
  2. serves each unique scope from the :class:`ScopeMaskCache` when its
     scope-epoch tokens still validate (TrieHI: per-node epochs, so DSM in an
     unrelated subtree does not evict), resolving only the misses in one
     ``resolve_batch`` call,
  3. picks the execution plan per unique scope by selectivity — ``gather``
     (score only the |C| candidate rows) below :data:`flat.GATHER_THRESHOLD`,
     ``scan`` (masked full sweep, the ``multi_scope_topk`` kernel) above
     it — exactly the pre- vs post-filter decision the VDBMS surveys
     identify as the operator-level problem for attribute-filtered search.

Every scan-plan scope in the batch shares ONE ranking launch (scope-id
indirection into a packed (n_scopes, n_words) mask matrix); each gather-plan
scope is one launch over its candidate rows.

The packed words of a cached scope live on the database's device (int32
views of the uint32 bits), so the scope table stays resident there and a
DSM delta patches it in place with the ``bitmap_patch`` kernel.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import ResolveStats, RoaringBitmap, ScopeIndex
from ..core import paths as P
from ..core.interface import DSMDelta, ScopeSpec
from ..device import resolve_device
from ..kernels import ops as kops
from .costmodel import CostModel
from .flat import GATHER_THRESHOLD, choose_plan
from .quant import resolve_rescore_k


@dataclass(frozen=True)
class ScopeKey:
    """Canonical identity of a resolved scope inside a batch."""
    path: P.Path
    recursive: bool
    exclude: Tuple[P.Path, ...]

    @classmethod
    def from_spec(cls, spec: ScopeSpec) -> "ScopeKey":
        return cls(*spec)


@dataclass
class CachedScope:
    """A resolved scope pinned with its validity evidence: the scope-epoch
    tokens of the anchor and every exclusion branch, plus the store size the
    packed words were built for (ingest growth changes the word count).

    The roaring bitmap is the compact resident form; the id array (gather
    plan), the packed device words (scan-plan flat and batched IVF launches)
    and the host dense bool mask (PG traversal) are materialized on first
    use — each executor reads exactly one form, so the others never cost
    memory."""
    tokens: Tuple
    n: int
    scope_size: int
    scope: RoaringBitmap
    device: torch.device
    _ids: Optional[np.ndarray] = None
    _words: Optional[torch.Tensor] = None
    _bool: Optional[np.ndarray] = None

    @property
    def candidate_ids(self) -> np.ndarray:   # sorted uint32 member ids
        if self._ids is None:
            self._ids = self.scope.to_array()
        return self._ids

    @property
    def words(self) -> torch.Tensor:         # packed, ceil(n/32), on device
        # uploaded on the caller's current stream: the scheduler stages
        # words on its collector thread and reads them on its executing
        # thread, both on the legacy default stream, which orders the
        # upload before every later kernel (serving/scheduler.py)
        if self._words is None:
            self._words = kops.as_words(
                self.scope.to_words(max(self.n, 1))).to(self.device)
        return self._words

    @property
    def bool_mask(self) -> np.ndarray:       # dense (n,) bool, host
        if self._bool is None:
            self._bool = self.scope.to_bool_mask(self.n)
        return self._bool


class ScopeMaskCache:
    """Epoch-validated cache of resolved scopes and their packed device masks.

    Correctness contract: an entry is served only while every constituent
    ``scope_token`` compares equal to the one captured at resolve time and
    the store size is unchanged. Any DSM (move/merge/remove) or write that
    touches a constituent scope bumps its epoch and the entry silently
    misses.

    Delta maintenance: subscribed to a TrieHI index (:meth:`apply_delta` as
    a ``DSMDelta`` listener), the cache *patches* surviving entries instead
    of letting the whole ancestor chain evict. A MOVE of aggregate S bumps
    every node on the vacated and gaining chains — under token validation
    alone, one small move kills the cached mask of every enclosing scope
    (including the always-hot root). The delta event names exactly those
    nodes with their new epochs, so each simple cached scope on the chain is
    patched word-wise (OR the gaining chain, AND-NOT the vacated chain — the
    batched ``bitmap_patch`` kernel, on the device) and its token
    advanced to the patched state; correctness stays epoch-validated.
    Entries whose change is not exactly S (exclusion composites,
    non-recursive scopes, merge-conflict children) are evicted instead."""

    def __init__(self, max_entries: int = 4096, device=None):
        self.max_entries = max_entries
        self.device = resolve_device(device)
        self._entries: Dict[ScopeKey, CachedScope] = {}
        self._lock = threading.Lock()    # serving thread vs DSM delta threads
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.patched = 0
        self.delta_evictions = 0

    @staticmethod
    def _tokens(index: ScopeIndex, key: ScopeKey) -> Optional[Tuple]:
        toks = [index.scope_token(key.path, key.recursive)]
        toks += [index.scope_token(b, True) for b in key.exclude]
        if any(t is None for t in toks):
            return None              # uncacheable (e.g. missing directory)
        return tuple(toks)

    def lookup(self, index: ScopeIndex, key: ScopeKey,
               n: int) -> Optional[CachedScope]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if ent.n != n or self._tokens(index, key) != ent.tokens:
                del self._entries[key]
                self.invalidations += 1
                self.misses += 1
                return None
            self.hits += 1
            self._entries[key] = self._entries.pop(key)  # LRU refresh
            return ent

    def store(self, index: ScopeIndex, key: ScopeKey, n: int,
              scope: RoaringBitmap,
              tokens: Optional[Tuple] = None) -> CachedScope:
        """Cache a freshly-resolved scope. ``tokens`` should be the token
        snapshot captured *before* the resolution ran (the planner does
        this); the entry is admitted only while the tokens still compare
        equal at store time, so a DSM landing anywhere in the
        capture→resolve→store window can never pin post-DSM tokens onto a
        pre-DSM bitmap (the result is still returned, just not cached)."""
        if tokens is None:
            tokens = self._tokens(index, key)
        ent = CachedScope(tokens=tokens or (), n=n,
                          scope_size=len(scope), scope=scope,
                          device=self.device)
        if ent.tokens and self._tokens(index, key) == ent.tokens:
            with self._lock:
                if len(self._entries) >= self.max_entries:
                    self._entries.pop(next(iter(self._entries)))
                self._entries[key] = ent
        return ent

    # ------------------------------------------------------- delta patching
    def apply_delta(self, event: DSMDelta) -> Dict[str, int]:
        """DSMDelta listener: patch every simple cached scope anchored on an
        affected chain node in place of evicting it. Patched entries are
        *replaced* (copy-on-patch), so a concurrent reader that already
        holds the old entry keeps a self-consistent snapshot. A patch is
        taken only when the stored epoch equals the event's pre-op epoch:
        an entry already stale for any other reason (an un-evented bump,
        e.g. a point delete, or a concurrent op's event not yet applied)
        must evict — re-stamping it would resurrect a stale mask as valid."""
        removed = {id(n): (old, new) for n, old, new in event.removed_from}
        added = {id(n): (old, new) for n, old, new in event.added_to}
        if not removed and not added:
            return {"patched": 0, "evicted": 0}
        with self._lock:
            patch: List[Tuple[ScopeKey, CachedScope, int, int]] = []
            evict: List[ScopeKey] = []
            for key, ent in self._entries.items():
                hit = [t for t in ent.tokens
                       if (id(t[0]) in removed or id(t[0]) in added)]
                if not hit:
                    continue         # off-chain entry: survives untouched
                if len(ent.tokens) == 1 and not key.exclude and key.recursive:
                    node, cur_epoch = ent.tokens[0]
                    sign = 1 if id(node) in added else -1
                    old_e, new_e = (added[id(node)] if sign > 0
                                    else removed[id(node)])
                    if cur_epoch == old_e:
                        patch.append((key, ent, sign, new_e))
                    else:
                        evict.append(key)
                else:
                    # the delta composes non-trivially (exclusion branches,
                    # Local-level scopes): fall back to eviction
                    evict.append(key)
            for key in evict:
                del self._entries[key]
                self.invalidations += 1
            groups: Dict[int,
                         List[Tuple[CachedScope, torch.Tensor, int]]] = {}
            for key, ent, sign, epoch in patch:
                scope = (ent.scope | event.delta if sign > 0
                         else ent.scope - event.delta)
                repl = CachedScope(tokens=((ent.tokens[0][0], epoch),),
                                   n=ent.n, scope_size=len(scope), scope=scope,
                                   device=self.device)
                if ent._words is not None:
                    groups.setdefault(ent._words.shape[0], []).append(
                        (repl, ent._words, sign))
                self._entries[key] = repl
            # one batched word-wise patch launch per distinct word length
            for n_words, rows in groups.items():
                masks = torch.stack([w for _, w, _ in rows])
                signs = torch.tensor([s for _, _, s in rows],
                                     dtype=torch.int32, device=self.device)
                delta_words = kops.as_words(
                    event.delta.to_words(n_words * 32)).to(self.device)
                out = kops.bitmap_patch(masks, delta_words, signs)
                for row, (repl, _, _) in zip(out, rows):
                    repl._words = row
            self.patched += len(patch)
            self.delta_evictions += len(evict)
            return {"patched": len(patch), "evicted": len(evict)}

    def apply_remap(self, mapping, new_n: int) -> int:
        """Store-compaction id remap: rewrite every resident entry's member
        ids through ``mapping`` (old row -> new row, -1 = reclaimed) and
        re-stamp it for the compacted store size. Directory membership did
        not change — the scope-epoch contract deliberately skips the bump —
        so the tokens are carried over unchanged and the entries stay live;
        every materialized form (the id array, the host bool mask and the
        device words, whose word count changed) is dropped with the old
        entry and rebuilt on its next read. Returns the number of entries
        patched."""
        with self._lock:
            for key, ent in list(self._entries.items()):
                scope = ScopeIndex._remap_bitmap(ent.scope, mapping)
                self._entries[key] = CachedScope(
                    tokens=ent.tokens, n=new_n, scope_size=len(scope),
                    scope=scope, device=self.device)
            self.patched += len(self._entries)
            return len(self._entries)

    def revalidate(self, index: ScopeIndex, n: int) -> Tuple[int, int]:
        """(still-valid, total) over the resident entries, without evicting —
        the cache-survival metric of the DSM benchmarks."""
        with self._lock:
            total = len(self._entries)
            valid = sum(1 for key, ent in self._entries.items()
                        if ent.n == n
                        and self._tokens(index, key) == ent.tokens)
        return valid, total

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "invalidations": self.invalidations,
                "patched": self.patched,
                "delta_evictions": self.delta_evictions}


@dataclass
class PlanGroup:
    """One unique scope in the batch with its chosen execution plan."""
    key: ScopeKey
    request_idx: List[int]           # batch positions sharing this scope
    scope_size: int
    plan: str                        # "gather" | "scan" | "empty"
    entry: CachedScope
    cache_hit: bool = False
    # chosen per group from the request-level precision knob: "int8" only
    # where the quantized phase actually prunes (every scan group; a gather
    # group only when its scope outsizes the rescore window — otherwise the
    # exact fp32 gather already reads fewer bytes than int8 scan + rescore)
    precision: str = "fp32"

    @property
    def candidate_ids(self) -> np.ndarray:   # gather plan reads this
        return self.entry.candidate_ids

    @property
    def words(self) -> torch.Tensor:         # scan plan reads this
        return self.entry.words

    @property
    def bool_mask(self) -> np.ndarray:       # PG traversal reads this
        return self.entry.bool_mask


@dataclass
class BatchAccounting:
    """Shared-resolution accounting for one dsq_batch call: attached to every
    per-request DSQResult so callers can see how much work was amortized."""
    batch_size: int = 0
    unique_scopes: int = 0
    scope_cache_hits: int = 0
    launches: int = 0
    plan_groups: Dict[str, int] = field(default_factory=dict)
    directory_ns: int = 0            # total resolve+plan time, whole batch
    ann_ns: int = 0                  # total ranking time, whole batch
    # executor phase terms (``repro_torch.trace``) inside ``ann_ns``,
    # filled by the flat launch and ``gather_rescore``: host preparation,
    # uploads and dispatch; the copies back, which wait for the device;
    # and how many copies back there were
    rank_host_ns: int = 0            # rank.put + rank.run
    rank_wait_ns: int = 0            # rank.get
    rank_syncs: int = 0              # device->host copies
    gather_listed: int = 0           # fp32 gather groups in one list launch
    gather_alone: int = 0            # gather groups ranked one call each
    # the two phases of the quantized plan, inside the terms above: phase
    # 1 (int8 / PQ scan or gather, its wait for the candidates included)
    # and the exact fp32 rescore
    approx_ns: int = 0               # rank.approx
    rescore_ns: int = 0              # rank.rescore
    resolve_stats: ResolveStats = field(default_factory=ResolveStats)
    # sharded-executor terms (zero on single-device paths): what this batch
    # actually moved between host and mesh, and across the mesh
    n_shards: int = 0
    shard_db_bytes: int = 0          # store rows mirrored to the mesh
    shard_mask_bytes: int = 0        # packed scope words uploaded (misses)
    shard_mask_hits: int = 0         # scan groups served from resident slots
    collective_bytes: int = 0        # all-gather (score, id) merge traffic
    # quantized-tier terms (zero on pure-fp32 batches): the resident bytes
    # of each precision's device store and how many candidates the int8
    # phase handed to the exact fp32 rescore
    precision_groups: Dict[str, int] = field(default_factory=dict)
    db_bytes_fp32: int = 0           # fp32 device store bytes (alive rows)
    db_bytes_int8: int = 0           # int8 codes + per-row scale bytes
    db_bytes_pq: int = 0             # PQ uint8 code bytes (alive rows)
    rescore_candidates: int = 0      # total approx-phase survivors rescored
    # tiered-storage terms (zero unless a device byte budget is configured):
    # fp32 bytes the exact rescore pulled host->device this batch, and where
    # the store's alive rows currently live
    tiered: bool = False             # store over its device byte budget
    rescore_fetch_bytes: int = 0     # host->device fp32 row fetch traffic
    rows_device_pinned: int = 0      # alive rows pinned device-resident
    rows_host: int = 0               # alive rows resident in host RAM only
    # fault-tolerance terms (zero on clean runs): transient host-fetch
    # faults absorbed by the store's bounded retry-with-backoff this batch
    host_fetch_retries: int = 0      # store.host_fetch transient retries
    # continuous-batching scheduler terms (zero on direct dsq_batch calls):
    # where this batch sat in the serving pipeline. Arrival is the earliest
    # admission timestamp in the batch; queue is the summed admission-queue
    # wait across its requests; stage is the (overlapped) host->device
    # staging time; service is the executor wall-clock the scheduler saw.
    sched_batches: int = 0           # scheduler-formed batches merged in
    sched_arrival_ns: int = 0        # earliest request arrival (clock ns)
    sched_queue_ns: int = 0          # summed admission-queue wait
    sched_stage_ns: int = 0          # mask/query staging time (overlapped)
    sched_service_ns: int = 0        # batch execute wall-clock
    sched_occupancy: float = 0.0     # summed batch_size / max_batch
    # cost-model observability: which decision layer produced the
    # plans, and what it predicted the ANN phase would cost — so planner
    # mispredictions show up in production counters, not only in benches
    plan_source: str = ""            # "measured" | "roofline" | "heuristic"
    predicted_ann_ns: int = 0        # model-predicted ranking time (0 = n/a)

    def merge(self, other: "BatchAccounting") -> "BatchAccounting":
        """Accumulate ``other`` into this accounting — the measurement-window
        aggregation the serving layer uses (one cumulative ``BatchAccounting``
        per window instead of re-creating the server to reset counters).
        Counters sum; dict terms sum per key; byte/placement gauges take the
        latest observation; ``tiered`` is sticky within the window."""
        gauges = {"db_bytes_fp32", "db_bytes_int8", "db_bytes_pq",
                  "rows_device_pinned", "rows_host", "n_shards"}
        for f in dataclasses.fields(self):
            ov = getattr(other, f.name)
            if f.name in ("plan_groups", "precision_groups"):
                mine = getattr(self, f.name)
                for key, v in ov.items():
                    mine[key] = mine.get(key, 0) + v
            elif f.name == "resolve_stats":
                for sf in dataclasses.fields(ov):
                    sv, mv = getattr(ov, sf.name), getattr(self.resolve_stats,
                                                           sf.name)
                    if isinstance(mv, dict):
                        for key, v in sv.items():
                            mv[key] = mv.get(key, 0) + v
                    else:
                        setattr(self.resolve_stats, sf.name, mv + sv)
            elif f.name == "tiered":
                self.tiered = self.tiered or ov
            elif f.name == "plan_source":
                if ov:
                    self.plan_source = ov
            elif f.name == "sched_arrival_ns":
                if ov:
                    self.sched_arrival_ns = (min(self.sched_arrival_ns, ov)
                                             if self.sched_arrival_ns else ov)
            elif f.name in gauges:
                if ov:
                    setattr(self, f.name, ov)
            else:
                setattr(self, f.name, getattr(self, f.name) + ov)
        return self

    def snapshot(self, reset: bool = False) -> Dict[str, object]:
        """Plain-dict view of every counter (JSON-friendly: nested dataclasses
        flatten). ``reset=True`` zeroes the accounting afterwards — the
        per-measurement-window contract: a serving layer keeps one cumulative
        instance, reads ``snapshot(reset=True)`` at each window edge, and QPS
        and latency percentiles derive per window without re-creating the
        server."""
        out: Dict[str, object] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "resolve_stats":
                out[f.name] = dataclasses.asdict(v)
            elif isinstance(v, dict):
                out[f.name] = dict(v)
            else:
                out[f.name] = v
        if reset:
            fresh = BatchAccounting()
            for f in dataclasses.fields(self):
                setattr(self, f.name, getattr(fresh, f.name))
        return out


def device_popcount(words: torch.Tensor) -> int:
    """On-device selectivity estimate of a packed scope mask (int32 view
    of the uint32 words, on any device): reuses the ``mask_and_popcount``
    kernel (AND with itself is the identity, the popcount side is what we
    want). For sizing scopes that exist only as device masks, where no host
    id set is available."""
    _, count = kops.mask_and_popcount(words, words)
    return int(count)


class BatchPlanner:
    def __init__(self, gather_threshold: float = GATHER_THRESHOLD,
                 cache: Optional[ScopeMaskCache] = None,
                 model: Optional[CostModel] = None, device=None):
        self.gather_threshold = gather_threshold
        # when a cost model is attached (DirectoryVectorDB passes the
        # store's), its calibrated crossover replaces the hand-set
        # gather_threshold — the same model FlatExecutor/ShardedExecutor
        # read, which is what keeps batch==loop==sharded plans identical
        self.model = model
        self.cache = cache if cache is not None else ScopeMaskCache(
            device=device)
        # cumulative per-scope request counts across every planned batch —
        # the DSQ access statistics the tiered store's hot-directory pinning
        # reads (hot scopes keep their fp32 rows device-resident)
        self.scope_access: Dict[ScopeKey, int] = {}

    def choose_plan(self, scope_size: int, n: int, k: int) -> str:
        """Same decision rule as the per-request FlatExecutor path (required
        for bit-identical batch-vs-loop results) — shared via
        ``flat.choose_plan``."""
        if scope_size == 0:
            return "empty"
        threshold = (self.model.gather_threshold(n, k)
                     if self.model is not None else self.gather_threshold)
        return choose_plan(scope_size, n, k, threshold)

    def resolve_scopes(self, index: ScopeIndex, n: int,
                       keys: Sequence[ScopeKey],
                       acct: Optional[BatchAccounting] = None
                       ) -> Tuple[Dict[ScopeKey, CachedScope], set]:
        """Cache-first resolution of a set of unique scope keys: hits are
        served while their scope-epoch tokens validate, misses resolve in one
        ``resolve_batch`` and are admitted under the capture-before-resolve
        token snapshot (a DSM racing the resolution can never be cached
        over). Shared by :meth:`plan` and the serving scheduler's staging
        pass — staging batch N+1 through here warms the same epoch-validated
        cache the execution-time plan reads, so a staged mask invalidated by
        a racing DSM simply misses again at execute time instead of serving
        a stale scope."""
        resolved: Dict[ScopeKey, CachedScope] = {}
        misses: List[Tuple[ScopeKey, Optional[Tuple]]] = []
        for key in keys:
            if key in resolved:
                continue
            ent = self.cache.lookup(index, key, n)
            if ent is not None:
                resolved[key] = ent
                if acct is not None:
                    acct.scope_cache_hits += 1
            else:
                # token snapshot BEFORE resolving: store() re-checks it so a
                # DSM racing the resolution can never be cached over
                misses.append((key, self.cache._tokens(index, key)))
        if misses:
            scopes = index.resolve_batch(
                [key.path for key, _ in misses],
                recursive=[key.recursive for key, _ in misses],
                exclude=[key.exclude for key, _ in misses],
                stats=(acct.resolve_stats if acct is not None
                       else ResolveStats()))
            for (key, toks), scope in zip(misses, scopes):
                resolved[key] = self.cache.store(index, key, n, scope,
                                                 tokens=toks)
        return resolved, {key for key, _ in misses}

    def plan(self, index: ScopeIndex, n: int, specs: Sequence[ScopeSpec],
             k: int, acct: BatchAccounting, precision: str = "fp32",
             rescore_k: Optional[int] = None) -> List[PlanGroup]:
        """Group a canonicalized batch by unique scope, resolve (cache-first,
        then one ``resolve_batch`` for the misses), and choose a plan per
        group by selectivity. With ``precision="int8"`` the planner also
        picks the *precision* per group: scan groups ride the quantized
        store (4x less scan bandwidth, then rescore), gather groups switch
        to int8 only when the scope outsizes the rescore window — a gather
        the window covers entirely is strictly better served by the exact
        fp32 gather it would end with anyway."""
        order: Dict[ScopeKey, List[int]] = {}
        for i, spec in enumerate(specs):
            order.setdefault(ScopeKey.from_spec(spec), []).append(i)
        for key, idxs in order.items():
            self.scope_access[key] = self.scope_access.get(key, 0) + len(idxs)
        acct.batch_size += len(specs)
        acct.unique_scopes += len(order)

        resolved, misses = self.resolve_scopes(index, n, list(order),
                                               acct=acct)

        groups: List[PlanGroup] = []
        for key, idxs in order.items():
            ent = resolved[key]
            size = ent.scope_size
            plan = self.choose_plan(size, n, k)
            prec = "fp32"
            if precision in ("int8", "pq") and plan != "empty":
                r = resolve_rescore_k(k, rescore_k, size)
                if plan == "scan" or size > r:
                    prec = precision
            groups.append(PlanGroup(
                key=key, request_idx=idxs, scope_size=size, plan=plan,
                entry=ent, cache_hit=key not in misses, precision=prec))
            acct.plan_groups[plan] = acct.plan_groups.get(plan, 0) + 1
            if plan != "empty":
                acct.precision_groups[prec] = (
                    acct.precision_groups.get(prec, 0) + 1)
        return groups
