"""ScopeIndex — the pluggable directory-semantic layer contract (§II-D).

Every strategy (PE-ONLINE, PE-OFFLINE, TRIEHI) implements this interface. The
ANN executor only ever sees the resolved :class:`RoaringBitmap` candidate set,
which is what makes the layer ANN-index independent (design requirement 4).
"""
from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from typing import (Callable, Dict, Hashable, List, Optional, Sequence, Tuple,
                    Union)

from . import paths as P
from .catalog import Catalog
from .idset import RoaringBitmap


@dataclass
class ResolveStats:
    """Per-stage directory-only timing/counters (Fig. 12 decomposition)."""

    subpath_keys: int = 0          # m_q: directory keys enumerated (PE-ONLINE)
    posting_fetches: int = 0       # posting-list / aggregate-set reads
    set_ops: int = 0               # unions/differences performed
    node_visits: int = 0           # trie node visits (TrieHI) / key probes
    batch_size: int = 0            # requests in the resolve_batch call
    unique_scopes: int = 0         # distinct scope resolutions performed
    dedup_hits: int = 0            # requests served by an earlier resolution
    stage_ns: Dict[str, int] = field(default_factory=dict)


@dataclass
class DSMStats:
    """Per-op maintenance write-accounting (the measurable Table II contrast).

    The counters separate *structural* writes (containers/keys/nodes touched)
    from *content* writes (entry memberships re-filed), because that split is
    exactly what distinguishes the strategies: expansion designs re-file
    posting content under new keys (O(m_u) keys, and for PE-OFFLINE the
    t-fold materialized copies of every subtree entry), while TrieHI relinks
    whole subtrees and only runs bounded ancestor-chain aggregate updates.

    * ``keys_rekeyed``       path keys remapped (the PE-* O(m_u) term)
    * ``postings_touched``   posting-list / aggregate containers written,
                             whether re-keyed or updated in place
    * ``ids_rewritten``      posting *content* re-filed under a different
                             key/container (PE-*: every id of every moved
                             posting; TrieHI: only merge-conflict locals)
    * ``agg_bits_updated``   ids added/removed by in-place ancestor-chain
                             set ops (|S| per chain node, all strategies)
    * ``nodes_relinked``     whole-subtree topology relinks (TrieHI O(1) move)
    * ``nodes_dissolved``    merge conflict reconciliations (TrieHI)
    * ``dirs_removed``       directory keys/nodes dropped by REMOVE
    * ``entries_unbound``    catalog unbinds (REMOVE)
    * ``epochs_bumped``      scope-epoch bumps (cache-invalidation breadth)
    """

    ops: int = 0
    keys_rekeyed: int = 0
    postings_touched: int = 0
    ids_rewritten: int = 0
    agg_bits_updated: int = 0
    nodes_relinked: int = 0
    nodes_dissolved: int = 0
    dirs_removed: int = 0
    entries_unbound: int = 0
    epochs_bumped: int = 0
    stage_ns: Dict[str, int] = field(default_factory=dict)

    @property
    def write_touches(self) -> int:
        """Structural write count: keys + containers + topology updates."""
        return (self.keys_rekeyed + self.postings_touched
                + self.nodes_relinked + self.nodes_dissolved
                + self.dirs_removed)

    def merge(self, other: "DSMStats") -> "DSMStats":
        for f in ("ops", "keys_rekeyed", "postings_touched", "ids_rewritten",
                  "agg_bits_updated", "nodes_relinked", "nodes_dissolved",
                  "dirs_removed", "entries_unbound", "epochs_bumped"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for k, v in other.stage_ns.items():
            self.stage_ns[k] = self.stage_ns.get(k, 0) + v
        return self


@dataclass(frozen=True)
class DSMDelta:
    """Structural-mutation delta event, emitted by strategies with stable
    scope-token anchors (TrieHI) so downstream mask caches can *patch*
    surviving entries in place instead of evicting them.

    ``delta`` is the moved/removed aggregate S; ``removed_from``/``added_to``
    list ``(token_anchor, old_epoch, new_epoch)`` triples for every node
    whose inclusive aggregate lost/gained exactly S, captured atomically
    with the epoch bump (under the aggregate latch). A cache entry may take
    the delta only while its stored token equals ``(anchor, old_epoch)`` —
    an entry already stale for another reason (an earlier un-evented epoch
    bump, e.g. a point delete) must evict, not be re-stamped valid — and
    then advances to ``(anchor, new_epoch)``. Nodes whose change is *not*
    exactly S (e.g. merge-conflict children) are deliberately absent: their
    cached entries self-evict through the normal token mismatch."""

    kind: str
    delta: RoaringBitmap
    removed_from: Tuple[Tuple[object, int, int], ...] = ()
    added_to: Tuple[Tuple[object, int, int], ...] = ()


# A batch item's scope: (parsed anchor, recursive, parsed exclude branches).
ScopeSpec = Tuple[P.Path, bool, Tuple[P.Path, ...]]


def normalize_batch(paths: Sequence[P.Path | str],
                    recursive: Union[bool, Sequence[bool]] = True,
                    exclude: Optional[Sequence[Sequence[P.Path | str]]] = None
                    ) -> List[ScopeSpec]:
    """Canonicalize per-request scope specs so identical scopes across a batch
    compare (and dedup) by value."""
    n = len(paths)
    if isinstance(recursive, (bool, int)) or (
            hasattr(recursive, "ndim") and recursive.ndim == 0):
        rec = [bool(recursive)] * n
    else:
        rec = [bool(r) for r in recursive]
        if len(rec) != n:
            raise ValueError(f"{len(rec)} recursive flags for {n} paths")
    if exclude is None:
        exc: List[Tuple[P.Path, ...]] = [()] * n
    else:
        if len(exclude) != n:
            raise ValueError(f"{len(exclude)} exclude lists for {n} paths")
        exc = [tuple(sorted(P.parse(e) for e in (ex or ()))) for ex in exclude]
    return [(P.parse(p), r, e) for p, r, e in zip(paths, rec, exc)]


class ScopeIndex(abc.ABC):
    """Directory scope-resolution index above the ANN executor."""

    name: str = "abstract"

    def __init__(self):
        self.catalog = Catalog()
        # Scope-epoch counter: bumped by every scope-content mutation
        # (insert/delete/move/merge). The coarse fallback for strategies
        # without per-node state; TrieHI refines this to per-node epochs.
        self._epoch = 0
        # Aggregate-container latch. Region locks serialize DSM ops on
        # overlapping subtrees, but posting/aggregate containers are shared
        # *across* regions: two region-disjoint moves both update ancestors
        # up to their common ancestor, and ingest/resolve touch the same
        # containers with no region lock at all. Every in-place container
        # mutation (DSM ancestor updates, insert/delete chains) and every
        # container read that iterates one (resolve's copy/union) takes this
        # short latch; subtree-local re-keying stays concurrent.
        self._agg_latch = threading.Lock()
        self._dsm_listeners: List[Callable[[DSMDelta], None]] = []

    def _bump_epoch(self) -> None:
        self._epoch += 1

    # ----------------------------------------------------------- DSM deltas
    def subscribe_dsm(self, fn: Callable[[DSMDelta], None]) -> None:
        """Register a listener for :class:`DSMDelta` events (mask caches).
        Only strategies with patchable scope tokens (TrieHI) emit; the PE-*
        global-epoch token cannot be patched, so they stay silent and their
        cached scopes die through the normal epoch mismatch."""
        self._dsm_listeners.append(fn)

    def unsubscribe_dsm(self, fn: Callable[[DSMDelta], None]) -> None:
        """Remove a previously-registered delta listener (no-op if absent) —
        a replaced subscriber (e.g. a rebuilt sharded executor) must be
        dropped or it stays referenced, and patched, forever."""
        try:
            self._dsm_listeners.remove(fn)
        except ValueError:
            pass

    def _emit_dsm(self, event: DSMDelta) -> None:
        for fn in self._dsm_listeners:
            fn(event)

    # ------------------------------------------------------------ mask cache
    def scope_token(self, path: P.Path | str,
                    recursive: bool = True) -> Optional[Hashable]:
        """Opaque validity token for caching a resolution of
        ``(path, recursive)``: a cached candidate set (or packed device mask
        derived from it) stays valid exactly while the token compares equal.
        ``None`` means "do not cache". The default is the global scope epoch —
        any mutation invalidates everything; TrieHI overrides with per-node
        epochs so unrelated subtrees keep their cached masks across DSM."""
        return ("epoch", self._epoch)

    # ------------------------------------------------------------ write path
    @abc.abstractmethod
    def mkdir(self, path: P.Path | str) -> None:
        """Register a directory (and its ancestors) without any entry."""

    @abc.abstractmethod
    def insert(self, entry_id: int, dir_path: P.Path | str) -> None:
        """Bind a vectorized entry to its logical parent directory."""

    def bulk_insert(self, entry_ids, dir_paths) -> None:
        """Batch ingestion: group entries by directory and use vectorized
        bitmap updates (production ingestion path; subclasses override)."""
        for eid, path in zip(entry_ids, dir_paths):
            self.insert(int(eid), path)

    @abc.abstractmethod
    def delete(self, entry_id: int) -> None:
        """Remove an entry from the index (uses the catalog)."""

    # ------------------------------------------------------------- read path
    @abc.abstractmethod
    def resolve(self, path: P.Path | str, recursive: bool = True,
                stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        """DSQ scope resolution -> candidate entry-ID set."""

    def resolve_batch(self, paths: Sequence[P.Path | str],
                      recursive: Union[bool, Sequence[bool]] = True,
                      exclude: Optional[Sequence[Sequence[P.Path | str]]] = None,
                      stats: Optional[ResolveStats] = None
                      ) -> List[RoaringBitmap]:
        """Batched DSQ scope resolution with deduplication: identical
        ``(path, recursive, exclude)`` scopes across the batch are resolved
        once and the result object is shared. Returns one candidate set per
        request, aligned with ``paths``. ``recursive`` may be a scalar or
        per-request; ``exclude`` is an optional per-request list of excluded
        branches. Fallback implementation; TrieHI additionally dedups the
        anchor/exclusion sub-scopes across requests."""
        specs = normalize_batch(paths, recursive, exclude)
        resolved: Dict[ScopeSpec, RoaringBitmap] = {}
        out: List[RoaringBitmap] = []
        for spec in specs:
            hit = resolved.get(spec)
            if hit is None:
                path_t, rec, exc = spec
                if exc:
                    hit = self.resolve_exclusion(path_t, list(exc),
                                                 recursive=rec, stats=stats)
                else:
                    hit = self.resolve(path_t, recursive=rec, stats=stats)
                resolved[spec] = hit
            elif stats is not None:
                stats.dedup_hits += 1
            out.append(hit)
        if stats is not None:
            stats.batch_size += len(specs)
            stats.unique_scopes += len(resolved)
        return out

    # ------------------------------------------------------------------ DSM
    @abc.abstractmethod
    def move(self, src: P.Path | str, new_parent: P.Path | str,
             stats: Optional[DSMStats] = None) -> None:
        """Relocate subtree ``src`` to become a child of ``new_parent``."""

    @abc.abstractmethod
    def merge(self, src: P.Path | str, dst: P.Path | str,
              stats: Optional[DSMStats] = None) -> None:
        """Merge subtree ``src`` into existing subtree ``dst`` (recursive
        name-conflict reconciliation); ``src`` ceases to exist."""

    @abc.abstractmethod
    def remove(self, path: P.Path | str,
               stats: Optional[DSMStats] = None) -> RoaringBitmap:
        """Recursively remove subtree ``path``: drop its postings/nodes,
        unbind its entries from the catalog, and return the removed entry-id
        set (the caller tombstones those ids at the vector store)."""

    # -------------------------------------------------------------- remap
    @staticmethod
    def _remap_bitmap(bm: RoaringBitmap, mapping) -> RoaringBitmap:
        """Rewrite a posting/aggregate set under an order-preserving id
        compaction (``mapping[old_id] -> new_id``, negative = dropped)."""
        import numpy as np
        old = bm.to_array()
        if len(old) == 0:
            return RoaringBitmap()
        new = np.asarray(mapping)[old.astype(np.int64)]
        new = new[new >= 0]
        return RoaringBitmap.from_array(new.astype(np.uint32))

    def remap_ids(self, mapping) -> None:
        """Tombstone compaction renumbered every live entry: rewrite all
        posting/aggregate containers and catalog bindings in place.
        Deliberately does NOT bump scope epochs — directory *membership* is
        unchanged, only the id encoding moved, so cached tokens stay valid
        provided every mask cache receives the paired ``IdRemap`` event and
        patches its packed words the same way (see planner.ScopeMaskCache
        and ShardedExecutor)."""
        raise NotImplementedError

    # ------------------------------------------------------------ inspection
    @abc.abstractmethod
    def has_dir(self, path: P.Path | str) -> bool: ...

    @abc.abstractmethod
    def list_dirs(self) -> List[P.Path]:
        """All directory paths currently registered (test/debug)."""

    @abc.abstractmethod
    def memory_bytes(self) -> int:
        """Directory-module resident bytes (catalog excluded, per §V-A)."""

    @abc.abstractmethod
    def check_invariants(self) -> None:
        """Raise AssertionError when internal invariants are violated."""

    # ------------------------------------------------------------- utilities
    def entry_dir(self, entry_id: int) -> Optional[P.Path]:
        """Current logical directory of an entry, via the shared catalog."""
        ref = self.catalog.get(entry_id)
        if ref is None:
            return None
        return self._ref_path(ref)

    @abc.abstractmethod
    def _ref_path(self, ref: object) -> P.Path: ...

    def resolve_pattern(self, pattern: P.Path | str, recursive: bool = True,
                        stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        """Derived DSQ (§IV-A "Derived Path Patterns", the paper's named
        future work): resolve a path with ``*`` wildcard segments, e.g.
        ``/users/*/sessions/s3/``. Default implementation scans all directory
        keys (what a flat path-string store must do); TrieHI overrides with a
        branch-pruned trie traversal."""
        pat = P.parse(pattern)
        out = RoaringBitmap()
        for d in self.list_dirs():
            if len(d) != len(pat):
                continue
            if all(ps == "*" or ps == ds for ps, ds in zip(pat, d)):
                out |= self.resolve(d, recursive=recursive, stats=stats)
        return out

    def resolve_exclusion(self, path: P.Path | str, exclude: List[P.Path | str],
                          recursive: bool = True,
                          stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        """Derived DSQ: scope(path) minus the recursive scopes of ``exclude``
        branches (§II-C: exclusion = subtracting a branch's recursive scope)."""
        scope = self.resolve(path, recursive=recursive, stats=stats)
        for ex in exclude:
            scope -= self.resolve(ex, recursive=True, stats=stats)
        return scope
