"""TRIEHI — Trie-based Hierarchical Index (§IV, the paper's core contribution).

The directory topology is kept as a native prefix tree. Each directory is a
TrieNode with a stable identity, and the node maintains the aggregate invariant

    Inc(v) = Local(v)  ∪  ⋃_{w ∈ Child(v)} Inc(w)                    (Eq. 1)

so a node is a *reusable materialized scope*: recursive DSQ reads one aggregate
after an O(t) traversal, MOVE relinks a subtree root and touches only the
ancestor chains whose descendant membership changed, and MERGE reconciles
conflicts node-locally while relinking non-conflicting subtrees as whole units.

Catalog note: entries are bound to TrieNode objects. A node dissolved by MERGE
leaves a forwarding pointer (union-find style, with path compression) so that
entry->node catalog resolution stays O(α) without per-entry rewrites.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

from . import paths as P
from .idset import RoaringBitmap
from .interface import DSMDelta, DSMStats, ResolveStats, ScopeIndex


class TrieNode:
    __slots__ = ("segment", "parent", "children", "inclusive", "local",
                 "forward", "epoch")

    def __init__(self, segment: str, parent: Optional["TrieNode"]):
        self.segment = segment
        self.parent = parent
        self.children: Dict[str, TrieNode] = {}
        self.inclusive = RoaringBitmap()   # Inc(v): entries at-or-below v
        self.local = RoaringBitmap()       # Local(v): entries directly at v
        self.forward: Optional[TrieNode] = None  # set when dissolved by MERGE
        self.epoch = 0                     # scope epoch: bumped when Inc/Local change

    def path(self) -> P.Path:
        segs: List[str] = []
        node: Optional[TrieNode] = self
        while node is not None and node.parent is not None:
            segs.append(node.segment)
            node = node.parent
        return tuple(reversed(segs))

    def resolve_forward(self) -> "TrieNode":
        node = self
        while node.forward is not None:
            node = node.forward
        # path compression
        cur = self
        while cur.forward is not None and cur.forward is not node:
            nxt = cur.forward
            cur.forward = node
            cur = nxt
        return node

    def __repr__(self) -> str:
        return f"TrieNode({P.to_str(self.path())}, inc={len(self.inclusive)})"


class TrieHIIndex(ScopeIndex):
    name = "triehi"

    def __init__(self):
        super().__init__()
        self.root = TrieNode("", None)
        self._n_dirs = 1

    # ------------------------------------------------------------ traversal
    def _walk(self, path: P.Path, create: bool = False,
              stats: Optional[ResolveStats] = None) -> Optional[TrieNode]:
        node = self.root
        visits = 1
        for seg in path:
            child = node.children.get(seg)
            if child is None:
                if not create:
                    if stats is not None:
                        stats.node_visits += visits
                    return None
                child = TrieNode(seg, node)
                node.children[seg] = child
                self._n_dirs += 1
            node = child
            visits += 1
        if stats is not None:
            stats.node_visits += visits
        return node

    def _ancestor_chain(self, node: TrieNode) -> List[TrieNode]:
        """Proper ancestors, nearest first (excludes ``node`` itself)."""
        out = []
        cur = node.parent
        while cur is not None:
            out.append(cur)
            cur = cur.parent
        return out

    # ---------------------------------------------------------------- write
    def mkdir(self, path: P.Path | str) -> None:
        self._walk(P.parse(path), create=True)

    def insert(self, entry_id: int, dir_path: P.Path | str) -> None:
        node = self._walk(P.parse(dir_path), create=True)
        assert node is not None
        with self._agg_latch:
            node.local.add(entry_id)
            # O(t) aggregate updates up the ancestor chain (Table II)
            cur: Optional[TrieNode] = node
            while cur is not None:
                cur.inclusive.add(entry_id)
                cur.epoch += 1
                cur = cur.parent
            self._bump_epoch()
        self.catalog.bind(entry_id, node)

    def bulk_insert(self, entry_ids, dir_paths) -> None:
        import numpy as np
        groups = {}
        for eid, path in zip(entry_ids, dir_paths):
            groups.setdefault(P.parse(path), []).append(eid)
        for path, ids in groups.items():
            node = self._walk(path, create=True)
            arr = np.asarray(ids, np.uint32)
            with self._agg_latch:
                node.local.add_many(arr)
                cur = node
                while cur is not None:
                    cur.inclusive.add_many(arr)
                    cur.epoch += 1
                    cur = cur.parent
            self.catalog.bind_many(ids, node)
        with self._agg_latch:
            self._bump_epoch()

    def delete(self, entry_id: int) -> None:
        ref = self.catalog.get(entry_id)
        if ref is None:
            raise KeyError(entry_id)
        node = ref.resolve_forward()
        with self._agg_latch:
            node.local.remove(entry_id)
            cur: Optional[TrieNode] = node
            while cur is not None:
                cur.inclusive.remove(entry_id)
                cur.epoch += 1
                cur = cur.parent
            self._bump_epoch()
        self.catalog.unbind(entry_id)

    # ----------------------------------------------------------------- read
    def resolve(self, path: P.Path | str, recursive: bool = True,
                stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        t0 = time.perf_counter_ns()
        node = self._walk(P.parse(path), create=False, stats=stats)
        t1 = time.perf_counter_ns()
        if stats is not None:
            stats.stage_ns["traverse"] = stats.stage_ns.get("traverse", 0) + t1 - t0
        if node is None:
            return RoaringBitmap()
        if recursive:
            with self._agg_latch:    # vs in-place DSM/ingest container writes
                out = node.inclusive.copy()
            t2 = time.perf_counter_ns()
            if stats is not None:
                stats.posting_fetches += 1
                stats.stage_ns["bitmap_fetch"] = (
                    stats.stage_ns.get("bitmap_fetch", 0) + t2 - t1)
            return out
        # non-recursive: Inc(p) \ union(Inc(children)) (paper-faithful; equals
        # Local(p) by Eq. 1 — asserted in check_invariants)
        with self._agg_latch:
            children = RoaringBitmap()
            for child in node.children.values():
                children |= child.inclusive
            out = node.inclusive - children
        t2 = time.perf_counter_ns()
        if stats is not None:
            stats.posting_fetches += 1 + len(node.children)
            stats.set_ops += len(node.children) + 1
            stats.stage_ns["bitmap_compute"] = (
                stats.stage_ns.get("bitmap_compute", 0) + t2 - t1)
        return out

    def scope_token(self, path: P.Path | str, recursive: bool = True):
        """Per-node scope epoch: the token is (node identity, node epoch).
        Mutations bump exactly the nodes whose Inc/Local changed, so cached
        packed masks for unrelated subtrees survive DSM elsewhere. A MOVE or
        MERGE that relocates the anchor changes what the path walk returns
        (different node, or none), which also invalidates. Missing
        directories are uncacheable (``None``): an insert could create them."""
        node = self._walk(P.parse(path), create=False)
        if node is None:
            return None
        return (node, node.epoch)

    def resolve_batch(self, paths, recursive=True, exclude=None,
                      stats: Optional[ResolveStats] = None):
        """Batched resolve with *sub-scope* deduplication: the anchors and
        every exclusion branch across the whole batch form one pool of
        (path, recursive) sub-scopes, each resolved against the trie once;
        exclusion requests are composed from the shared pieces."""
        from .interface import normalize_batch
        specs = normalize_batch(paths, recursive, exclude)
        sub: Dict[Tuple[P.Path, bool], RoaringBitmap] = {}

        def sub_resolve(path: P.Path, rec: bool) -> RoaringBitmap:
            key = (path, rec)
            hit = sub.get(key)
            if hit is None:
                hit = sub[key] = self.resolve(path, recursive=rec, stats=stats)
            elif stats is not None:
                stats.dedup_hits += 1
            return hit

        composed: Dict[Tuple, RoaringBitmap] = {}
        out = []
        for path, rec, exc in specs:
            if not exc:
                out.append(sub_resolve(path, rec))
                continue
            ckey = (path, rec, exc)
            got = composed.get(ckey)
            if got is None:
                got = sub_resolve(path, rec).copy()
                for branch in exc:
                    got -= sub_resolve(branch, True)
                composed[ckey] = got
            out.append(got)
        if stats is not None:
            stats.batch_size += len(specs)
            # distinct full specs, same definition as the base class (the
            # finer sub-scope sharing shows up in dedup_hits instead)
            stats.unique_scopes += len(set(specs))
        return out

    # ------------------------------------------------------------------ DSM
    @staticmethod
    def _split_chains(a: List[TrieNode], b: List[TrieNode]
                      ) -> Tuple[List[TrieNode], List[TrieNode]]:
        """Drop the common suffix (shared ancestors) of two root-terminated
        ancestor chains; returns (a_only, b_only)."""
        ai, bi = len(a), len(b)
        while ai > 0 and bi > 0 and a[ai - 1] is b[bi - 1]:
            ai -= 1
            bi -= 1
        return a[:ai], b[:bi]

    def move(self, src: P.Path | str, new_parent: P.Path | str,
             stats: Optional[DSMStats] = None) -> None:
        src_p = P.parse(src)
        np_p = P.parse(new_parent)
        if not src_p:
            raise ValueError("cannot move root")
        s = self._walk(src_p, create=False)
        if s is None:
            raise KeyError(P.to_str(src_p))
        if P.is_ancestor(src_p, np_p):
            raise ValueError("cannot move a subtree into itself")
        dest = self._walk(np_p, create=True)
        assert dest is not None
        if s.segment in dest.children:
            raise ValueError(
                f"{P.to_str(np_p + (s.segment,))} exists; use merge()")
        agg = s.inclusive
        old_chain = self._ancestor_chain(s)              # proper ancestors of s
        new_chain = [dest] + self._ancestor_chain(dest)  # dest + its ancestors
        old_only, new_only = self._split_chains(old_chain, new_chain)
        rem_ev = add_ev = ()
        delta_copy = None
        with self._agg_latch:
            for anc in old_only:
                anc.inclusive -= agg
                anc.epoch += 1
            for anc in new_only:
                anc.inclusive |= agg
                anc.epoch += 1
            self._bump_epoch()
            if self._dsm_listeners:
                # epoch pairs + delta snapshot captured inside the latch: a
                # concurrent op's bump or ingest can never be folded into
                # this event
                rem_ev = tuple((a, a.epoch - 1, a.epoch) for a in old_only)
                add_ev = tuple((a, a.epoch - 1, a.epoch) for a in new_only)
                delta_copy = agg.copy()
        # relink: one child-map delete, one insert, one parent pointer update.
        # Independent of the number of descendant directories.
        assert s.parent is not None
        del s.parent.children[s.segment]
        dest.children[s.segment] = s
        s.parent = dest
        if stats is not None:
            stats.ops += 1
            stats.nodes_relinked += 1
            stats.postings_touched += len(old_only) + len(new_only)
            stats.agg_bits_updated += len(agg) * (len(old_only) + len(new_only))
            stats.epochs_bumped += len(old_only) + len(new_only) + 1
        if delta_copy is not None:
            self._emit_dsm(DSMDelta(kind="move", delta=delta_copy,
                                    removed_from=rem_ev, added_to=add_ev))

    def merge(self, src: P.Path | str, dst: P.Path | str,
              stats: Optional[DSMStats] = None) -> None:
        src_p, dst_p = P.parse(src), P.parse(dst)
        if not src_p or not dst_p:
            raise ValueError("cannot merge the root directory")
        s = self._walk(src_p, create=False)
        if s is None:
            raise KeyError(P.to_str(src_p))
        d = self._walk(dst_p, create=False)
        if d is None:
            raise KeyError(P.to_str(dst_p))
        P.validate_disjoint(src_p, dst_p)
        agg = s.inclusive
        delta = None
        # ancestor aggregates: S leaves old-only proper ancestors of s, enters
        # d and new-only proper ancestors of d; common ancestors unchanged.
        old_chain = self._ancestor_chain(s)
        new_chain = [d] + self._ancestor_chain(d)
        old_only, new_only = self._split_chains(old_chain, new_chain)
        rem_ev = add_ev = ()
        with self._agg_latch:
            for anc in old_only:
                anc.inclusive -= agg
                anc.epoch += 1
            for anc in new_only:
                anc.inclusive |= agg
                anc.epoch += 1
            self._bump_epoch()
            if self._dsm_listeners:
                rem_ev = tuple((a, a.epoch - 1, a.epoch) for a in old_only)
                add_ev = tuple((a, a.epoch - 1, a.epoch) for a in new_only)
                delta = agg.copy()
        if stats is not None:
            stats.ops += 1
            stats.postings_touched += len(old_only) + len(new_only)
            stats.agg_bits_updated += len(agg) * (len(old_only) + len(new_only))
            stats.epochs_bumped += len(old_only) + len(new_only) + 1
        # detach s, then reconcile topology below s and d (conflict unions
        # write shared containers -> latched against concurrent readers)
        assert s.parent is not None
        del s.parent.children[s.segment]
        with self._agg_latch:
            self._reconcile(s, d, stats)
        if delta is not None:
            # d's own epoch moves again during reconciliation (local union),
            # past the new_epoch this event recorded for it — a cached scope
            # at d is patched to that recorded epoch and then self-evicts on
            # the next lookup rather than validating against a half-seen
            # state. The pure ancestor entries patch and stay valid.
            self._emit_dsm(DSMDelta(kind="merge", delta=delta,
                                    removed_from=rem_ev, added_to=add_ev))

    def _reconcile(self, a: TrieNode, b: TrieNode,
                   stats: Optional[DSMStats] = None) -> None:
        """Dissolve node ``a`` into node ``b``. Aggregates above b already
        account for Inc(a); b.inclusive includes Inc(a) as well. Work is
        node-level: non-conflicting children relink as whole units (r counts
        only the conflicting nodes visited)."""
        b.local |= a.local
        b.epoch += 1
        if stats is not None:
            stats.nodes_dissolved += 1
            stats.postings_touched += 1
            stats.ids_rewritten += len(a.local)
            stats.epochs_bumped += 1
        for name, ca in list(a.children.items()):
            cb = b.children.get(name)
            if cb is None:
                # relink whole subtree as a unit: O(1) topology update
                b.children[name] = ca
                ca.parent = b
                if stats is not None:
                    stats.nodes_relinked += 1
            else:
                cb.inclusive |= ca.inclusive
                if stats is not None:
                    stats.postings_touched += 1
                    stats.agg_bits_updated += len(ca.inclusive)
                self._reconcile(ca, cb, stats)
        a.children.clear()
        a.forward = b           # catalog forwarding for entries bound to a
        a.parent = None
        self._n_dirs -= 1

    def remove(self, path: P.Path | str,
               stats: Optional[DSMStats] = None) -> RoaringBitmap:
        """Recursive subtree removal: one detach, O(t) ancestor-chain
        aggregate updates, catalog unbinds for the removed entries — the
        subtree's own nodes are dropped wholesale, never visited per entry."""
        p = P.parse(path)
        if not p:
            raise ValueError("cannot remove root")
        node = self._walk(p, create=False)
        if node is None:
            raise KeyError(P.to_str(p))
        chain = self._ancestor_chain(node)
        rem_ev = ()
        with self._agg_latch:
            removed = node.inclusive.copy()
            for anc in chain:
                anc.inclusive -= removed
                anc.epoch += 1
            self._bump_epoch()
            if self._dsm_listeners:
                rem_ev = tuple((a, a.epoch - 1, a.epoch) for a in chain)
        assert node.parent is not None
        del node.parent.children[node.segment]
        node.parent = None
        n_dropped = sum(1 for _ in self._iter_subtree(node))
        self._n_dirs -= n_dropped
        for eid in removed.to_array():
            self.catalog.unbind(int(eid))
        if stats is not None:
            stats.ops += 1
            stats.postings_touched += len(chain)
            stats.agg_bits_updated += len(removed) * len(chain)
            stats.dirs_removed += n_dropped
            stats.entries_unbound += len(removed)
            stats.epochs_bumped += len(chain) + 1
        if self._dsm_listeners:
            self._emit_dsm(DSMDelta(kind="remove", delta=removed.copy(),
                                    removed_from=rem_ev))
        return removed

    @staticmethod
    def _iter_subtree(node: TrieNode) -> Iterator[TrieNode]:
        stack = [node]
        while stack:
            cur = stack.pop()
            yield cur
            stack.extend(cur.children.values())

    def resolve_pattern(self, pattern: P.Path | str, recursive: bool = True,
                        stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        """Wildcard DSQ, natively: ``*`` matches any child name at that level;
        traversal continues only along matching branches (the structural
        advantage over scanning flat path strings, §IV-A)."""
        pat = P.parse(pattern)
        frontier = [self.root]
        visits = 1
        for seg in pat:
            nxt = []
            for node in frontier:
                if seg == "*":
                    nxt.extend(node.children.values())
                else:
                    child = node.children.get(seg)
                    if child is not None:
                        nxt.append(child)
            visits += len(nxt)
            frontier = nxt
            if not frontier:
                break
        if stats is not None:
            stats.node_visits += visits
        out = RoaringBitmap()
        with self._agg_latch:
            for node in frontier:
                if recursive:
                    out |= node.inclusive
                else:
                    children = RoaringBitmap.union_many(
                        c.inclusive for c in node.children.values())
                    out |= node.inclusive - children
        return out

    # -------------------------------------------------------------- remap
    def remap_ids(self, mapping) -> None:
        """Order-preserving id compaction: rewrite every node's Inc/Local
        aggregates and the catalog. Node epochs are deliberately untouched
        (membership is unchanged; paired mask caches patch their packed
        words from the same mapping)."""
        with self._agg_latch:
            for node in self.iter_nodes():
                node.inclusive = self._remap_bitmap(node.inclusive, mapping)
                node.local = self._remap_bitmap(node.local, mapping)
        self.catalog.remap_ids(mapping)

    # ------------------------------------------------------------ inspection
    def has_dir(self, path: P.Path | str) -> bool:
        return self._walk(P.parse(path), create=False) is not None

    def list_dirs(self) -> List[P.Path]:
        out: List[P.Path] = []
        stack: List[Tuple[TrieNode, P.Path]] = [(self.root, P.ROOT)]
        while stack:
            node, path = stack.pop()
            out.append(path)
            for name, child in node.children.items():
                stack.append((child, path + (name,)))
        return out

    def iter_nodes(self) -> Iterator[TrieNode]:
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def memory_bytes(self) -> int:
        total = 0
        for node in self.iter_nodes():
            total += 120 + len(node.segment) + 49       # node object + segment
            total += 64 * len(node.children)            # child map slots
            total += node.inclusive.memory_bytes()      # per-node aggregate
            total += node.local.memory_bytes()
        return total

    def _ref_path(self, ref: object) -> P.Path:
        return ref.resolve_forward().path()  # type: ignore[attr-defined]

    def check_invariants(self) -> None:
        # Eq. 1 at every node, bottom-up; Local == Inc \ union(child Inc)
        def rec(node: TrieNode) -> RoaringBitmap:
            child_union = RoaringBitmap()
            for child in node.children.values():
                assert child.parent is node, "broken parent pointer"
                child_union |= rec(child)
            want = node.local | child_union
            assert want == node.inclusive, (
                f"Eq.1 violated at {P.to_str(node.path())}: "
                f"inc={len(node.inclusive)} want={len(want)}")
            nonrec = node.inclusive - child_union
            assert nonrec == node.local, "non-recursive != Local"
            return node.inclusive
        rec(self.root)
        # catalog binds resolve to live nodes holding the entry
        for eid, ref in self.catalog.items():
            node = ref.resolve_forward()
            assert node.forward is None
            assert eid in node.local, f"entry {eid} not in Local of its node"
