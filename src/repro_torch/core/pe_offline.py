"""PE-OFFLINE — ingestion-time path expansion (§III-B).

Space-for-time design: every entry is materialized into the posting list of
*every ancestor* directory key, so a recursive DSQ is a single lookup. The
price: O(t) ingestion work per entry, t ancestor posting lists of storage,
set-difference non-recursive queries, and ancestor-membership updates on DSM.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import paths as P
from .auxdir import AuxDirectoryIndex
from .catalog import PathRef
from .idset import RoaringBitmap
from .interface import DSMStats, ResolveStats, ScopeIndex


def _ancestor_split(src: P.Path, dst: P.Path) -> Tuple[List[P.Path], List[P.Path]]:
    """Old-only and new-only *proper* ancestor chains after removing the
    common proper ancestors (the A-/A+ sets of §III-B DSM)."""
    common = P.common_prefix(src, dst)
    old_only = [src[:i] for i in range(len(common) + 1, len(src))]
    new_only = [dst[:i] for i in range(len(common) + 1, len(dst))]
    # the common prefix itself and everything above stays untouched
    return old_only, new_only


class PEOfflineIndex(ScopeIndex):
    name = "pe_offline"

    def __init__(self):
        super().__init__()
        self.aux = AuxDirectoryIndex()
        # ancestor-materialized inverted index: key -> entries at-or-below key
        self.postings: Dict[P.Path, RoaringBitmap] = {P.ROOT: RoaringBitmap()}
        # ALL live PathRef objects per key (see pe_online.py for why lists)
        self.refs: Dict[P.Path, List[PathRef]] = {}

    # ---------------------------------------------------------------- write
    def _ref(self, path: P.Path) -> PathRef:
        lst = self.refs.setdefault(path, [])
        if not lst:
            lst.append(PathRef(path))
        return lst[0]

    def _posting(self, path: P.Path) -> RoaringBitmap:
        posting = self.postings.get(path)
        if posting is None:
            posting = self.postings[path] = RoaringBitmap()
        return posting

    def mkdir(self, path: P.Path | str) -> None:
        self.aux.register(P.parse(path))

    def insert(self, entry_id: int, dir_path: P.Path | str) -> None:
        path = P.parse(dir_path)
        self.aux.register(path)
        # path expander: exact parent -> full ancestor sequence; one posting
        # update per ancestor (the t-fold ingestion amplification of Table I)
        with self._agg_latch:
            for pref in P.ancestors(path, include_self=True):
                self._posting(pref).add(entry_id)
            self._bump_epoch()
        self.catalog.bind(entry_id, self._ref(path))

    def bulk_insert(self, entry_ids, dir_paths) -> None:
        import numpy as np
        groups = {}
        for eid, path in zip(entry_ids, dir_paths):
            groups.setdefault(P.parse(path), []).append(eid)
        for path, ids in groups.items():
            self.aux.register(path)
            arr = np.asarray(ids, np.uint32)
            with self._agg_latch:
                for pref in P.ancestors(path, include_self=True):
                    self._posting(pref).add_many(arr)
            ref = self._ref(path)
            self.catalog.bind_many(ids, ref)
        with self._agg_latch:
            self._bump_epoch()

    def delete(self, entry_id: int) -> None:
        ref = self.catalog.get(entry_id)
        if ref is None:
            raise KeyError(entry_id)
        with self._agg_latch:
            for pref in P.ancestors(ref.path, include_self=True):
                posting = self.postings.get(pref)
                if posting is not None:
                    posting.remove(entry_id)
            self._bump_epoch()
        self.catalog.unbind(entry_id)

    # ----------------------------------------------------------------- read
    def resolve(self, path: P.Path | str, recursive: bool = True,
                stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        path = P.parse(path)
        if recursive:
            t0 = time.perf_counter_ns()
            with self._agg_latch:    # vs in-place posting writes
                posting = self.postings.get(path)
                out = posting.copy() if posting is not None else RoaringBitmap()
            if stats is not None:
                stats.posting_fetches += 1
                stats.stage_ns["bitmap_fetch"] = (
                    stats.stage_ns.get("bitmap_fetch", 0)
                    + time.perf_counter_ns() - t0)
            return out
        # non-recursive: Set_total \ union(direct child subtree postings)
        t0 = time.perf_counter_ns()
        total = self.postings.get(path)
        if total is None:
            return RoaringBitmap()
        child_names = self.aux.children(path)
        t1 = time.perf_counter_ns()
        children = RoaringBitmap()
        fetches = 1
        with self._agg_latch:
            for name in child_names:
                cp = self.postings.get(path + (name,))
                if cp is not None:
                    children |= cp
                    fetches += 1
            out = total - children
        t2 = time.perf_counter_ns()
        if stats is not None:
            stats.posting_fetches += fetches
            stats.set_ops += len(child_names) + 1
            stats.stage_ns["bitmap_fetch"] = (
                stats.stage_ns.get("bitmap_fetch", 0) + t1 - t0)
            stats.stage_ns["bitmap_compute"] = (
                stats.stage_ns.get("bitmap_compute", 0) + t2 - t1)
        return out

    # ------------------------------------------------------------------ DSM
    def move(self, src: P.Path | str, new_parent: P.Path | str,
             stats: Optional[DSMStats] = None) -> None:
        src = P.parse(src)
        new_parent = P.parse(new_parent)
        if not src:
            raise ValueError("cannot move root")
        if src not in self.aux:
            raise KeyError(P.to_str(src))
        if P.is_ancestor(src, new_parent):
            raise ValueError("cannot move a subtree into itself")
        dst = new_parent + (src[-1],)
        if dst in self.aux:
            raise ValueError(f"target {P.to_str(dst)} exists; use merge()")
        agg = self.postings.get(src, RoaringBitmap())
        # step 1: O(m_u) subtree path-key remapping — every re-keyed posting
        # is ancestor-materialized, so each subtree entry is re-filed once
        # per subtree level below it (the t-fold amplification of Table II)
        old_keys = self.aux.rekey_subtree(src, dst)
        for old in old_keys:
            new = P.replace_prefix(old, src, dst)
            if old in self.postings:
                posting = self.postings[new] = self.postings.pop(old)
                if stats is not None:
                    stats.postings_touched += 1
                    stats.ids_rewritten += len(posting)
            for ref in self.refs.pop(old, []):
                ref.path = new
                self.refs.setdefault(new, []).append(ref)
        # step 2: O(t) ancestor-membership updates outside the subtree
        old_only, new_only = _ancestor_split(src, dst)
        with self._agg_latch:
            for anc in old_only:
                posting = self.postings.get(anc)
                if posting is not None:
                    posting -= agg
            for anc in new_only:
                posting = self._posting(anc)
                posting |= agg
            # root of the common chain needs no change (holds S before+after)
            self._bump_epoch()
        if stats is not None:
            stats.ops += 1
            stats.keys_rekeyed += len(old_keys)
            stats.postings_touched += len(old_only) + len(new_only)
            stats.agg_bits_updated += len(agg) * (len(old_only) + len(new_only))
            stats.epochs_bumped += 1

    def merge(self, src: P.Path | str, dst: P.Path | str,
              stats: Optional[DSMStats] = None) -> None:
        src = P.parse(src)
        dst = P.parse(dst)
        if not src or not dst:
            raise ValueError("cannot merge the root directory")
        if src not in self.aux:
            raise KeyError(P.to_str(src))
        if dst not in self.aux:
            raise KeyError(P.to_str(dst))
        P.validate_disjoint(src, dst)
        with self._agg_latch:
            agg = self.postings.get(src, RoaringBitmap()).copy()
        # source-target key processing, deepest-first (O(m_u) + conflict unions)
        src_keys = sorted(self.aux.subtree_keys(src), key=len, reverse=True)
        for old in src_keys:
            new = P.replace_prefix(old, src, dst)
            posting = self.postings.pop(old, None)
            if posting is not None:
                if stats is not None:
                    stats.postings_touched += 1
                    stats.ids_rewritten += len(posting)
                tgt = self.postings.get(new)
                if tgt is None:
                    self.postings[new] = posting
                else:
                    with self._agg_latch:
                        tgt |= posting
            for ref in self.refs.pop(old, []):
                ref.path = new
                self.refs.setdefault(new, []).append(ref)
        self.aux.rekey_subtree(src, dst)
        # ancestor-membership updates: remove S from old-only proper ancestors
        # of src; add S to new-only proper ancestors of dst. dst itself was
        # updated by the src->dst root key merge above.
        old_only, new_only = _ancestor_split(src, dst)
        with self._agg_latch:
            for anc in old_only:
                posting = self.postings.get(anc)
                if posting is not None:
                    posting -= agg
            for anc in new_only:
                posting = self._posting(anc)
                posting |= agg
            self._bump_epoch()
        if stats is not None:
            stats.ops += 1
            stats.keys_rekeyed += len(src_keys)
            stats.postings_touched += len(old_only) + len(new_only)
            stats.agg_bits_updated += len(agg) * (len(old_only) + len(new_only))
            stats.epochs_bumped += 1

    def remove(self, path: P.Path | str,
               stats: Optional[DSMStats] = None) -> RoaringBitmap:
        """Recursive subtree removal: drop every materialized subtree
        posting (each entry re-filed out once per level — the same t-fold
        write amplification the move path pays), then subtract S from the
        surviving proper ancestors."""
        p = P.parse(path)
        if not p:
            raise ValueError("cannot remove root")
        if p not in self.aux:
            raise KeyError(P.to_str(p))
        with self._agg_latch:
            removed = self.postings.get(p, RoaringBitmap()).copy()
        keys = self.aux.remove_subtree(p)
        for key in keys:
            posting = self.postings.pop(key, None)
            if posting is not None and stats is not None:
                stats.postings_touched += 1
                stats.ids_rewritten += len(posting)
            self.refs.pop(key, None)
        ancestors = list(P.ancestors(p, include_self=False))
        with self._agg_latch:
            for anc in ancestors:
                posting = self.postings.get(anc)
                if posting is not None:
                    posting -= removed
            self._bump_epoch()
        for eid in removed.to_array():
            self.catalog.unbind(int(eid))
        if stats is not None:
            stats.ops += 1
            stats.dirs_removed += len(keys)
            stats.postings_touched += len(ancestors)
            stats.agg_bits_updated += len(removed) * len(ancestors)
            stats.entries_unbound += len(removed)
            stats.epochs_bumped += 1
        return removed

    # -------------------------------------------------------------- remap
    def remap_ids(self, mapping) -> None:
        with self._agg_latch:
            for k in list(self.postings):
                self.postings[k] = self._remap_bitmap(self.postings[k],
                                                      mapping)
        self.catalog.remap_ids(mapping)

    # ------------------------------------------------------------ inspection
    def has_dir(self, path: P.Path | str) -> bool:
        return P.parse(path) in self.aux

    def list_dirs(self) -> List[P.Path]:
        return list(self.aux.all_keys())

    def memory_bytes(self) -> int:
        total = self.aux.memory_bytes()
        for k, v in self.postings.items():
            total += v.memory_bytes() + sum(len(s) + 49 for s in k) + 80
        total += 56 * sum(len(v) for v in self.refs.values())
        return total

    def _ref_path(self, ref: object) -> P.Path:
        return ref.path  # type: ignore[attr-defined]

    def check_invariants(self) -> None:
        # rebuild expected ancestor materialization from the catalog
        expected: Dict[P.Path, set] = {}
        for eid, ref in self.catalog.items():
            for pref in P.ancestors(ref.path, include_self=True):
                expected.setdefault(pref, set()).add(eid)
        for key, posting in self.postings.items():
            got = set(int(x) for x in posting.to_array())
            want = expected.get(key, set())
            assert got == want, (
                f"ancestor posting mismatch at {P.to_str(key)}: "
                f"{len(got)} got vs {len(want)} want")
        for key, want in expected.items():
            assert key in self.postings, f"missing posting {P.to_str(key)}"
