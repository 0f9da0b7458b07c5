"""PE-ONLINE — query-time path expansion (§III-A).

Time-for-space design: ingestion records only the exact parent-path posting,
recursive DSQ enumerates the whole queried subtree (m_q keys) and unions the
posting lists at query time. DSM remaps path keys at the directory-key level.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from . import paths as P
from .auxdir import AuxDirectoryIndex
from .catalog import PathRef
from .idset import RoaringBitmap
from .interface import DSMStats, ResolveStats, ScopeIndex


class PEOnlineIndex(ScopeIndex):
    name = "pe_online"

    def __init__(self):
        super().__init__()
        self.aux = AuxDirectoryIndex()
        # parent-path inverted index: path key -> entries *directly* under it
        self.postings: Dict[P.Path, RoaringBitmap] = {}
        # ALL live PathRef objects per directory key (catalog targets).
        # A merge can leave several refs aliasing one key; every one of them
        # must follow later renames, so we track lists, not single refs.
        self.refs: Dict[P.Path, List[PathRef]] = {}

    # ---------------------------------------------------------------- write
    def _ref(self, path: P.Path) -> PathRef:
        lst = self.refs.setdefault(path, [])
        if not lst:
            lst.append(PathRef(path))
        return lst[0]

    def mkdir(self, path: P.Path | str) -> None:
        self.aux.register(P.parse(path))

    def insert(self, entry_id: int, dir_path: P.Path | str) -> None:
        path = P.parse(dir_path)
        self.aux.register(path)
        with self._agg_latch:
            posting = self.postings.get(path)
            if posting is None:
                posting = self.postings[path] = RoaringBitmap()
            posting.add(entry_id)
            self._bump_epoch()
        self.catalog.bind(entry_id, self._ref(path))

    def bulk_insert(self, entry_ids, dir_paths) -> None:
        import numpy as np
        groups = {}
        for eid, path in zip(entry_ids, dir_paths):
            groups.setdefault(P.parse(path), []).append(eid)
        for path, ids in groups.items():
            self.aux.register(path)
            with self._agg_latch:
                posting = self.postings.get(path)
                if posting is None:
                    posting = self.postings[path] = RoaringBitmap()
                posting.add_many(np.asarray(ids, np.uint32))
            ref = self._ref(path)
            self.catalog.bind_many(ids, ref)
        with self._agg_latch:
            self._bump_epoch()

    def delete(self, entry_id: int) -> None:
        ref = self.catalog.get(entry_id)
        if ref is None:
            raise KeyError(entry_id)
        with self._agg_latch:
            posting = self.postings.get(ref.path)
            if posting is not None:
                posting.remove(entry_id)
            self._bump_epoch()
        self.catalog.unbind(entry_id)

    # ----------------------------------------------------------------- read
    def resolve(self, path: P.Path | str, recursive: bool = True,
                stats: Optional[ResolveStats] = None) -> RoaringBitmap:
        path = P.parse(path)
        if not recursive:
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
        # recursive: enumerate subtree keys (m_q), fetch postings, union
        t0 = time.perf_counter_ns()
        keys = self.aux.subtree_keys(path)
        t1 = time.perf_counter_ns()
        out = RoaringBitmap()
        fetches = 0
        with self._agg_latch:
            for k in keys:
                posting = self.postings.get(k)
                if posting is not None:
                    out |= posting
                    fetches += 1
        t2 = time.perf_counter_ns()
        if stats is not None:
            stats.subpath_keys += len(keys)
            stats.posting_fetches += fetches
            stats.set_ops += fetches
            stats.stage_ns["subpath_obtain"] = (
                stats.stage_ns.get("subpath_obtain", 0) + t1 - t0)
            stats.stage_ns["bitmap_fetch"] = (
                stats.stage_ns.get("bitmap_fetch", 0) + t2 - t1)
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
        # O(m_u) path-key remapping: postings, refs, aux index
        old_keys = self.aux.rekey_subtree(src, dst)
        for old in old_keys:
            new = P.replace_prefix(old, src, dst)
            if old in self.postings:
                posting = self.postings[new] = self.postings.pop(old)
                if stats is not None:
                    stats.postings_touched += 1
                    stats.ids_rewritten += len(posting)
            for ref in self.refs.pop(old, []):
                ref.path = new          # shared refs: all bound entries follow
                self.refs.setdefault(new, []).append(ref)
        with self._agg_latch:
            self._bump_epoch()
        if stats is not None:
            stats.ops += 1
            stats.keys_rekeyed += len(old_keys)
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
        # enumerate all source keys, deepest-first so child keys clear first
        src_keys = sorted(self.aux.subtree_keys(src), key=len, reverse=True)
        for old in src_keys:
            new = P.replace_prefix(old, src, dst)
            # posting merge (union on conflict)
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
            # ref redirect: entries bound to the old key follow to the new
            # key; conflicting keys simply hold multiple aliased refs.
            for ref in self.refs.pop(old, []):
                ref.path = new
                self.refs.setdefault(new, []).append(ref)
        # aux re-key (union children maps on conflicts)
        self.aux.rekey_subtree(src, dst)
        with self._agg_latch:
            self._bump_epoch()
        if stats is not None:
            stats.ops += 1
            stats.keys_rekeyed += len(src_keys)
            stats.epochs_bumped += 1

    def remove(self, path: P.Path | str,
               stats: Optional[DSMStats] = None) -> RoaringBitmap:
        """Recursive subtree removal: enumerate and drop every subtree key's
        posting (O(m_u) keys, each entry re-filed out exactly once)."""
        p = P.parse(path)
        if not p:
            raise ValueError("cannot remove root")
        if p not in self.aux:
            raise KeyError(P.to_str(p))
        removed = RoaringBitmap()
        keys = self.aux.remove_subtree(p)
        with self._agg_latch:
            for key in keys:
                posting = self.postings.pop(key, None)
                if posting is not None:
                    removed |= posting
                    if stats is not None:
                        stats.postings_touched += 1
                        stats.ids_rewritten += len(posting)
                self.refs.pop(key, None)
        for eid in removed.to_array():
            self.catalog.unbind(int(eid))
        with self._agg_latch:
            self._bump_epoch()
        if stats is not None:
            stats.ops += 1
            stats.dirs_removed += len(keys)
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
        # every posting key must be a registered directory
        for k, posting in self.postings.items():
            assert k in self.aux, f"posting for unregistered dir {P.to_str(k)}"
        # catalog refs point at registered dirs and entries are in postings
        for eid, ref in self.catalog.items():
            path = ref.path
            assert path in self.aux, f"entry {eid} ref dir missing"
            assert eid in self.postings[path], f"entry {eid} missing from posting"
        # refs table consistent: every tracked ref agrees with its key
        for path, lst in self.refs.items():
            for ref in lst:
                assert ref.path == path, (ref.path, path)
