"""Entry -> directory catalog, common to every scope-index design.

The paper (§V-A Implementation Details): *"All methods maintain a common catalog
that maps each entry to its current directory representation, such as a path key
or a trie node, for maintenance. Because this catalog is required by every
design, we exclude it when comparing DSM latency and directory-module indexing
overhead."*

Key design point: the catalog stores a **shared, mutable directory reference**
(one object per directory), not a per-entry path string. A DSM operation that
renames `m_u` directories therefore updates `m_u` reference objects — never one
record per entry — keeping expansion-based MOVE at O(m_u) as analyzed in §III.
"""
from __future__ import annotations

from typing import Dict, Optional

from . import paths as P


class PathRef:
    """Shared mutable reference to a directory path (expansion designs)."""

    __slots__ = ("path",)

    def __init__(self, path: P.Path):
        self.path = path

    def current(self) -> P.Path:
        return self.path

    def __repr__(self) -> str:
        return f"PathRef({P.to_str(self.path)})"


class Catalog:
    """entry_id -> directory reference (PathRef or TrieNode)."""

    __slots__ = ("_map",)

    def __init__(self):
        self._map: Dict[int, object] = {}

    def bind(self, entry_id: int, ref: object) -> None:
        self._map[entry_id] = ref

    def bind_many(self, entry_ids, ref: object) -> None:
        """Bind a batch of entries to one shared directory reference (the bulk
        ingestion path; one dict update, no per-entry Python call)."""
        self._map.update((int(e), ref) for e in entry_ids)

    def unbind(self, entry_id: int) -> None:
        del self._map[entry_id]

    def get(self, entry_id: int) -> Optional[object]:
        return self._map.get(entry_id)

    def __contains__(self, entry_id: int) -> bool:
        return entry_id in self._map

    def __len__(self) -> int:
        return len(self._map)

    def items(self):
        return self._map.items()

    def remap_ids(self, mapping) -> None:
        """Rewrite entry ids under an order-preserving store compaction.
        ``mapping[old_id]`` is the new id, or a negative value for rows the
        compaction dropped (tombstones, which hold no binding anyway)."""
        self._map = {int(mapping[eid]): ref for eid, ref in self._map.items()
                     if 0 <= eid < len(mapping) and mapping[eid] >= 0}

    def memory_bytes(self) -> int:
        return 64 * len(self._map)  # dict-slot estimate; excluded from comparisons anyway
