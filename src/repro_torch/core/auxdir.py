"""Auxiliary directory index for the path-expansion strategies (§III).

Stores all directory path *keys* and supports the two operations the paper
requires of it: prefix (subtree) enumeration and direct-child lookup. It is a
flat key->children adjacency over full path strings — deliberately *not* a trie
with node identity: a DSM rename must re-key every affected path, which is
exactly the expansion-based maintenance cost the paper analyzes.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Set

from . import paths as P


class AuxDirectoryIndex:
    __slots__ = ("_children",)

    def __init__(self):
        # path key -> set of immediate child segment names; root always present
        self._children: Dict[P.Path, Set[str]] = {P.ROOT: set()}

    def __contains__(self, path: P.Path) -> bool:
        return path in self._children

    def __len__(self) -> int:
        return len(self._children)

    def register(self, path: P.Path) -> int:
        """Ensure ``path`` and all ancestors exist; returns #keys created."""
        created = 0
        for pref in P.ancestors(path, include_self=True):
            if pref not in self._children:
                self._children[pref] = set()
                created += 1
            if pref:  # link into parent
                self._children[pref[:-1]].add(pref[-1])
        return created

    def children(self, path: P.Path) -> Set[str]:
        return self._children.get(path, set())

    def subtree_keys(self, path: P.Path) -> List[P.Path]:
        """Enumerate all directory keys at-or-below ``path`` (the m_q / m_u
        expansion of §III) via DFS over the adjacency."""
        if path not in self._children:
            return []
        out: List[P.Path] = []
        stack = [path]
        while stack:
            cur = stack.pop()
            out.append(cur)
            for name in self._children[cur]:
                stack.append(cur + (name,))
        return out

    def remove_key(self, path: P.Path) -> None:
        """Delete one key (must have no registered children left)."""
        if path == P.ROOT:
            raise ValueError("cannot remove root")
        kids = self._children.pop(path, None)
        if kids:
            raise ValueError(f"{P.to_str(path)} still has children {kids}")
        parent_kids = self._children.get(path[:-1])
        if parent_kids is not None:
            parent_kids.discard(path[-1])

    def remove_subtree(self, path: P.Path) -> List[P.Path]:
        """Drop every directory key at-or-below ``path`` and detach it from
        its parent; returns the removed keys (the O(m_u) REMOVE expansion)."""
        if path == P.ROOT:
            raise ValueError("cannot remove root")
        keys = self.subtree_keys(path)
        for key in keys:
            self._children.pop(key, None)
        parent_kids = self._children.get(path[:-1])
        if parent_kids is not None:
            parent_kids.discard(path[-1])
        return keys

    def rekey_subtree(self, src: P.Path, dst: P.Path) -> List[P.Path]:
        """Re-key every directory under ``src`` to live under ``dst``
        (prefix substitution). Returns the list of OLD subtree keys, deepest
        last. This is the O(m_u) path-key remapping of §III DSM."""
        old_keys = self.subtree_keys(src)
        # detach src from its parent
        self._children[src[:-1]].discard(src[-1])
        for old in old_keys:
            new = P.replace_prefix(old, src, dst)
            kids = self._children.pop(old)
            if new in self._children:
                self._children[new] |= kids
            else:
                self._children[new] = kids
        # attach dst under its parent chain
        self.register(dst)
        return old_keys

    def all_keys(self) -> Iterator[P.Path]:
        return iter(self._children.keys())

    def memory_bytes(self) -> int:
        total = 0
        for k, kids in self._children.items():
            total += 80 + sum(len(s) + 49 for s in k)
            total += 64 + sum(len(s) + 49 for s in kids)
        return total
