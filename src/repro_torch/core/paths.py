"""Canonical path algebra for directory-semantic operations.

A directory path is represented internally as a tuple of segments:
``"/HR/Policies/"`` -> ``("HR", "Policies")``; the root ``"/"`` is ``()``.
Tuples are hashable (dict keys for posting lists), cheap to slice
(ancestor enumeration), and unambiguous w.r.t. trailing slashes.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

Path = Tuple[str, ...]

ROOT: Path = ()


def parse(path: str | Path) -> Path:
    """Normalize a path string (or already-parsed tuple) to a segment tuple."""
    if isinstance(path, tuple):
        return path
    if not isinstance(path, str):
        raise TypeError(f"path must be str or tuple, got {type(path)!r}")
    segs = [s for s in path.split("/") if s]
    for s in segs:
        if s in (".", ".."):
            raise ValueError(f"relative segment {s!r} not allowed in {path!r}")
    return tuple(segs)


def to_str(path: Path) -> str:
    """Render a segment tuple back to a canonical ``/a/b/`` string."""
    if not path:
        return "/"
    return "/" + "/".join(path) + "/"


def depth(path: Path) -> int:
    return len(path)


def parent(path: Path) -> Path:
    if not path:
        raise ValueError("root has no parent")
    return path[:-1]


def name(path: Path) -> str:
    if not path:
        raise ValueError("root has no name")
    return path[-1]


def join(base: Path, *segs: str) -> Path:
    return base + tuple(segs)


def is_ancestor(anc: Path, path: Path, proper: bool = False) -> bool:
    """True if ``anc`` is an (optionally proper) ancestor-or-self of ``path``."""
    if len(anc) > len(path):
        return False
    if proper and len(anc) == len(path):
        return False
    return path[: len(anc)] == anc


def ancestors(path: Path, include_self: bool = True, include_root: bool = True) -> Iterator[Path]:
    """Yield ancestor prefixes from root to ``path``."""
    start = 0 if include_root else 1
    stop = len(path) + (1 if include_self else 0)
    for i in range(start, stop):
        yield path[:i]


def replace_prefix(path: Path, old: Path, new: Path) -> Path:
    if path[: len(old)] != old:
        raise ValueError(f"{to_str(path)} does not start with {to_str(old)}")
    return new + path[len(old):]


def common_prefix(a: Path, b: Path) -> Path:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return a[:n]


def validate_disjoint(a: Path, b: Path) -> None:
    """Raise if one path is an ancestor-or-self of the other (DSM safety)."""
    if is_ancestor(a, b) or is_ancestor(b, a):
        raise ValueError(
            f"paths {to_str(a)} and {to_str(b)} overlap; "
            "subtree operations require disjoint source/target"
        )


def sort_key(path: Path) -> Tuple[str, ...]:
    return path


def relative(path: Path, base: Path) -> Path:
    if not is_ancestor(base, path):
        raise ValueError(f"{to_str(path)} not under {to_str(base)}")
    return path[len(base):]
