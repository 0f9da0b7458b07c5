"""Roaring-style compressed entry-ID sets (numpy containers).

The paper represents candidate entry-ID sets with Roaring bitmaps [39] so that
scope resolution can union/intersect/difference compressed sets cheaply. This is
a faithful numpy reimplementation of the two-level Roaring layout:

* ids are unsigned 32-bit; the high 16 bits select a *container*,
* a container is either a sorted ``uint16`` array (sparse) or a 1024-word
  ``uint64`` bitmap (dense, fixed 8 KiB) — converted at ``ARRAY_MAX=4096``
  elements, exactly like CRoaring.

All bulk operations are vectorized numpy; per-container dispatch is Python.
``to_bool_mask``/``to_words`` export the set as a dense device-friendly mask for
the TPU-side scoped-scan executors (see DESIGN.md §3.2).
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np

ARRAY_MAX = 4096          # container converts array -> bitmap above this cardinality
_BM_WORDS = 1024          # 65536 bits / 64
_FULL_RANGE = 1 << 16

ArrayContainer = np.ndarray   # sorted unique uint16
BitmapContainer = np.ndarray  # uint64[1024]
Container = np.ndarray


def _is_bitmap(c: Container) -> bool:
    return c.dtype == np.uint64


def _arr_to_bm(arr: ArrayContainer) -> BitmapContainer:
    bm = np.zeros(_BM_WORDS, dtype=np.uint64)
    word = arr >> 6
    bit = (arr & 63).astype(np.uint64)
    np.bitwise_or.at(bm, word, np.uint64(1) << bit)
    return bm


def _bm_to_arr(bm: BitmapContainer) -> ArrayContainer:
    bits = np.unpackbits(bm.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint16)


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint16)


def _bm_card(bm: BitmapContainer) -> int:
    return int(_POPCNT8[bm.view(np.uint8)].sum())


def _container_card(c: Container) -> int:
    return _bm_card(c) if _is_bitmap(c) else len(c)


def _maybe_demote(c: Container) -> Container:
    """Convert bitmap back to array if it got sparse (keeps memory honest)."""
    if _is_bitmap(c):
        card = _bm_card(c)
        if card <= ARRAY_MAX:
            return _bm_to_arr(c)
    return c


def _union(a: Container, b: Container) -> Container:
    if _is_bitmap(a) or _is_bitmap(b):
        abm = a if _is_bitmap(a) else _arr_to_bm(a)
        bbm = b if _is_bitmap(b) else _arr_to_bm(b)
        return abm | bbm
    out = np.union1d(a, b)
    if len(out) > ARRAY_MAX:
        return _arr_to_bm(out.astype(np.uint16))
    return out.astype(np.uint16)


def _intersection(a: Container, b: Container) -> Optional[Container]:
    if _is_bitmap(a) and _is_bitmap(b):
        out = a & b
        out = _maybe_demote(out)
    elif _is_bitmap(a):
        mask = (a[b >> 6] >> (b & np.uint16(63)).astype(np.uint64)) & np.uint64(1)
        out = b[mask.astype(bool)]
    elif _is_bitmap(b):
        return _intersection(b, a)
    else:
        out = np.intersect1d(a, b).astype(np.uint16)
    if _container_card(out) == 0:
        return None
    return out


def _difference(a: Container, b: Container) -> Optional[Container]:
    if _is_bitmap(a) and _is_bitmap(b):
        out = a & ~b
        out = _maybe_demote(out)
    elif _is_bitmap(a):
        bm = a.copy()
        word = b >> 6
        bit = (b & np.uint16(63)).astype(np.uint64)
        np.bitwise_and.at(bm, word, ~(np.uint64(1) << bit))
        out = _maybe_demote(bm)
    elif _is_bitmap(b):
        mask = (b[a >> 6] >> (a & np.uint16(63)).astype(np.uint64)) & np.uint64(1)
        out = a[~mask.astype(bool)]
    else:
        out = np.setdiff1d(a, b, assume_unique=True).astype(np.uint16)
    if _container_card(out) == 0:
        return None
    return out


class RoaringBitmap:
    """A mutable set of uint32 ids with Roaring-style compressed storage."""

    __slots__ = ("_containers",)

    def __init__(self, ids: Optional[Iterable[int]] = None):
        self._containers: Dict[int, Container] = {}
        if ids is not None:
            self.add_many(np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids,
                                     dtype=np.uint32))

    # ------------------------------------------------------------- factory
    @classmethod
    def from_array(cls, ids: np.ndarray) -> "RoaringBitmap":
        rb = cls()
        rb.add_many(ids)
        return rb

    @classmethod
    def _from_containers(cls, containers: Dict[int, Container]) -> "RoaringBitmap":
        rb = cls()
        rb._containers = containers
        return rb

    def copy(self) -> "RoaringBitmap":
        return RoaringBitmap._from_containers(
            {hi: c.copy() for hi, c in self._containers.items()})

    # ----------------------------------------------------------- mutation
    def add(self, x: int) -> None:
        self.add_many(np.asarray([x], dtype=np.uint32))

    def add_many(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        ids = np.asarray(ids, dtype=np.uint32)
        his = ids >> 16
        lows = (ids & 0xFFFF).astype(np.uint16)
        order = np.argsort(his, kind="stable")
        his, lows = his[order], lows[order]
        bounds = np.nonzero(np.diff(his))[0] + 1
        for grp_lo, grp in zip(
            np.split(lows, bounds), np.split(his, bounds)
        ):
            hi = int(grp[0])
            new = np.unique(grp_lo)
            cur = self._containers.get(hi)
            if cur is None:
                self._containers[hi] = (
                    _arr_to_bm(new) if len(new) > ARRAY_MAX else new)
            else:
                self._containers[hi] = _union(cur, new)

    def remove(self, x: int) -> None:
        self.remove_many(np.asarray([x], dtype=np.uint32))

    def remove_many(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        ids = np.asarray(ids, dtype=np.uint32)
        his = ids >> 16
        lows = (ids & 0xFFFF).astype(np.uint16)
        for hi in np.unique(his):
            cur = self._containers.get(int(hi))
            if cur is None:
                continue
            out = _difference(cur, np.unique(lows[his == hi]))
            if out is None:
                del self._containers[int(hi)]
            else:
                self._containers[int(hi)] = out

    def clear(self) -> None:
        self._containers.clear()

    # ----------------------------------------------------------- queries
    def __contains__(self, x: int) -> bool:
        c = self._containers.get(int(x) >> 16)
        if c is None:
            return False
        low = int(x) & 0xFFFF
        if _is_bitmap(c):
            return bool((int(c[low >> 6]) >> (low & 63)) & 1)
        i = np.searchsorted(c, low)
        return i < len(c) and c[i] == low

    def __len__(self) -> int:
        return sum(_container_card(c) for c in self._containers.values())

    def __bool__(self) -> bool:
        return bool(self._containers)

    def __iter__(self) -> Iterator[int]:
        return iter(self.to_array())

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RoaringBitmap):
            return NotImplemented
        return np.array_equal(self.to_array(), other.to_array())

    def __hash__(self):  # mutable; identity hash like list/dict would forbid
        raise TypeError("RoaringBitmap is unhashable")

    def to_array(self) -> np.ndarray:
        """Sorted uint32 array of all members."""
        parts = []
        for hi in sorted(self._containers):
            c = self._containers[hi]
            lows = _bm_to_arr(c) if _is_bitmap(c) else c
            parts.append((np.uint32(hi) << np.uint32(16)) | lows.astype(np.uint32))
        if not parts:
            return np.empty(0, dtype=np.uint32)
        return np.concatenate(parts)

    # ------------------------------------------------------------ algebra
    def _binop(self, other: "RoaringBitmap", which: str) -> "RoaringBitmap":
        out: Dict[int, Container] = {}
        if which == "or":
            keys = set(self._containers) | set(other._containers)
            for hi in keys:
                a, b = self._containers.get(hi), other._containers.get(hi)
                if a is None:
                    out[hi] = b.copy()
                elif b is None:
                    out[hi] = a.copy()
                else:
                    out[hi] = _union(a, b)
        elif which == "and":
            for hi in set(self._containers) & set(other._containers):
                r = _intersection(self._containers[hi], other._containers[hi])
                if r is not None:
                    out[hi] = r
        elif which == "sub":
            for hi, a in self._containers.items():
                b = other._containers.get(hi)
                if b is None:
                    out[hi] = a.copy()
                else:
                    r = _difference(a, b)
                    if r is not None:
                        out[hi] = r
        else:  # pragma: no cover
            raise ValueError(which)
        return RoaringBitmap._from_containers(out)

    def __or__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        return self._binop(other, "or")

    def __and__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        return self._binop(other, "and")

    def __sub__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        return self._binop(other, "sub")

    def __ior__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        for hi, b in other._containers.items():
            a = self._containers.get(hi)
            self._containers[hi] = b.copy() if a is None else _union(a, b)
        return self

    def __isub__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        for hi, b in other._containers.items():
            a = self._containers.get(hi)
            if a is None:
                continue
            r = _difference(a, b)
            if r is None:
                del self._containers[hi]
            else:
                self._containers[hi] = r
        return self

    @staticmethod
    def union_many(sets: Iterable["RoaringBitmap"]) -> "RoaringBitmap":
        out = RoaringBitmap()
        for s in sets:
            out |= s
        return out

    # ----------------------------------------------------------- exports
    def to_bool_mask(self, n: int) -> np.ndarray:
        """Dense boolean mask of length n (ids >= n are dropped)."""
        bits = np.unpackbits(self.to_words(n).view(np.uint8),
                             bitorder="little")
        return bits[:n].astype(bool)

    def to_words(self, n: int) -> np.ndarray:
        """Packed little-endian uint32 words, ceil(n/32) long (device hand-off).

        Emitted directly from the containers: a bitmap container is already
        a run of 64-bit words (reinterpreted as little-endian uint32 pairs,
        2048 words per 65536-id container); an array container scatters its
        bits with one vectorized bitwise_or. Ids >= ceil(n/32)*32 are dropped
        (same tail semantics as the packbits roundtrip this replaces)."""
        n_words = (n + 31) // 32
        out = np.zeros(n_words, dtype=np.uint32)
        for hi, c in self._containers.items():
            w0 = hi << 11                 # 65536 bits / 32 words per container
            if w0 >= n_words:
                continue
            if _is_bitmap(c):
                src = c.view(np.uint32)
                end = min(w0 + 2 * _BM_WORDS, n_words)
                out[w0:end] = src[: end - w0]
            else:
                idx = w0 + (c >> 5).astype(np.int64)
                keep = idx < n_words
                lows = c[keep] if not keep.all() else c
                np.bitwise_or.at(
                    out, idx[keep] if not keep.all() else idx,
                    np.uint32(1) << (lows & np.uint16(31)).astype(np.uint32))
        return out

    @staticmethod
    def pack_words(bitmaps: Iterable["RoaringBitmap"], n: int) -> np.ndarray:
        """Stack several scopes into one packed-mask matrix
        (n_scopes, ceil(n/32)) uint32 — the multi-scope kernel's indirection
        target and the distributed search's per-shard hand-off format."""
        bms = list(bitmaps)
        out = np.zeros((len(bms), (n + 31) // 32), dtype=np.uint32)
        for i, bm in enumerate(bms):
            out[i] = bm.to_words(n)
        return out

    # --------------------------------------------------------------- misc
    def memory_bytes(self) -> int:
        """Approximate resident bytes (containers + keys)."""
        total = 0
        for c in self._containers.values():
            total += c.nbytes + 16
        return total + 64

    def stats(self) -> Dict[str, int]:
        n_bm = sum(1 for c in self._containers.values() if _is_bitmap(c))
        return {
            "containers": len(self._containers),
            "bitmap_containers": n_bm,
            "array_containers": len(self._containers) - n_bm,
            "cardinality": len(self),
            "bytes": self.memory_bytes(),
        }

    def __repr__(self) -> str:
        return f"RoaringBitmap(card={len(self)}, containers={len(self._containers)})"
