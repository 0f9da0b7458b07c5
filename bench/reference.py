"""The plain reference: directory scopes by path prefix and exact ranking.

Plain PyTorch and numpy; it imports nothing of the program. It rebuilds
every scope from the generated paths: a directory belongs to the recursive
scope of anchor ``A`` when its canonical path starts with ``A`` (the
non-recursive scope: equals ``A``), and an entry belongs to its
directory's scopes. DSM ops rewrite path prefixes:

* MOVE(src, new_parent): every directory under ``src`` (itself included)
  becomes ``new_parent + name(src) + rest``;
* MERGE(src, dst): every directory under ``src`` becomes ``dst + rest``
  (same-named children merge because their paths become equal).

``DirState`` keeps the directories sorted by path, so a recursive scope is
one contiguous range found by bisection and an op moves one contiguous
block. Ranking is exact fp32 (TF32 off) over blocks of rows; the int8
plan's reference quantises rows and queries per row (scale = max|x| / 127,
codes rint(x / scale)), ranks by the exact integer dot times the two scales
and rescores the survivors in exact fp32.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROW_BLOCK = 1 << 19
QUERY_BLOCK = 64
_END = "\U0010ffff"


def _under(path: str, prefix: str) -> bool:
    return path.startswith(prefix)


class DirState:
    """Directories sorted by canonical path, with each directory's entry
    count. ``order[i]`` is the directory id at sorted position i."""

    def __init__(self, paths: Sequence[str], counts: np.ndarray):
        order = sorted(range(len(paths)), key=paths.__getitem__)
        self.paths: List[str] = [paths[i] for i in order]
        self.order: List[int] = order
        self.counts = np.asarray(counts, np.int64)
        self._cum: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None

    def copy(self) -> "DirState":
        out = DirState.__new__(DirState)
        out.paths = list(self.paths)
        out.order = list(self.order)
        out.counts = self.counts
        out._cum = self._cum
        out._order = self._order
        return out

    # ---------------------------------------------------------------- read
    def span(self, anchor: str, recursive: bool = True) -> Tuple[int, int]:
        """[lo, hi) of the sorted positions in the scope of ``anchor``."""
        lo = bisect.bisect_left(self.paths, anchor)
        hi = bisect.bisect_left(self.paths, anchor + _END if recursive
                                else anchor + "\0")
        return lo, hi

    def exists(self, path: str) -> bool:
        lo, hi = self.span(path, False)
        return hi > lo

    def dirs_in(self, spans: Sequence[Tuple[int, int]]) -> np.ndarray:
        """Directory ids covered by the union of ``spans``."""
        if self._order is None:
            self._order = np.asarray(self.order, np.int64)
        parts = [self._order[lo:hi] for lo, hi in _union(spans)]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def _cumulative(self) -> np.ndarray:
        if self._cum is None:
            per = self.counts[np.asarray(self.order, np.int64)]
            self._cum = np.concatenate([[0], np.cumsum(per)])
        return self._cum

    def rows_in(self, spans: Sequence[Tuple[int, int]]) -> int:
        """Entries in the union of ``spans``."""
        cum = self._cumulative()
        return int(sum(cum[hi] - cum[lo] for lo, hi in _union(spans)))

    # ----------------------------------------------------------------- DSM
    def valid(self, kind: str, src: str, dst: str) -> bool:
        """Whether the op applies to this state; the port's index rejects
        the rest (a missing source or target, the root as source, or as a
        merge's target, one side inside the other, a moved name that
        exists at the target)."""
        if src == "/" or not self.exists(src) or not self.exists(dst):
            return False
        if _under(dst, src) or _under(src, dst):
            return False
        if kind == "move":
            return not self.exists(dst + _name(src))
        return dst != "/"

    def apply(self, kind: str, src: str, dst: str) -> None:
        lo, hi = self.span(src)
        new_prefix = dst + _name(src) if kind == "move" else dst
        block = [(new_prefix + p[len(src):], d)
                 for p, d in zip(self.paths[lo:hi], self.order[lo:hi])]
        del self.paths[lo:hi]
        del self.order[lo:hi]
        # the renamed block keeps its order; merge it into what is there
        a, b = self.span(new_prefix)
        merged = sorted(list(zip(self.paths[a:b], self.order[a:b])) + block)
        self.paths[a:b] = [p for p, _ in merged]
        self.order[a:b] = [d for _, d in merged]
        self._cum = None
        self._order = None


def _name(path: str) -> str:
    return path[path.rstrip("/").rindex("/") + 1:]


def _union(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(s for s in spans if s[1] > s[0]):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


# ------------------------------------------------------------------ ranking
def quantize(torch, x):
    """Per-row symmetric int8 codes (as fp32 integers) and fp32 scales."""
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return codes, scale


def quantize4(torch, x):
    """The int4 control's codes: scale = max|x| / 7, codes in [-7, 7]."""
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale[:, None]), -7, 7)
    return codes, scale


class Ranker:
    """Masked top-k over the rows (a host array, uploaded once, or a
    device tensor), in blocks on ``device``.

    ``plan`` is ``"fp32"`` (exact fp32 scores), ``"int8"`` (top-``window``
    by the int8 score, then exact fp32 rescore) or, for controls,
    ``"tf32"`` and ``"int4"``."""

    def __init__(self, torch, rows: np.ndarray, entry_dir: np.ndarray,
                 device, plan: str = "fp32", window: int = 40):
        self.torch = torch
        self.rows = (rows if isinstance(rows, torch.Tensor)
                     else torch.from_numpy(rows).to(device))
        self.entry_dir = (entry_dir if isinstance(entry_dir, torch.Tensor)
                          else torch.from_numpy(np.asarray(
                              entry_dir, np.int64)).to(device))
        self.device = device
        self.plan = plan
        self.window = window

    def _scores(self, x, q, qcodes, qscale):
        torch = self.torch
        if self.plan in ("fp32", "tf32"):
            return x @ q.T
        quant = quantize if self.plan == "int8" else quantize4
        codes, scale = quant(torch, x)
        dot = codes @ qcodes.T           # exact: |dot| <= d * 127^2 < 2^24
        return dot * (qscale[None, :] * scale[:, None])

    def topk(self, queries: np.ndarray, dir_masks: np.ndarray, k: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, k) ids (-1 padded) and their exact fp32 scores (-inf
        padded): the top-k of each query over the rows whose directory
        ``dir_masks[b]`` admits, by this ranker's plan."""
        torch = self.torch
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.plan == "tf32"
        try:
            B = queries.shape[0]
            ids = np.full((B, k), -1, np.int64)
            scores = np.full((B, k), -np.inf, np.float32)
            for lo in range(0, B, QUERY_BLOCK):
                hi = min(lo + QUERY_BLOCK, B)
                i, s = self._block(queries[lo:hi], dir_masks[lo:hi], k)
                ids[lo:hi], scores[lo:hi] = i, s
            return ids, scores
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _block(self, queries, dir_masks, k):
        torch = self.torch
        dev = self.device
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
        dm = torch.from_numpy(np.ascontiguousarray(dir_masks)).to(dev)
        keep = k if self.plan in ("fp32", "tf32") else self.window
        qcodes = qscale = None
        if self.plan == "int8":
            qcodes, qscale = quantize(torch, q)
        elif self.plan == "int4":
            qcodes, qscale = quantize4(torch, q)
        B = q.shape[0]
        best_s = torch.full((B, 0), float("-inf"), device=dev)
        best_i = torch.full((B, 0), -1, dtype=torch.int64, device=dev)
        n = self.rows.shape[0]
        for lo in range(0, n, ROW_BLOCK):
            hi = min(lo + ROW_BLOCK, n)
            x = self.rows[lo:hi]
            s = self._scores(x, q, qcodes, qscale).T          # (B, rows)
            adm = dm[:, self.entry_dir[lo:hi]]
            s = torch.where(adm, s, torch.full_like(s, float("-inf")))
            kk = min(keep, hi - lo)
            top_s, top_i = torch.topk(s, kk, dim=1)
            top_i = torch.where(torch.isfinite(top_s), top_i + lo,
                                torch.full_like(top_i, -1))
            cat_s = torch.cat([best_s, top_s], 1)
            cat_i = torch.cat([best_i, top_i], 1)
            # ties go to the lower row id, as a stable ranking would
            key_i = torch.where(cat_i < 0, torch.full_like(cat_i, n), cat_i)
            order = torch.argsort(key_i, dim=1)
            cat_s = cat_s.gather(1, order)
            cat_i = cat_i.gather(1, order)
            sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
            take = sel.indices[:, :min(keep, cat_s.shape[1])]
            best_s = cat_s.gather(1, take)
            best_i = cat_i.gather(1, take)
        if self.plan in ("int8", "int4"):
            best_i, best_s = self._rescore(q, best_i, k)
        ids = best_i[:, :k].cpu().numpy()
        scores = best_s[:, :k].cpu().numpy()
        scores[ids < 0] = -np.inf
        out_i = np.full((B, k), -1, np.int64)
        out_s = np.full((B, k), -np.inf, np.float32)
        out_i[:, :ids.shape[1]] = ids
        out_s[:, :scores.shape[1]] = scores
        return out_i, out_s

    def _rescore(self, q, cand, k):
        torch = self.torch
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            s = self.exact(q, cand)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        sel = torch.sort(s, dim=1, descending=True, stable=True)
        take = sel.indices[:, :k]
        return cand.gather(1, take), s.gather(1, take)

    def exact(self, q, ids):
        """Exact fp32 scores of rows ``ids`` (B, m; -1 = none) for
        queries ``q`` (B, d), both tensors on the device; -inf at -1."""
        torch = self.torch
        x = self.rows.index_select(0, ids.clamp(min=0).reshape(-1))
        x = x.reshape(ids.shape[0], ids.shape[1], -1).double()
        s = torch.einsum("bmd,bd->bm", x, q.double()).float()
        return torch.where(ids >= 0, s, torch.full_like(s, float("-inf")))

    def scores_of(self, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Exact fp32 scores of ``ids`` (B, k; -1 = none) for ``queries``
        (B, d), -inf at -1: the number each returned score is held to."""
        torch = self.torch
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
        i = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        return self.exact(q, i).cpu().numpy()


def scope_rows(entry_dir: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Entry ids whose directory is in ``dirs`` (sorted)."""
    m = np.zeros(int(entry_dir.max()) + 1 if len(entry_dir) else 0, bool)
    m[dirs[dirs < len(m)]] = True
    return np.flatnonzero(m[entry_dir])


def states_of(kinds: Sequence[Tuple[str, str, str]], base: DirState,
              wanted: Sequence[int]) -> Dict[int, DirState]:
    """The states after the first ``s`` ops, for every ``s`` in ``wanted``."""
    out: Dict[int, DirState] = {}
    cur = base.copy()
    want = sorted(set(wanted))
    applied = 0
    for s in want:
        while applied < s:
            cur.apply(*kinds[applied])
            applied += 1
        out[s] = cur.copy()
    return out
