"""Synthetic directory-structured dataset twins of WIKI-Dir / ARXIV-Dir.

The paper's datasets are released on GitHub; this container is offline, so we
generate synthetic twins that match the *published structural statistics*:

* WIKI-Dir : 363,467 directories, average depth 11.95, 1.94 M entries,
  1024-d embeddings, 456 scoped queries, 1,000 MOVE + 1,000 MERGE ops.
* ARXIV-Dir: two independent namespaces — subject (168 dirs, avg depth 2.19)
  and temporal (432 dirs, avg depth 1.92) — 2.76 M entries, 1,000 queries.

A ``scale`` factor shrinks entry/directory counts for CI while preserving the
depth distribution and entry-per-directory skew (Zipf). Vectors come from a
Gaussian-mixture aligned with top-level branches, so directory scopes carry
real retrieval signal (Fig. 11's "quality improves with depth" reproduces).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import paths as P


@dataclass
class DirDataset:
    name: str
    dirs: List[P.Path]                       # all directory paths
    entry_paths: List[str]                   # per-entry directory (strings)
    vectors: np.ndarray                      # (n, d) float32
    queries: np.ndarray                      # (q, d) float32
    query_anchors: List[str]                 # per-query directory constraint
    query_recursive: np.ndarray              # (q,) bool
    moves: List[Tuple[str, str]] = field(default_factory=list)   # (src, new_parent)
    merges: List[Tuple[str, str]] = field(default_factory=list)  # (src, dst)
    extra_namespaces: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def n_entries(self) -> int:
        return len(self.entry_paths)

    @property
    def avg_depth(self) -> float:
        return float(np.mean([len(d) for d in self.dirs if d])) if self.dirs else 0.0


def _build_tree(rng: np.random.Generator, n_dirs: int, avg_depth: float,
                depth_sd: float = 3.0, prefix: str = "d") -> List[P.Path]:
    """Random tree with a controlled depth profile: each new directory attaches
    to a parent sampled at the target depth-1, falling back to the deepest
    available level. Produces realistic heavy-tailed fanout."""
    by_depth: Dict[int, List[P.Path]] = {0: [P.ROOT]}
    dirs: List[P.Path] = [P.ROOT]
    counter = 0
    for _ in range(n_dirs):
        target = int(np.clip(round(rng.normal(avg_depth, depth_sd)), 1, None))
        pd = target - 1
        while pd > 0 and pd not in by_depth:
            pd -= 1
        parents = by_depth[pd]
        # prefer recently-created parents -> chains form, depth grows
        j = len(parents) - 1 - int(rng.integers(0, min(len(parents), 8)))
        parent = parents[j]
        counter += 1
        child = parent + (f"{prefix}{counter}",)
        dirs.append(child)
        by_depth.setdefault(len(child), []).append(child)
    return dirs


def _zipf_assign(rng: np.random.Generator, n_entries: int,
                 dirs: Sequence[P.Path], a: float = 1.3) -> np.ndarray:
    """Assign entries to directories with Zipf-skewed popularity."""
    ranks = rng.permutation(len(dirs))
    weights = 1.0 / np.power(ranks + 1.0, a)
    weights /= weights.sum()
    return rng.choice(len(dirs), size=n_entries, p=weights)


def _anchor_sampler(rng: np.random.Generator, assign: np.ndarray,
                    anchor_zipf: float):
    """Per-query entry sampler implementing the hot/cold directory-skew
    knob. ``anchor_zipf == 0`` keeps the original uniform-over-entries
    draw; ``> 0`` draws the query's anchor *directory* Zipf-weighted (a few
    hot directories absorb most of the query traffic — the access pattern
    tiered storage exploits by pinning hot scopes' fp32 rows on device),
    then a uniform entry within it."""
    n_entries = len(assign)
    if anchor_zipf <= 0:
        return lambda: int(rng.integers(n_entries))
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    occupied = np.unique(sorted_assign)
    ranks = rng.permutation(len(occupied))
    w = 1.0 / np.power(ranks + 1.0, anchor_zipf)
    w /= w.sum()

    def draw() -> int:
        d = occupied[rng.choice(len(occupied), p=w)]
        lo = np.searchsorted(sorted_assign, d)
        hi = np.searchsorted(sorted_assign, d, side="right")
        return int(order[rng.integers(lo, hi)])
    return draw


def _mixture_vectors(rng: np.random.Generator, entry_dirs: Sequence[P.Path],
                     dim: int, noise: float = 0.35
                     ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Unit-norm vectors clustered per top-level branch (plus a depth drift so
    deeper scopes are tighter clusters)."""
    centers: Dict[str, np.ndarray] = {}
    rows = np.empty((len(entry_dirs), dim), dtype=np.float32)
    for i, d in enumerate(entry_dirs):
        top = d[0] if d else ""
        c = centers.get(top)
        if c is None:
            c = rng.normal(size=dim).astype(np.float32)
            c /= np.linalg.norm(c)
            centers[top] = c
        v = c + noise * rng.normal(size=dim).astype(np.float32)
        v /= np.linalg.norm(v)
        rows[i] = v
    return rows, centers


def _sample_dsm_ops(rng: np.random.Generator, dirs: List[P.Path],
                    n_moves: int, n_merges: int
                    ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """Sample disjoint (src, dst) pairs, stratified by source depth: half the
    workload picks shallow sources (large subtrees, large m_u — where the
    paper\'s expansion-vs-trie maintenance gap shows), half uniform (small
    subtrees). Templates only: benchmarks re-validate against the live tree.
    """
    non_root = [d for d in dirs if d]
    shallow = [d for d in non_root if len(d) <= 3] or non_root

    def sample(pool_src, n, dst_pool):
        out, tries = [], 0
        while len(out) < n and tries < 50 * n:
            tries += 1
            src = pool_src[rng.integers(len(pool_src))]
            dst = dst_pool[rng.integers(len(dst_pool))]
            if P.is_ancestor(src, dst) or P.is_ancestor(dst, src):
                continue
            out.append((P.to_str(src), P.to_str(dst)))
        return out

    moves = (sample(shallow, n_moves // 2, dirs)
             + sample(non_root, n_moves - n_moves // 2, dirs))
    merges = (sample(shallow, n_merges // 2, non_root)
              + sample(non_root, n_merges - n_merges // 2, non_root))
    return moves, merges


def make_wiki_dir(scale: float = 0.01, dim: int = 128, n_queries: int = 64,
                  seed: int = 0, anchor_zipf: float = 0.0) -> DirDataset:
    """WIKI-Dir twin. scale=1.0 reproduces the published sizes
    (363,467 dirs / 1.94 M entries); default scale fits CI.
    ``anchor_zipf > 0`` Zipf-skews which directories the queries anchor in
    (hot/cold scope access; see :func:`_anchor_sampler`)."""
    rng = np.random.default_rng(seed)
    n_dirs = max(50, int(363_467 * scale))
    n_entries = max(200, int(1_940_000 * scale))
    dirs = _build_tree(rng, n_dirs, avg_depth=11.95, depth_sd=4.0, prefix="w")
    assign = _zipf_assign(rng, n_entries, dirs)
    entry_dirs = [dirs[i] for i in assign]
    vectors, _ = _mixture_vectors(rng, entry_dirs, dim)
    draw = _anchor_sampler(rng, assign, anchor_zipf)
    # queries anchored at ancestors of real entries, at varying depths
    anchors, recursive, qvecs = [], [], []
    for _ in range(n_queries):
        ei = draw()
        path = entry_dirs[ei]
        depth = int(rng.integers(0, len(path) + 1))
        anchors.append(P.to_str(path[:depth]))
        recursive.append(bool(rng.random() < 0.8))
        q = vectors[ei] + 0.3 * rng.normal(size=dim).astype(np.float32)
        qvecs.append(q / np.linalg.norm(q))
    n_ops = max(10, int(1000 * np.sqrt(scale)))
    moves, merges = _sample_dsm_ops(rng, dirs, n_ops, n_ops)
    return DirDataset(
        name="wiki-dir", dirs=dirs,
        entry_paths=[P.to_str(d) for d in entry_dirs],
        vectors=vectors, queries=np.asarray(qvecs, dtype=np.float32),
        query_anchors=anchors, query_recursive=np.asarray(recursive),
        moves=moves, merges=merges)


def make_arxiv_dir(scale: float = 0.01, dim: int = 128, n_queries: int = 64,
                   seed: int = 1, anchor_zipf: float = 0.0) -> DirDataset:
    """ARXIV-Dir twin: primary namespace = subject tree (shallow, 168 dirs at
    scale 1), extra namespace "time" = temporal tree (432 dirs).
    ``anchor_zipf``: hot/cold query-anchor skew, as in
    :func:`make_wiki_dir`."""
    rng = np.random.default_rng(seed)
    n_subject = max(20, int(168 * max(scale, 0.25)))
    n_time = max(24, int(432 * max(scale, 0.25)))
    n_entries = max(200, int(2_760_000 * scale))
    subject = _build_tree(rng, n_subject, avg_depth=2.19, depth_sd=0.7,
                          prefix="s")
    temporal = _build_tree(rng, n_time, avg_depth=1.92, depth_sd=0.5,
                           prefix="t")
    s_assign = _zipf_assign(rng, n_entries, subject, a=1.1)
    t_assign = _zipf_assign(rng, n_entries, temporal, a=1.05)
    entry_subject = [subject[i] for i in s_assign]
    entry_time = [temporal[i] for i in t_assign]
    vectors, _ = _mixture_vectors(rng, entry_subject, dim)
    draw = _anchor_sampler(rng, s_assign, anchor_zipf)
    anchors, recursive, qvecs = [], [], []
    for _ in range(n_queries):
        ei = draw()
        path = entry_subject[ei]
        depth = int(rng.integers(0, len(path) + 1))
        anchors.append(P.to_str(path[:depth]))
        recursive.append(bool(rng.random() < 0.8))
        q = vectors[ei] + 0.3 * rng.normal(size=dim).astype(np.float32)
        qvecs.append(q / np.linalg.norm(q))
    n_ops = max(10, int(1000 * np.sqrt(scale)))
    moves, merges = _sample_dsm_ops(rng, subject, n_ops, n_ops)
    return DirDataset(
        name="arxiv-dir", dirs=subject,
        entry_paths=[P.to_str(d) for d in entry_subject],
        vectors=vectors, queries=np.asarray(qvecs, dtype=np.float32),
        query_anchors=anchors, query_recursive=np.asarray(recursive),
        moves=moves, merges=merges,
        extra_namespaces={"time": [P.to_str(d) for d in entry_time]})


def brute_force_ground_truth(ds: DirDataset, k: int = 10,
                             metric: str = "ip") -> np.ndarray:
    """Exact scoped top-k ids per query (the paper computes GT by brute force
    over entries satisfying the constraint)."""
    from ..core import make_scope_index
    idx = make_scope_index("triehi")
    for eid, path in enumerate(ds.entry_paths):
        idx.insert(eid, path)
    out = np.full((len(ds.queries), k), -1, dtype=np.int64)
    for qi, (q, anchor, rec) in enumerate(
            zip(ds.queries, ds.query_anchors, ds.query_recursive)):
        cand = idx.resolve(anchor, recursive=bool(rec)).to_array()
        if len(cand) == 0:
            continue
        rows = ds.vectors[cand]
        scores = rows @ q if metric in ("ip", "cos") else \
            2.0 * rows @ q - np.einsum("nd,nd->n", rows, rows)
        kk = min(k, len(cand))
        sel = np.argpartition(scores, -kk)[-kk:]
        order = sel[np.argsort(scores[sel])[::-1]]
        out[qi, :kk] = cand[order]
    return out
