"""The benchmark's data: WIKI-Dir / ARXIV-Dir twins at their published size.

A rewritten copy of ``src/repro_torch/datasets/dirgen.py`` that keeps its
published statistics and imports nothing of the program:

* the directory tree grows one directory at a time, each attached to a
  parent drawn among the 8 newest at its target depth less one (a target
  drawn from N(avg_depth, depth_sd), at least 1), falling back to the
  deepest level that exists;
* entries go to directories with Zipf-skewed popularity (exponent ``a``
  over a random ranking of every directory, the root included);
* a query picks an entry uniformly, anchors at a uniformly drawn depth of
  its directory's path (0 = the root), is recursive with probability 0.8
  and is the entry's vector plus N(0, 0.3^2) noise, normalised;
* DSM templates are (kind, src, dst) with half the sources shallow
  (depth <= 3), half uniform, MOVE and MERGE alternating (1:1); they are
  templates only, revalidated against the replayed tree before submission.

The vectors are unit rows clustered per top-level branch (noise 0.35), made
on the device from a ``torch.Generator`` seeded by the run's seed, in
chunks, and copied once into one host array that both the program (through
``ingest``) and the reference read. Nothing is written to disk.

The tree, the assignment and the query anchors come from numpy generators
seeded from ``structure_seed`` (the configuration's: one published dataset)
and the run's seed (vectors, queries, DSM stream).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

SHALLOW_DEPTH = 3
QUERY_NOISE = 0.3
VECTOR_NOISE = 0.35
RECURSIVE_SHARE = 0.8
CHUNK_ROWS = 1 << 18


@dataclass
class Tree:
    """One namespace's directory tree. ``paths[i]`` is directory i's
    canonical string (``"/"`` for the root, ``"/a/b/"`` below it);
    ``parent[0] == -1``; ``top[i]`` is the index of i's top-level ancestor
    (0 for the root itself)."""
    paths: List[str]
    parent: np.ndarray
    depth: np.ndarray
    top: np.ndarray

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def avg_depth(self) -> float:
        return float(self.depth[1:].mean()) if len(self) > 1 else 0.0


@dataclass
class Dataset:
    name: str
    dim: int
    tree: Tree                     # the primary namespace ("fs")
    assign: np.ndarray             # (n,) int64 directory of each entry
    vectors: np.ndarray            # (n, dim) float32 unit rows
    extra: Dict[str, Tuple[Tree, np.ndarray]] = field(default_factory=dict)

    @property
    def n_entries(self) -> int:
        return len(self.assign)

    def entry_paths(self, namespace: Optional[str] = None) -> List[str]:
        tree, assign = ((self.tree, self.assign) if namespace is None
                        else self.extra[namespace])
        paths = tree.paths
        return [paths[i] for i in assign.tolist()]


@dataclass
class QueryPool:
    anchors: List[str]
    recursive: np.ndarray          # (P,) bool
    vectors: np.ndarray            # (P, dim) float32 unit rows


def build_tree(rng: np.random.Generator, n_dirs: int, avg_depth: float,
               depth_sd: float, prefix: str) -> Tree:
    """dirgen's ``_build_tree`` with the draws taken up front."""
    targets = np.maximum(np.rint(rng.normal(avg_depth, depth_sd, n_dirs)),
                         1).astype(np.int64)
    offsets = rng.random(n_dirs)
    paths = ["/"]
    parent = np.full(n_dirs + 1, -1, np.int64)
    depth = np.zeros(n_dirs + 1, np.int64)
    top = np.zeros(n_dirs + 1, np.int64)
    by_depth: Dict[int, List[int]] = {0: [0]}
    deepest = 0
    for c in range(1, n_dirs + 1):
        pd = min(int(targets[c - 1]) - 1, deepest)
        pool = by_depth[pd]
        p = pool[len(pool) - 1 - int(offsets[c - 1] * min(len(pool), 8))]
        parent[c] = p
        depth[c] = pd + 1
        top[c] = c if pd == 0 else top[p]
        paths.append(f"{paths[p]}{prefix}{c}/")
        by_depth.setdefault(pd + 1, []).append(c)
        deepest = max(deepest, pd + 1)
    return Tree(paths, parent, depth, top)


def zipf_assign(rng: np.random.Generator, n_entries: int, n_dirs: int,
                a: float) -> np.ndarray:
    ranks = rng.permutation(n_dirs)
    w = 1.0 / np.power(ranks + 1.0, a)
    return rng.choice(n_dirs, size=n_entries, p=w / w.sum())


def make_structure(cfg: dict, scale: float = 1.0) -> Dataset:
    """Tree(s) and assignment of ``cfg["dataset"]`` (no vectors yet)."""
    ds = cfg["dataset"]
    rng = np.random.default_rng(int(cfg["structure_seed"]))
    n_entries = max(200, int(ds["entries"] * scale))
    trees = {}
    for ns in ds["namespaces"]:
        n_dirs = max(ns.get("min_dirs", 20), int(ns["dirs"] * scale))
        tree = build_tree(rng, n_dirs, ns["avg_depth"], ns["depth_sd"],
                          ns["prefix"])
        trees[ns["name"]] = (tree, zipf_assign(rng, n_entries, len(tree),
                                               ns["zipf_a"]))
    first = ds["namespaces"][0]["name"]
    tree, assign = trees.pop(first)
    return Dataset(ds["name"], int(cfg["dim"]), tree, assign,
                   np.empty((0, int(cfg["dim"])), np.float32), trees)


def make_vectors(torch, data: Dataset, seed: int, device) -> None:
    """Fill ``data.vectors``: one centre per top-level branch of the
    primary tree, each row its centre plus N(0, 0.35^2) noise, normalised,
    made on ``device`` in chunks of rows and copied into one host array."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d = data.dim
    n_top = int(data.tree.top.max()) + 1
    centres = torch.randn(n_top, d, generator=g, device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    entry_top = torch.from_numpy(data.tree.top[data.assign]).to(device)
    out = np.empty((data.n_entries, d), np.float32)
    host = torch.from_numpy(out)
    for lo in range(0, data.n_entries, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, data.n_entries)
        v = torch.randn(hi - lo, d, generator=g, device=device)
        v.mul_(VECTOR_NOISE).add_(centres[entry_top[lo:hi]])
        v /= torch.linalg.vector_norm(v, dim=1, keepdim=True)
        host[lo:hi].copy_(v)
    data.vectors = out


def ancestor_path(path: str, depth: int) -> str:
    """The ancestor of canonical ``path`` at ``depth`` (0 = ``"/"``)."""
    if depth == 0:
        return "/"
    cut = -1
    for _ in range(depth + 1):
        cut = path.index("/", cut + 1)
    return path[:cut + 1]


def make_queries(torch, data: Dataset, n: int, seed: int,
                 device) -> QueryPool:
    """``n`` queries of dirgen's mix, from the run's seed."""
    rng = np.random.default_rng([int(seed), 1])
    entries = rng.integers(0, data.n_entries, n)
    dirs = data.assign[entries]
    depths = data.tree.depth[dirs]
    cut = np.floor(rng.random(n) * (depths + 1)).astype(np.int64)
    recursive = rng.random(n) < RECURSIVE_SHARE
    paths = data.tree.paths
    anchors = [ancestor_path(paths[d], c)
               for d, c in zip(dirs.tolist(), cut.tolist())]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    base = torch.from_numpy(data.vectors[entries]).to(device)
    q = base + QUERY_NOISE * torch.randn(base.shape, generator=g,
                                         device=device)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return QueryPool(anchors, recursive, q.cpu().numpy())


def dsm_templates(tree: Tree, n: int, seed: int) -> List[Tuple[str, str,
                                                                str]]:
    """``n`` (kind, src, dst) templates, MOVE and MERGE alternating, half
    of each kind's sources shallow. A move's destination may be the root; a
    merge's is not. Pairs where one side contains the other are redrawn."""
    rng = np.random.default_rng([int(seed), 2])
    depth = tree.depth
    non_root = np.arange(1, len(tree))
    shallow = non_root[depth[1:] <= SHALLOW_DEPTH]
    if len(shallow) == 0:
        shallow = non_root
    paths = tree.paths
    out: List[Tuple[str, str, str]] = []
    while len(out) < n:
        kind = "move" if len(out) % 2 == 0 else "merge"
        src_pool = shallow if (len(out) // 2) % 2 == 0 else non_root
        dst_pool = np.arange(len(tree)) if kind == "move" else non_root
        src = paths[int(src_pool[rng.integers(len(src_pool))])]
        dst = paths[int(dst_pool[rng.integers(len(dst_pool))])]
        if src.startswith(dst) or dst.startswith(src):
            continue
        out.append((kind, src, dst))
    return out
