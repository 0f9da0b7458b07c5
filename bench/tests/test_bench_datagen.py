"""The generator keeps dirgen's published statistics at a small scale."""
import numpy as np
import torch

from bench import datagen, harness

from _bench_helpers import ROOT


def _cfg(name):
    return harness.load_json(ROOT / "bench" / "configs" / f"{name}.json")


def test_wiki_tree_depth_and_skew():
    data = datagen.make_structure(_cfg("wiki-fp32"), scale=0.01)
    assert len(data.tree) == int(363_467 * 0.01) + 1
    assert data.n_entries == int(1_940_000 * 0.01)
    assert abs(data.tree.avg_depth - 11.95) < 1.0
    counts = np.bincount(data.assign, minlength=len(data.tree))
    # Zipf a = 1.3: the most popular directory holds far more than its share
    assert counts.max() > 50 * data.n_entries / len(data.tree)
    # every path is its parent's path plus one segment
    t = data.tree
    for c in range(1, len(t)):
        assert t.paths[c].startswith(t.paths[t.parent[c]])
        assert t.paths[c].count("/") == t.depth[c] + 1


def test_arxiv_two_namespaces():
    cfg = _cfg("arxiv-int8")
    cfg["dataset"]["entries"] = 5000          # the trees at full size
    data = datagen.make_structure(cfg)
    assert len(data.tree) == 168 + 1 and abs(data.tree.avg_depth - 2.19) < 0.5
    time_tree, time_assign = data.extra["time"]
    assert len(time_tree) == 432 + 1 and abs(time_tree.avg_depth - 1.92) < 0.5
    assert len(time_assign) == data.n_entries


def test_vectors_queries_and_templates_follow_the_seed():
    cfg = dict(_cfg("wiki-fp32"), dim=16)
    data = datagen.make_structure(cfg, scale=0.002)
    datagen.make_vectors(torch, data, 2 ** 31 + 5, torch.device("cpu"))
    again = datagen.make_structure(cfg, scale=0.002)
    datagen.make_vectors(torch, again, 2 ** 31 + 5, torch.device("cpu"))
    assert np.array_equal(data.vectors, again.vectors)
    assert np.allclose(np.linalg.norm(data.vectors, axis=1), 1.0, atol=1e-5)
    pool = datagen.make_queries(torch, data, 4000, 7, torch.device("cpu"))
    assert abs(pool.recursive.mean() - 0.8) < 0.03
    dirs = set(data.tree.paths)
    for a in pool.anchors[:500]:
        assert a in dirs
    ops = datagen.dsm_templates(data.tree, 400, 7)
    kinds = [k for k, _, _ in ops]
    assert kinds.count("move") == kinds.count("merge") == 200
    shallow = sum(src.count("/") - 1 <= datagen.SHALLOW_DEPTH
                  for _, src, _ in ops)
    assert shallow >= 200
    for _, src, dst in ops:
        assert not src.startswith(dst) and not dst.startswith(src)


def test_ancestor_path():
    assert datagen.ancestor_path("/a/b/c/", 0) == "/"
    assert datagen.ancestor_path("/a/b/c/", 2) == "/a/b/"
    assert datagen.ancestor_path("/a/b/c/", 3) == "/a/b/c/"
