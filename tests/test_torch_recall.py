"""Recall@10 against brute-force ground truth on the released-dataset twins
(smoke scale), per strategy, run on the port (``device="cpu"``); the twin of
``tests/test_recall.py``: the exact executors (flat, sharded) must achieve
recall 1.0, the approximate ones (ivf, pg) >= 0.95.

Ground truth comes from ``datasets.dirgen.brute_force_ground_truth`` (exact
scoped top-k, the paper's GT procedure). The exact-recall check is
tie-tolerant: an id swapped out for an equal-scoring one at the k boundary
still counts (GT is computed in numpy, the executors in PyTorch — low-bit
score differences must not flip the assertion)."""
import numpy as np
import pytest

from repro_torch.core import STRATEGIES
from repro_torch.datasets import brute_force_ground_truth, make_arxiv_dir, \
    make_wiki_dir
from repro_torch.vectordb import DirectoryVectorDB

K = 10
DIM = 24
SCALE = 0.0003
N_QUERIES = 24


def _dataset(name):
    if name == "wiki":
        return make_wiki_dir(scale=SCALE, dim=DIM, n_queries=N_QUERIES,
                             seed=0)
    return make_arxiv_dir(scale=SCALE, dim=DIM, n_queries=N_QUERIES, seed=1)


def _recall(ds, gt, db, executor, **params):
    """Mean recall@K over queries with a non-empty scope; tie-tolerant
    (a missed GT id whose score equals the worst returned score counts)."""
    hits = total = 0
    for qi, (q, anchor, rec) in enumerate(
            zip(ds.queries, ds.query_anchors, ds.query_recursive)):
        want = gt[qi][gt[qi] >= 0]
        if len(want) == 0:
            continue
        res = db.dsq(q, anchor, k=K, recursive=bool(rec), executor=executor,
                     **params)
        got = {int(i) for i in res.ids[0] if int(i) >= 0}
        row_hits = len(set(int(w) for w in want) & got)
        if row_hits < len(want) and got:
            worst = float(np.min(res.scores[0][np.isfinite(res.scores[0])]))
            for w in set(int(w) for w in want) - got:
                s = float(ds.vectors[w] @ q)
                if abs(s - worst) < 1e-5:
                    row_hits += 1            # k-boundary score tie
        hits += row_hits
        total += len(want)
    assert total > 0
    return hits / total


@pytest.mark.parametrize("ds_name", ["wiki", "arxiv"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_recall_per_strategy(ds_name, strategy):
    ds = _dataset(ds_name)
    gt = brute_force_ground_truth(ds, k=K)
    db = DirectoryVectorDB(dim=DIM, scope_strategy=strategy, device="cpu")
    db.ingest(ds.vectors, ds.entry_paths,
              namespaces=ds.extra_namespaces or None)
    db.build_ann("flat")
    db.build_ann("sharded")
    db.build_ann("ivf", n_lists=8)
    db.build_ann("pg", max_degree=12, ef_construction=48)

    assert _recall(ds, gt, db, "flat") == 1.0
    assert _recall(ds, gt, db, "sharded") == 1.0
    assert _recall(ds, gt, db, "ivf", nprobe=7) >= 0.95
    assert _recall(ds, gt, db, "pg", ef_search=128) >= 0.95

    # int8 two-phase (quantized scan/gather -> exact fp32 rescore): the
    # exact executors stay near-exact through the default rescore window,
    # the approximate ones keep their fp32 floors
    assert _recall(ds, gt, db, "flat", precision="int8") >= 0.99
    assert _recall(ds, gt, db, "sharded", precision="int8") >= 0.99
    assert _recall(ds, gt, db, "ivf", nprobe=7, precision="int8") >= 0.95
    assert _recall(ds, gt, db, "pg", ef_search=128,
                   precision="int8") >= 0.95

    # pq two-phase (uint8 ADC scan/gather -> exact fp32 rescore): coarser
    # codes than int8, so the floors are the PQ tier's gates — >= 0.95 for
    # the exact executors through the default rescore window, >= 0.90 for
    # the approximate ones
    assert _recall(ds, gt, db, "flat", precision="pq") >= 0.95
    assert _recall(ds, gt, db, "sharded", precision="pq") >= 0.95
    assert _recall(ds, gt, db, "ivf", nprobe=7, precision="pq") >= 0.90
    assert _recall(ds, gt, db, "pg", ef_search=128, precision="pq") >= 0.90
