"""The port's proximity-graph executor (``repro_torch.vectordb.graph``)
against the reference ``repro.vectordb.graph.PGIndex``.

The graph is numpy in both packages over the same host rows, so the build
(its RNG draws included), ``add``, ``repair``, ``remap_ids`` and ``audit``
must give the same adjacency and entry, and the fp32 beam the same ids and
score bits. The int8 and PQ searches end in each package's exact fp32
gather-rescore (a GEMM in the reference, the port's fixed-order chain), so
there ids are equal and scores agree within 1e-5. Inside the port,
``dsq_batch(executor="pg")`` equals a loop of ``dsq`` bit for bit. The port
runs with ``device="cpu"`` (its plain PyTorch path).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datasets import make_wiki_dir  # noqa: E402
from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro_torch.vectordb import DirectoryVectorDB, PGIndex  # noqa: E402
from repro_torch.vectordb.quant import resolve_rescore_k  # noqa: E402

TOL = 1e-5
DIM = 32
K = 8
PG = dict(max_degree=8, ef_construction=16)


@pytest.fixture(scope="module")
def wiki():
    return make_wiki_dir(scale=0.002, dim=DIM, n_queries=24, seed=7)


def _pair(wiki, n=None):
    """The same rows and paths in a reference and a port database, both
    with the flat and PG executors."""
    n = len(wiki.vectors) if n is None else n
    ref = RefDB(dim=DIM, calibration=False)
    mine = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu")
    for db in (ref, mine):
        db.ingest(wiki.vectors[:n], wiki.entry_paths[:n])
        db.build_ann("flat")
        db.build_ann("pg", **PG)
    return ref, mine


@pytest.fixture(scope="module")
def pair(wiki):
    """The module's two databases; the port serves PQ with the reference's
    trained codebook (its codes then equal the reference's)."""
    ref, mine = _pair(wiki)
    mine.store.set_pq_codebook(ref.store.pq_codebook.centroids,
                               len(ref.store))
    np.testing.assert_array_equal(mine.store.pq_codes, ref.store.pq_codes)
    return ref, mine


def _same_graph(a, b, label):
    pa, pb = a.executors["pg"], b.executors["pg"]
    np.testing.assert_array_equal(pa.neighbors, pb.neighbors, err_msg=label)
    np.testing.assert_array_equal(pa._n_edges, pb._n_edges, err_msg=label)
    assert pa._entry == pb._entry, label
    assert pa._n_nodes == pb._n_nodes, label
    assert pa.repair_gen == pb.repair_gen, label
    assert pa._pending_relink == pb._pending_relink, label
    assert pa.audit() == pb.audit(), label


def _requests(wiki, n=12):
    paths = [(wiki.query_anchors[i % 6] or "/") for i in range(n)]
    paths[0] = "/"
    rec = [bool(wiki.query_recursive[i % 6]) for i in range(n)]
    return wiki.queries[:n], paths, rec


def test_build_add_repair_remap_match_reference(wiki):
    """The adjacency, entry and audit after ``_build``, an incremental
    ``add`` (through ingest), a budgeted ``repair`` after deletes, and a
    store compaction's ``remap_ids`` (on the first 1,500 rows)."""
    n0, n1 = 1200, 1500
    ref, mine = _pair(wiki, n0)
    assert isinstance(mine.executors["pg"], PGIndex)
    _same_graph(mine, ref, "build")
    for db in (ref, mine):
        db.ingest(wiki.vectors[n0:n1], wiki.entry_paths[n0:n1])
    _same_graph(mine, ref, "add")
    dead = np.arange(0, n1, 7)
    for db in (ref, mine):
        db.store.mark_deleted(dead)
    assert mine.executors["pg"].audit()["dead"] > 0
    for budget in (16, None):
        out = [db.executors["pg"].repair(max_relink=budget)
               for db in (ref, mine)]
        assert out[0] == out[1], budget
        _same_graph(mine, ref, f"repair {budget}")
    assert mine.executors["pg"].audit()["dead"] == 0
    maps = [db.store.compact() for db in (ref, mine)]
    np.testing.assert_array_equal(maps[0], maps[1])
    for db, m in zip((ref, mine), maps):
        db.executors["pg"].remap_ids(m)
    _same_graph(mine, ref, "remap")


def test_search_batch_fp32_bitwise(pair, wiki):
    """The fp32 beam is the same numpy in both packages: ids and score bits
    equal, under a scope mask and without one."""
    ref, mine = pair
    q = wiki.queries[:16]
    scope = np.zeros(len(wiki.vectors), bool)
    scope[::3] = True
    for valid in (None, scope):
        for ef in (16, 64):
            want = ref.executors["pg"].search_batch(q, K, valid_mask=valid,
                                                    ef_search=ef)
            got = mine.executors["pg"].search_batch(q, K, valid_mask=valid,
                                                    ef_search=ef)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_search_batch_quantized_matches_reference(precision, pair, wiki):
    """int8 / PQ traversal then the exact rescore: ids equal, scores within
    TOL."""
    ref, mine = pair
    q = wiki.queries[:16]
    scope = np.zeros(len(wiki.vectors), bool)
    scope[::2] = True
    for valid in (None, scope):
        want = ref.executors["pg"].search_batch(
            q, K, valid_mask=valid, ef_search=32, precision=precision,
            rescore_k=4 * K)
        got = mine.executors["pg"].search_batch(
            q, K, valid_mask=valid, ef_search=32, precision=precision,
            rescore_k=4 * K)
        np.testing.assert_array_equal(got[1], want[1])
        filled = want[1] >= 0
        np.testing.assert_allclose(got[0][filled], want[0][filled],
                                   rtol=TOL, atol=TOL)
        assert np.all(got[0][~filled] == -np.inf)


def planned_precision(db, res, precision, k, rescore_k):
    """The precision ``dsq_batch`` ran a request's scope group at: the
    planner serves a gather-plan scope that fits the rescore window at
    exact fp32 (``BatchPlanner.plan``), in both packages."""
    if precision == "fp32":
        return "fp32"
    n = len(db.store)
    plan = db.planner().choose_plan(res.scope_size, n, k)
    window = resolve_rescore_k(k, rescore_k, res.scope_size)
    return precision if plan == "scan" or res.scope_size > window \
        else "fp32"


@pytest.mark.parametrize("precision", ["fp32", "int8", "pq"])
def test_dsq_batch_pg_equals_loop_and_reference_ids(precision, pair, wiki):
    """``dsq_batch(executor="pg")`` takes the planned PG route (one
    ``search_batch`` per unique scope) and equals a loop of ``dsq`` bit for
    bit, each request at its group's planned precision; its ids equal the
    reference's batch."""
    ref, mine = pair
    q, paths, rec = _requests(wiki)
    rk = 4 * K if precision != "fp32" else None
    kw = dict(k=K, recursive=rec, executor="pg", precision=precision,
              rescore_k=rk, ef_search=32)
    got = mine.dsq_batch(q, paths, **kw)
    want = ref.dsq_batch(q, paths, **kw)
    assert {r.plan for r in got} <= {"pg", "empty"}
    assert got[0].batch.launches == got[0].batch.unique_scopes
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.scope_size == w.scope_size
        np.testing.assert_array_equal(g.ids, w.ids, err_msg=str(i))
        prec = planned_precision(mine, g, precision, K, rk)
        one = mine.dsq(q[i], paths[i], k=K, recursive=rec[i], executor="pg",
                       precision=prec, rescore_k=rk, ef_search=32)
        np.testing.assert_array_equal(g.ids, one.ids, err_msg=str(i))
        np.testing.assert_array_equal(g.scores, one.scores, err_msg=str(i))
