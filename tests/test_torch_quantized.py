"""The port's int8 and PQ tiers and tiered storage against the reference.

Same numpy data into a reference ``repro.vectordb.DirectoryVectorDB`` and a
port one (``device="cpu"``, the plain PyTorch path). The quantizer and the
PQ codebook are copies, so codes, scales, centroids and LUTs are equal bit
for bit. Results are compared as in ``test_torch_vectordb.py``: scope sizes
and plans equal, ids equal except where the reference's scores tie within
1e-5, scores to rtol = atol = 1e-5 (the exact fp32 rescore sums in another
order in XLA:CPU and torch). Under an exhaustive rescore window the int8
and PQ candidate sets equal the reference's and the results equal fp32.
Inside the port ``dsq_batch`` equals a loop of ``dsq`` bit for bit at int8
and PQ, tiered or not. This mirrors ``tests/test_quantized.py`` and
``tests/test_pq.py`` without their sharded and serving cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.interface import normalize_batch as ref_normalize  # noqa: E402
from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro.vectordb.flat import FlatExecutor as RefFlat  # noqa: E402
from repro.vectordb.quant import PQCodebook as RefCodebook  # noqa: E402
from repro.vectordb.quant import quantize_rows as ref_quantize  # noqa: E402
from repro.vectordb.store import VectorStore as RefStore  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.core import paths as P  # noqa: E402
from repro_torch.core.interface import normalize_batch  # noqa: E402
from repro_torch.kernels.ref import topk_disagreement  # noqa: E402
from repro_torch.vectordb import DirectoryVectorDB, from_state  # noqa: E402
from repro_torch.vectordb.flat import (FlatExecutor,  # noqa: E402
                                      gather_rescore)
from repro_torch.vectordb.planner import BatchAccounting  # noqa: E402
from repro_torch.vectordb.quant import PQCodebook, quantize_rows  # noqa: E402
from repro_torch.vectordb.store import VectorStore  # noqa: E402

from test_torch_vectordb import (DATASETS, DIM, TOL, _apply,  # noqa: E402
                                 _assert_bitwise, _assert_matches_ref,
                                 _dsm_sequence, _port_db, _ref_db,
                                 _requests, _state)

PRECISIONS = ("int8", "pq")


def _rows(n, d=DIM, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _query_tier(port, ref, reqs, precision, label, rescore_k=None):
    """Port batch == port loop bitwise; port batch and loop vs the
    reference's within tolerance, with equal plans, precision groups and
    accounting terms."""
    q, paths, rec, exc = reqs
    kw = dict(k=10, precision=precision, rescore_k=rescore_k)
    pb = port.dsq_batch(q, paths, recursive=rec, exclude=exc, **kw)
    rb = ref.dsq_batch(q, paths, recursive=rec, exclude=exc, **kw)
    loop = [port.dsq(q[i], paths[i], recursive=rec[i], exclude=exc[i], **kw)
            for i in range(len(paths))]
    _assert_bitwise(pb, loop, f"{label} port batch vs loop")
    pa, ra = pb[0].batch, rb[0].batch
    for key in ("precision_groups", "plan_groups", "rescore_candidates",
                "db_bytes_fp32", "db_bytes_int8", "db_bytes_pq",
                "rescore_fetch_bytes", "rows_device_pinned", "rows_host",
                "tiered"):
        assert getattr(pa, key) == getattr(ra, key), (label, key)
    # the reference launches once per gather group; the port ranks the
    # fp32 ones (every fp32 group of a quantized or tiered batch is a
    # gather group) in one list launch while the store is not tiered
    listed = 0 if pa.tiered else ra.precision_groups.get("fp32", 0)
    assert pa.gather_listed == listed, label
    assert pa.launches == ra.launches - listed + (listed > 0), label
    for i in range(len(paths)):
        assert pb[i].plan == rb[i].plan, (label, i)
        _assert_matches_ref(pb[i], rb[i], f"{label} batch {i}")
    return pb, rb


# --------------------------------------------------------- numpy copies
def test_quantizer_and_codebook_copies_are_bitwise():
    X = _rows(700)
    X[5] = 0.0                                  # an all-zero row
    for a, b in zip(quantize_rows(X), ref_quantize(X)):
        np.testing.assert_array_equal(a, b)
    mine, theirs = PQCodebook(DIM, seed=3), RefCodebook(DIM, seed=3)
    mine.train(X)
    theirs.train(X)
    np.testing.assert_array_equal(mine.centroids, theirs.centroids)
    np.testing.assert_array_equal(mine.encode(X), theirs.encode(X))
    for metric in ("ip", "l2"):
        np.testing.assert_array_equal(mine.lut(X[:4], metric),
                                      theirs.lut(X[:4], metric))


def test_store_tiers_follow_ingest_and_compaction():
    """Codes, scales and dequantized norms equal the reference store's
    through incremental adds, growth and a compaction (codes copied, never
    re-encoded), and the device mirrors follow."""
    mine = VectorStore(DIM, "cos", capacity=8, device="cpu")
    theirs = RefStore(DIM, "cos", capacity=8)
    for n_new, seed in ((70, 1), (50, 2)):
        rows = _rows(n_new, seed=seed)
        mine.add(rows)
        theirs.add(rows)
        np.testing.assert_array_equal(mine.q_vectors, theirs.q_vectors)
        np.testing.assert_array_equal(mine.q_scales, theirs.q_scales)
        np.testing.assert_array_equal(mine.q_sq_norms(), theirs.q_sq_norms())
        np.testing.assert_array_equal(mine.pq_codes, theirs.pq_codes)
        np.testing.assert_array_equal(mine.device_q_vectors().numpy(),
                                      mine.q_vectors)
        np.testing.assert_array_equal(mine.device_pq_codes().numpy(),
                                      mine.pq_codes)
    cb = mine.pq_codebook
    for st in (mine, theirs):
        st.mark_deleted([0, 3, 64, 119])
    assert mine.pq_nbytes() == theirs.pq_nbytes() == 116 * cb.m
    assert mine.q_alive_nbytes() == theirs.q_alive_nbytes()
    np.testing.assert_array_equal(mine.compact(), theirs.compact())
    assert mine.pq_codebook is cb                       # frozen
    np.testing.assert_array_equal(mine.q_vectors, theirs.q_vectors)
    np.testing.assert_array_equal(mine.pq_codes, theirs.pq_codes)
    np.testing.assert_array_equal(mine.device_q_scales().numpy(),
                                  theirs.q_scales)
    np.testing.assert_array_equal(mine.device_pq_codes().numpy(),
                                  theirs.pq_codes)
    assert mine.q_nbytes() == theirs.q_nbytes()


# ------------------------------------------------------------ executor
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", ["ip", "l2", "cos"])
def test_exhaustive_rescore_equals_fp32_and_reference(precision, metric):
    """Under an exhaustive window the candidates are every scope row: the
    result equals fp32 (port and reference alike), through the scan and
    the gather plans."""
    X, Q = _rows(1500, seed=4), _rows(4, seed=5)
    mine, theirs = VectorStore(DIM, metric, device="cpu"), RefStore(DIM,
                                                                    metric)
    mine.add(X)
    theirs.add(X)
    ex, rex = FlatExecutor(mine), RefFlat(theirs)
    scopes = {"scan": np.arange(0, 1500, 2, dtype=np.uint32),
              "gather": np.arange(60, dtype=np.uint32)}
    for plan, scope in scopes.items():
        sf, i_f = ex.search(Q, 10, candidate_ids=scope, plan=plan)
        sq, iq = ex.search(Q, 10, candidate_ids=scope, plan=plan,
                           precision=precision, rescore_k=1500)
        np.testing.assert_array_equal(i_f, iq)
        np.testing.assert_allclose(sf, sq, rtol=TOL, atol=TOL)
        rs, ri = rex.search(Q, 10, candidate_ids=scope, plan=plan,
                            precision=precision, rescore_k=1500)
        err = topk_disagreement(iq, sq, ri, rs, TOL)
        assert err is None, (plan, err)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_gather_plans_window_rule_and_empty_scope(precision):
    X, Q = _rows(4000, seed=6), _rows(3, seed=7)
    st = VectorStore(DIM, "ip", device="cpu")
    st.add(X)
    ex = FlatExecutor(st)
    small = np.arange(30, dtype=np.uint32)           # 30 <= window 40
    sf, i_f = ex.search(Q, 10, candidate_ids=small)
    sq, iq = ex.search(Q, 10, candidate_ids=small, precision=precision)
    np.testing.assert_array_equal(i_f, iq)
    np.testing.assert_array_equal(sf, sq)            # the same fp32 launch
    big = np.arange(150, dtype=np.uint32)            # gather, > window
    s, i = ex.search(Q, 10, candidate_ids=big, precision=precision)
    assert set(i.ravel().tolist()) <= set(range(150))
    assert np.isfinite(s).all()
    s, i = ex.search(Q, 5, candidate_ids=np.empty(0, np.uint32),
                     precision=precision)
    assert (i == -1).all() and not np.isfinite(s).any()


def test_gather_rescore_padding_contract():
    st = VectorStore(DIM, "ip", device="cpu")
    st.add(_rows(50, seed=8))
    Q = _rows(2, seed=9)
    cand = np.array([[3, 7, -1, 999], [-1, -1, -1, -1]], np.int64)
    s, i = gather_rescore(st, Q, cand, k=3)
    assert i.shape == (2, 3)
    assert set(i[0].tolist()) == {3, 7, -1} and int((i[0] >= 0).sum()) == 2
    assert (i[1] == -1).all() and not np.isfinite(s[1]).any()
    s, i = gather_rescore(st, Q, np.zeros((2, 0), np.int64), k=3)
    assert (i == -1).all()


# ------------------------------------------------- database, end to end
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", list(DATASETS))
def test_tiers_match_reference_through_dsm(name, precision):
    """Both datasets, TrieHI, through a DSM sequence with tombstones: the
    port's int8/PQ batches equal the reference's within tolerance (same
    plans, precision groups and accounting) and their own loops bitwise."""
    ds = DATASETS[name]()
    port, ref = _port_db(ds), _ref_db(ds, "triehi")
    reqs = _requests(ds)
    pb, _ = _query_tier(port, ref, reqs, precision, "before DSM")
    assert pb[0].batch.precision_groups.get(precision, 0) > 0
    for step in _dsm_sequence(ref, ds):
        assert _apply(port, step) == _apply(ref, step), step
    _query_tier(port, ref, reqs, precision, "after DSM")
    n = len(port.store)
    pe, _ = _query_tier(port, ref, reqs, precision, "exhaustive",
                        rescore_k=n)
    q, paths, rec, exc = reqs
    fp = port.dsq_batch(q, paths, k=10, recursive=rec, exclude=exc)
    for a, b in zip(pe, fp):
        np.testing.assert_array_equal(a.ids, b.ids)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_planner_precision_per_group(precision):
    db = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu")
    ref = RefDB(dim=DIM, calibration=False)
    paths = ["/broad/"] * 900 + ["/narrow/"] * 20
    X = _rows(920, seed=10)
    for d in (db, ref):
        d.ingest(X, paths)
        d.build_ann("flat")
    out = []
    for d, norm in ((db, normalize_batch), (ref, ref_normalize)):
        acct = BatchAccounting()
        groups = d.planner().plan(d.namespaces["fs"], len(d.store),
                                  norm(["/broad/", "/narrow/"], True, None),
                                  k=10, acct=acct, precision=precision)
        out.append(({str(g.key.path): (g.plan, g.precision)
                     for g in groups}, acct.precision_groups))
    assert out[0] == out[1]
    plans = sorted(out[0][0].values())
    assert plans == [("gather", "fp32"), ("scan", precision)]
    assert out[0][1] == {precision: 1, "fp32": 1}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_batch_accounting_terms_exclude_tombstones(precision):
    db = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu")
    ids = db.ingest(_rows(1200, seed=11), ["/a/"] * 600 + ["/b/"] * 600)
    db.build_ann("flat")
    q = _rows(6, seed=12)
    acct = db.dsq_batch(q, ["/a/", "/b/", "/", "/a/", "/b/", "/"], k=10,
                        precision=precision)[0].batch
    tier = acct.db_bytes_int8 if precision == "int8" else acct.db_bytes_pq
    assert acct.db_bytes_fp32 == 1200 * DIM * 4
    assert tier == (1200 * (DIM + 4) if precision == "int8"
                    else 1200 * db.store.pq_codebook.m)
    assert acct.rescore_candidates == 6 * 40
    assert acct.precision_groups.get(precision) == 3
    for eid in ids[:30]:
        db.delete(int(eid))
    acct = db.dsq_batch(q, ["/a/"] * 6, k=10, precision=precision)[0].batch
    assert acct.db_bytes_fp32 == 1170 * DIM * 4
    acct = db.dsq_batch(q, ["/a/"] * 6, k=10)[0].batch
    assert acct.db_bytes_int8 == acct.db_bytes_pq == 0
    assert acct.rescore_candidates == 0 and not acct.tiered


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tombstones_never_surface(precision):
    db = DirectoryVectorDB(dim=DIM, device="cpu")
    db.ingest(_rows(600, seed=13), ["/x/"] * 600)
    db.build_ann("flat")
    q = _rows(1, seed=14)[0]
    top = db.dsq(q, "/x/", k=5, precision=precision).ids[0]
    for eid in top[:2]:
        db.delete(int(eid))
    after = db.dsq(q, "/x/", k=5, precision=precision).ids[0]
    assert not set(after.tolist()) & set(int(x) for x in top[:2])


# ------------------------------------------------------- tiered storage
def _tiered_pair(n=2000, n_dirs=8):
    X = _rows(n, seed=15)
    paths = [f"/d/{i % n_dirs}/" for i in range(n)]
    out = []
    for db in (DirectoryVectorDB(dim=DIM, calibration=False, device="cpu"),
               RefDB(dim=DIM, calibration=False)):
        db.build_ann("flat")
        db.ingest(X, paths)
        out.append(db)
    return out


def test_tiered_upgrade_pins_and_fetch_match_reference():
    """Over budget the fp32 mirror is released, fp32 batches take the PQ
    plan, the rescore fetch and the pins match the reference's, pins cut
    the fetch, and the results equal an explicit PQ batch bitwise."""
    port, ref = _tiered_pair()
    q = _rows(8, seed=16)
    paths = [f"/d/{i % 8}/" for i in range(8)]
    reqs = (q, paths, [True] * 8, [[]] * 8)
    explicit = port.dsq_batch(q, paths, k=10, precision="pq")
    port.store.device_vectors()
    assert port.store._dev_rows is not None
    for db in (port, ref):
        db.store.set_device_budget(db.store.nbytes() // 3)
    assert port.store.tiered_active() and port.store._dev_rows is None
    with pytest.raises(RuntimeError, match="budget"):
        port.store.device_vectors()
    first, _ = _query_tier(port, ref, reqs, "fp32", "tiered first")
    second, _ = _query_tier(port, ref, reqs, "fp32", "tiered second")
    a1, a2 = first[0].batch, second[0].batch
    assert a1.tiered and a1.precision_groups.get("pq", 0) > 0
    assert a1.rescore_fetch_bytes > 0
    assert a2.rows_device_pinned > 0
    assert a2.rescore_fetch_bytes < a1.rescore_fetch_bytes
    assert a2.rows_device_pinned + a2.rows_host == 2000
    _assert_bitwise(first, explicit, "tiered vs explicit pq")
    _assert_bitwise(second, explicit, "tiered (pinned) vs explicit pq")
    port.store.set_device_budget(None)                 # back on the device
    assert not port.store.tiered_active()
    _assert_bitwise(port.dsq_batch(q, paths, k=10, precision="pq"), explicit,
                    "untiered again")


def test_pins_survive_ingest_and_cold_batches():
    port, ref = _tiered_pair(n=1500, n_dirs=4)
    for db in (port, ref):
        db.store.set_device_budget(db.store.nbytes() // 3)
    q = _rows(8, seed=17)
    hot = ["/d/0/"] * 8
    for _ in range(3):
        _query_tier(port, ref, (q, hot, [True] * 8, [[]] * 8), "fp32", "hot")
    pins = port.store.pinned_mask().copy()
    np.testing.assert_array_equal(pins, ref.store.pinned_mask())
    hot_ids = set(port.namespaces["fs"].resolve("/d/0/").to_array())
    assert hot_ids & set(np.flatnonzero(pins))
    port.dsq_batch(q[:1], ["/d/3/"], k=5)             # one cold request
    assert set(np.flatnonzero(pins)) & hot_ids <= set(
        np.flatnonzero(port.store.pinned_mask()))
    new = _rows(1200, seed=18)
    for db in (port, ref):
        db.ingest(new, [f"/d/{i % 4}/" for i in range(1200)])
    pm = port.store.pinned_mask()
    assert pm.shape == (2700,) and not pm[1500:].any()
    reqs = (q[:4], [f"/d/{i}/" for i in range(4)], [True] * 4, [[]] * 4)
    res, _ = _query_tier(port, ref, reqs, "fp32", "after ingest")
    assert res[0].batch.rows_device_pinned + res[0].batch.rows_host == 2700


def test_host_fetch_retries_match_reference():
    """A seeded transient fault at ``store.host_fetch`` is retried the same
    number of times in both packages, invisibly to the results; past the
    retry bound it escalates as a typed fault."""
    port, ref = _tiered_pair()
    q = _rows(4, seed=19)
    paths = ["/"] * 4
    want = port.dsq_batch(q, paths, k=10, precision="int8")
    got = {}
    for name, db, fmod in (("port", port, faults),
                           ("ref", ref, __import__("repro.faults",
                                                   fromlist=["x"]))):
        r0 = db.store.host_fetch_retries
        plan = fmod.FaultPlan(seed=1).add("store.host_fetch",
                                          kind="transient", count=2)
        with fmod.FaultInjector(plan) as inj:
            res = db.dsq_batch(q, paths, k=10, precision="int8")
        got[name] = (inj.trips, db.store.host_fetch_retries - r0,
                     res[0].batch.host_fetch_retries)
        if name == "port":
            _assert_bitwise(res, want, "retried batch")
    assert got["port"] == got["ref"] == ({"store.host_fetch": 2}, 2, 2)
    f0 = port.store.host_fetch_failures
    plan = faults.FaultPlan().add("store.host_fetch", kind="transient",
                                  count=None)
    with faults.FaultInjector(plan):
        with pytest.raises(faults.FaultError):
            port.dsq(q[0], "/", k=10, precision="int8")
    assert port.store.host_fetch_failures == f0 + 1


# ------------------------------------------------- state carried across
def test_from_state_keeps_empty_dirs_and_the_trained_codebook():
    """Directories without entries exist in the converted database too
    (``list_dirs`` / ``stats()`` equal the source's), and a codebook the
    source trained before later ingests serves PQ with the same codes and
    candidates."""
    ds = DATASETS["wiki"]()
    ref = _ref_db(ds, "triehi")
    n0 = len(ds.vectors) // 2
    ref_small = RefDB(dim=DIM, scope_strategy="triehi", calibration=False)
    ref_small.ingest(ds.vectors[:n0], ds.entry_paths[:n0])
    ref_small.build_ann("flat")
    ref_small.store.pq_codes                       # trains on n0 rows
    ref_small.ingest(ds.vectors[n0:], ds.entry_paths[n0:])
    for step in _dsm_sequence(ref, ds)[:3]:        # mkdir /newdir/, ...
        _apply(ref_small, step)
    vecs, ns_paths, deleted = _state(ref_small)
    ns_dirs = {name: [P.to_str(d) for d in idx.list_dirs()]
               for name, idx in ref_small.namespaces.items()}
    conv = from_state(vecs, ns_paths, deleted, namespace_dirs=ns_dirs,
                      pq_centroids=ref_small.store.pq_codebook.centroids,
                      pq_encoded=n0, device="cpu", calibration=False)
    for name, idx in ref_small.namespaces.items():
        assert sorted(map(P.to_str, conv.namespaces[name].list_dirs())) == \
            sorted(map(P.to_str, idx.list_dirs()))
    assert conv.stats()["namespaces"] == ref_small.stats()["namespaces"]
    np.testing.assert_array_equal(conv.store.pq_codes,
                                  ref_small.store.pq_codes)
    reqs = _requests(ds)
    _query_tier(conv, ref_small, reqs, "pq", "converted pq")
    # without the carried codebook the port trains on all rows: other codes
    plain = from_state(vecs, ns_paths, deleted, device="cpu",
                       calibration=False)
    assert not np.array_equal(plain.store.pq_codes, ref_small.store.pq_codes)
