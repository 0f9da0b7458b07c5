"""A batch's fp32 gather-plan scopes in one executor call.

``dsq_batch`` on the flat executor ranks every fp32 gather-plan group of a
store whose rows are all on the device through one
``FlatExecutor.search_multi(..., candidate_lists=...)`` call: one launch of
kernel 9's list form, each request over its scope's sorted id list. On the
CPU ``ops`` routes the launch to the plain version (``ref.py``). Each
request must equal its own ``dsq`` (kernel 1 over the gathered rows) bit for
bit and the reference database's answer within tolerance; int8 / PQ gather
groups and every gather group of a tiered store keep one call each.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import paths as P  # noqa: E402
from repro_torch.vectordb.flat import FlatExecutor  # noqa: E402
from repro_torch.vectordb.planner import BatchAccounting  # noqa: E402
from repro_torch.vectordb.store import VectorStore  # noqa: E402

from test_torch_vectordb import (DIM, _assert_bitwise,  # noqa: E402
                                 _assert_matches_ref, _port_db, _ref_db,
                                 _wiki)

K = 10


@pytest.fixture(scope="module")
def wiki():
    return _wiki()


@pytest.fixture(scope="module")
def dbs(wiki):
    return _port_db(wiki), _ref_db(wiki, "triehi")


def _scopes(db, lo, hi, count):
    """``count`` recursive anchors whose scopes hold lo..hi rows."""
    idx = db.namespaces["fs"]
    out = []
    for d in idx.list_dirs():
        path = P.to_str(d)
        if lo <= len(idx.resolve(path, recursive=True).to_array()) <= hi:
            out.append(path)
            if len(out) == count:
                return out
    raise AssertionError(f"fewer than {count} scopes of {lo}..{hi} rows")


def _batch(db, wiki, paths, **kw):
    q = wiki.queries[np.arange(len(paths)) % len(wiki.queries)]
    res = db.dsq_batch(q, paths, k=K, recursive=True, **kw)
    loop = [db.dsq(q[i], paths[i], k=K, recursive=True, **kw)
            for i in range(len(paths))]
    return q, res, loop


def _fp32_paths(db):
    """Four fp32 gather scopes and the root's scan: one scope smaller than
    k, one shared by three requests, the scan's requests between gather
    ones."""
    small = _scopes(db, 1, K - 1, 1)[0]
    shared = _scopes(db, 11, 40, 1)[0]
    mid = _scopes(db, 41, 150, 2)
    return [small, shared, "/", mid[0], shared, mid[1], "/", shared]


def test_fp32_gather_scopes_rank_in_one_call(dbs, wiki):
    port, ref = dbs
    paths = _fp32_paths(port)
    q, res, loop = _batch(port, wiki, paths)
    _assert_bitwise(res, loop, "listed batch vs loop of dsq")
    for i, r in enumerate(ref.dsq_batch(q, paths, k=K, recursive=True)):
        assert res[i].plan == r.plan, i
        _assert_matches_ref(res[i], r, f"listed batch {i}")
    acct = res[0].batch
    assert acct.plan_groups == {"gather": 4, "scan": 1}
    assert acct.gather_listed == 4
    assert acct.launches == 2 and acct.rank_syncs == 4
    small = res[0]
    assert small.scope_size < K
    assert (small.ids[0, small.scope_size:] == -1).all()
    assert np.isneginf(small.scores[0, small.scope_size:]).all()
    assert [r.scope_shared for r in res[1::3]] == [3, 3, 3]


@pytest.mark.parametrize("mix", ["int8_only", "int8_and_fp32"])
def test_int8_gather_scopes_past_the_window_keep_their_calls(dbs, wiki,
                                                             mix):
    """int8 gather groups (scopes past the 40-row rescore window) are one
    call each; fp32 groups beside them (scopes inside the window) still
    share the list launch."""
    port, ref = dbs
    wide = _scopes(port, 41, 150, 3)
    narrow = _scopes(port, 11, 40, 2) if mix == "int8_and_fp32" else []
    paths = wide + ["/"] + narrow + wide[:1]
    q, res, loop = _batch(port, wiki, paths, precision="int8")
    _assert_bitwise(res, loop, f"{mix} batch vs loop of dsq")
    rb = ref.dsq_batch(q, paths, k=K, recursive=True, precision="int8")
    for i, r in enumerate(rb):
        _assert_matches_ref(res[i], r, f"{mix} batch {i}")
    acct = res[0].batch
    assert acct.precision_groups == (
        {"int8": 4, "fp32": 2} if narrow else {"int8": 4})
    assert acct.gather_listed == len(narrow)
    listed = 1 if narrow else 0
    # the reference counts a launch per gather group and per scan launch
    assert acct.launches == rb[0].batch.launches - len(narrow) + listed


def test_tiered_store_keeps_one_call_per_gather_scope(wiki):
    """Over its device byte budget the store's fp32 rows live in host RAM:
    each gather group is its own call, and the fp32 ones answer as the
    list launch does on the same store untiered."""
    db = _port_db(wiki)
    small = _scopes(db, 1, K - 1, 1)[0]
    a, b = _scopes(db, 11, 40, 2)          # inside the rescore window
    paths = [small, a, b, a]
    _, untiered, _ = _batch(db, wiki, paths)
    assert untiered[0].batch.gather_listed == 3
    db.store.set_device_budget(db.store.nbytes() // 3)
    assert db.store.tiered_active()
    _, res, loop = _batch(db, wiki, paths)
    _assert_bitwise(res, loop, "tiered batch vs loop of dsq")
    acct = res[0].batch
    assert acct.tiered and acct.gather_listed == 0
    assert acct.precision_groups == {"fp32": 3}
    assert acct.launches == 3
    _assert_bitwise(res, untiered, "tiered vs untiered")


def test_sharded_gather_scopes_ride_the_flat_list_launch(wiki):
    db = _port_db(wiki)
    db.build_ann("sharded", n_shards=4)
    paths = _fp32_paths(db)
    q = wiki.queries[np.arange(len(paths)) % len(wiki.queries)]
    flat = db.dsq_batch(q, paths, k=K, recursive=True)
    sharded = db.dsq_batch(q, paths, k=K, recursive=True,
                           executor="sharded")
    _assert_bitwise(sharded, flat, "sharded vs flat")
    assert sharded[0].batch.gather_listed == flat[0].batch.gather_listed == 4


def test_merge_sums_gather_listed(dbs, wiki):
    port, _ = dbs
    paths = _fp32_paths(port)
    a = _batch(port, wiki, paths)[1][0].batch
    b = _batch(port, wiki, paths[:2])[1][0].batch
    total = BatchAccounting().merge(a).merge(b)
    assert total.gather_listed == a.gather_listed + b.gather_listed == 6
    assert total.snapshot()["gather_listed"] == 6


def _store(metric, n=1500, seed=4):
    rows = np.random.default_rng(seed).normal(size=(n, DIM))
    st = VectorStore(DIM, metric, device="cpu")
    st.add(rows.astype(np.float32))
    return st


@pytest.mark.parametrize("metric", ["ip", "l2", "cos"])
def test_search_multi_lists_equal_gather_searches(metric):
    """Each request of a listed call equals its own gather-plan ``search``
    bit for bit: lists of 5 to 400 ids, one with three requests, one with
    a tie (a duplicated row) broken toward the lower store id."""
    st = _store(metric)
    st.append_rows(st.vectors[17:18])                  # row 1500 == row 17
    g = np.random.default_rng(5)
    lists = [np.sort(g.choice(len(st), m, replace=False)).astype(np.uint32)
             for m in (5, 60, 400)]
    lists.append(np.array([3, 17, 900, 1500], np.uint32))
    sids = np.array([1, 0, 3, 1, 2, 1, 3])
    q = g.normal(size=(len(sids), DIM)).astype(np.float32)
    q[2] = st.vectors[17]
    ex = FlatExecutor(st)
    s, i = ex.search_multi(q, None, sids, K, candidate_lists=lists)
    for b, sid in enumerate(sids):
        ws, wi = ex.search(q[b:b + 1], K, candidate_ids=lists[sid],
                           plan="gather")
        np.testing.assert_array_equal(i[b:b + 1], wi, err_msg=str(b))
        np.testing.assert_array_equal(s[b:b + 1], ws, err_msg=str(b))
    assert (i[1, 5:] == -1).all() and np.isneginf(s[1, 5:]).all()
    top = i[2, :2].tolist()
    assert 17 in top and 1500 in top and top.index(17) < top.index(1500)


def test_search_multi_lists_refuse_what_they_cannot_rank():
    st = _store("ip")
    ex = FlatExecutor(st)
    lists = [np.arange(20, dtype=np.uint32)]
    q = np.ones((1, DIM), np.float32)
    with pytest.raises(ValueError, match="fp32"):
        ex.search_multi(q, None, [0], K, precision="int8",
                        candidate_lists=lists)
    with pytest.raises(ValueError, match="mask words"):
        ex.search_multi(q, torch.zeros((1, 47), dtype=torch.int32), [0], K,
                        candidate_lists=lists)
    st.set_device_budget(st.nbytes() // 3)
    with pytest.raises(RuntimeError, match="budget"):
        ex.search_multi(q, None, [0], K, candidate_lists=lists)


def test_list_launch_refuses_a_per_list_below_its_probes():
    """``per_list`` sizes the grid's query tiles, so one below the most
    queries that probe a list would drop the rest: refused when the ids
    are checked, and a value below 1 always."""
    from repro_torch.kernels import ops
    st = _store("ip")
    rows = st.device_vectors()
    ids = torch.arange(40, dtype=torch.int32)
    offsets = torch.tensor([0, 20], dtype=torch.int64)
    aligned = torch.tensor([20, 20], dtype=torch.int64)
    probe = torch.tensor([[0], [1], [1], [1]], dtype=torch.int32)
    q = torch.ones((4, DIM))
    ones = torch.full((1, -(-len(st) // 32)), -1, dtype=torch.int32)
    zeros = torch.zeros(4, dtype=torch.int32)

    def launch(per_list, check_ids=True):
        return ops.ivf_probe_topk(q, rows, offsets, aligned, ids, 20, probe,
                                  ones, zeros, K, check_ids=check_ids,
                                  per_list=per_list)
    want = launch(None)
    for got in (launch(3), launch(4)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="probed by 3 queries"):
        launch(2)
    for bad in (0, -1):
        with pytest.raises(ValueError, match=">= 1"):
            launch(bad, check_ids=False)
