"""The port's sharded serving tier (``repro_torch.vectordb.sharded``,
``repro_torch.distributed.search``, ``repro_torch.launch.mesh``) on the CPU,
on ``tests/test_sharded.py``'s and ``tests/test_distributed.py``'s setups.

The shards are row ranges of a :class:`ShardMesh` whose entries are all
the CPU, so 1, 4 and 8 shards run in this process (the reference needs a
subprocess with simulated devices; its ``multidevice`` cases are the
8-shard cases here). Against the port's flat executor every comparison is
bitwise (ids and score bits) at fp32, int8 and PQ, also after a
``dsm_batch``, an ingest, tombstones and a compaction. Against the
reference's flat ``DirectoryVectorDB`` on the same seeded numpy inputs the
ids agree (ties within 1e-5 aside) and the scores within 1e-5; the
reference's own sharded executor is never the oracle (it drifts 1 ulp from
its flat executor on this JAX). The port runs with ``device="cpu"``;
every ``result()`` has a timeout.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.distributed import search as dsearch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import (ShardMesh,  # noqa: E402
                                     make_mesh_for_devices,
                                     mesh_device_count)
from repro_torch.serving import (ContextDatabase, RAGConfig,  # noqa: E402
                                 ScheduledDSQ, SchedulerConfig)
from repro_torch.vectordb import (DirectoryVectorDB,  # noqa: E402
                                  MaintenancePolicy, ShardedExecutor,
                                  VectorStore, model_of)

D = 16
TOL = 1e-5
WAIT = 30.0
SHARDS = (1, 4, 8)
PRECISIONS = (("fp32", None), ("int8", None), ("pq", 40))


def _paths(n):
    return [f"/a/b{i % 7}/" if i % 3 else "/a/" for i in range(n)]


def _mixed_db(n_shards=1, strategy="triehi", n=600, seed=0, ref_too=False,
              **sharded):
    """``tests/test_sharded.py``'s db in the port, with the flat and sharded
    executors; with ``ref_too`` also the reference's flat db on the same
    rows, and the port's PQ codebook taken from it."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, D)).astype(np.float32)
    db = DirectoryVectorDB(dim=D, scope_strategy=strategy,
                           calibration=False, device="cpu")
    db.ingest(rows, _paths(n))
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=n_shards, **sharded)
    if not ref_too:
        return db, rng
    rdb = RefDB(dim=D, scope_strategy=strategy, calibration=False)
    rdb.ingest(rows, _paths(n))
    rdb.build_ann("flat")
    db.store.set_pq_codebook(rdb.store.pq_codebook.centroids, len(db.store))
    return db, rng, rdb


def _assert_bitwise(res_a, res_b, label=""):
    assert len(res_a) == len(res_b)
    for i, (a, b) in enumerate(zip(res_a, res_b)):
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{label} {i}")
        np.testing.assert_array_equal(a.scores, b.scores,
                                      err_msg=f"{label} {i}")
        assert a.scope_size == b.scope_size, label


def _assert_like_reference(mine, theirs, label=""):
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert a.scope_size == b.scope_size, label
        err = ref.topk_disagreement(a.ids, a.scores, np.asarray(b.ids),
                                    np.asarray(b.scores), TOL)
        assert err is None, f"{label} request {i}: {err}"
        fin = np.isfinite(np.asarray(b.scores))
        np.testing.assert_array_equal(np.isfinite(a.scores), fin)
        np.testing.assert_allclose(a.scores[fin], np.asarray(b.scores)[fin],
                                   rtol=TOL, atol=TOL)


def _batch(db, q, scopes, executor, prec="fp32", rk=None, k=5, **kw):
    return db.dsq_batch(q, scopes, k=k, executor=executor, precision=prec,
                        rescore_k=rk, **kw)


# ------------------------------------------------------------------ mesh
def test_mesh_layout_and_counts():
    mesh = make_mesh_for_devices(device="cpu", n_shards=4)
    assert isinstance(mesh, ShardMesh) and mesh_device_count(mesh) == 4
    assert all(d.type == "cpu" for d in mesh)
    assert len(make_mesh_for_devices(device="cpu")) == 1
    with pytest.raises(ValueError):
        make_mesh_for_devices(device="cpu", n_shards=0)
    with pytest.raises(ValueError):
        ShardMesh([])


def test_cuda_mesh_without_a_card_raises():
    """No shard carries on on the CPU when its mesh names a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_for_devices()
    st = VectorStore(D, device="cpu")
    st.add(np.zeros((40, D), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedExecutor(st, mesh=["cuda", "cuda"])


# -------------------------------------------------------- distributed search
@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_scoped_search_exact(n_shards):
    """``make_scoped_search`` (kernel 1 per shard + merge) against numpy,
    and bitwise against one launch over all rows."""
    mesh = make_mesh_for_devices(device="cpu", n_shards=n_shards)
    n, d, k, q = 1024, 32, 10, 4
    rng = np.random.default_rng(0)
    db = rng.normal(size=(n, d)).astype(np.float32)
    mask = (rng.random(n) < 0.3).astype(np.int8)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    fn = dsearch.make_scoped_search(mesh, n, d, k)
    scores, ids = fn(dsearch.shard_rows(mesh, db, n),
                     dsearch.shard_rows(mesh, mask, n),
                     torch.from_numpy(queries))
    want = queries @ db.T
    want[:, mask == 0] = -np.inf
    np.testing.assert_allclose(scores.numpy(), -np.sort(-want, axis=1)[:, :k],
                               rtol=1e-4, atol=1e-4)
    for qi in range(q):
        for s, i in zip(scores[qi].numpy(), ids[qi].numpy()):
            assert mask[i]
            np.testing.assert_allclose(want[qi, i], s, rtol=1e-4)
    one_v, one_i = ops.scoped_topk(torch.from_numpy(queries),
                                   torch.from_numpy(db),
                                   torch.from_numpy(mask), k)
    assert torch.equal(scores, one_v) and torch.equal(ids, one_i.long())


@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_multi_scope_search_exact(n_shards):
    """``make_multi_scope_search``: one call ranks a mixed-scope batch, each
    shard reading only the words covering its rows."""
    from repro_torch.core.idset import RoaringBitmap
    mesh = make_mesh_for_devices(device="cpu", n_shards=n_shards)
    n, d, k, q, S = 1024, 32, 10, 6, 3
    rng = np.random.default_rng(0)
    db = rng.normal(size=(n, d)).astype(np.float32)
    scopes = [RoaringBitmap(np.nonzero(rng.random(n) < 0.3)[0]
                            .astype(np.uint32)) for _ in range(S)]
    words = np.stack([s.to_words(n) for s in scopes])
    sids = rng.integers(0, S, size=q).astype(np.int32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    fn = dsearch.make_multi_scope_search(mesh, n, d, k)
    scores, ids = fn(dsearch.shard_rows(mesh, db, n),
                     dsearch.shard_words(mesh, words, n), sids,
                     torch.from_numpy(queries))
    masks = np.stack([s.to_bool_mask(n) for s in scopes])
    want = queries @ db.T
    want[~masks[sids]] = -np.inf
    np.testing.assert_allclose(scores.numpy(), -np.sort(-want, axis=1)[:, :k],
                               rtol=1e-4, atol=1e-4)
    for qi in range(q):
        for s, i in zip(scores[qi].numpy(), ids[qi].numpy()):
            assert masks[sids[qi], i]
    one_v, one_i = ops.multi_scope_topk(
        torch.from_numpy(queries), torch.from_numpy(db), ops.as_words(words),
        torch.from_numpy(sids), k)
    assert torch.equal(scores, one_v) and torch.equal(ids, one_i.long())


def test_merge_keeps_empty_lanes_and_tie_order():
    """A local -1 stays -1 (never ``s * n_loc - 1``, a row of the previous
    shard), and equal scores rank by the lower global id."""
    neg = ref.NEG_INF
    vals = [torch.tensor([[2.0, 1.0, neg]]), torch.tensor([[2.0, neg, neg]]),
            torch.tensor([[neg, neg, neg]])]
    ids = [torch.tensor([[7, 3, -1]], dtype=torch.int32),
           torch.tensor([[0, -1, -1]], dtype=torch.int32),
           torch.tensor([[-1, -1, -1]], dtype=torch.int32)]
    v, i = dsearch.merge_local_topk(vals, ids, n_loc=32, k=5)
    assert i.tolist() == [[7, 32, 3, -1, -1]]
    assert v[0, :3].tolist() == [2.0, 2.0, 1.0]
    assert (v[0, 3:] == neg).all()


# --------------------------------------------------- batch parity with flat
@pytest.mark.parametrize("strategy", ["triehi", "pe_online", "pe_offline"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_batch_matches_flat(strategy, n_shards):
    db, rng = _mixed_db(n_shards, strategy)
    B = 12
    q = rng.normal(size=(B, D)).astype(np.float32)
    scopes = [["/a/", "/a/b1/", "/", "/a/b2/"][i % 4] for i in range(B)]
    rec = [bool(i % 3) for i in range(B)]
    exc = [["/a/b1/"] if i % 5 == 0 else [] for i in range(B)]
    kw = dict(k=5, recursive=rec, exclude=exc)
    _assert_bitwise(db.dsq_batch(q, scopes, executor="flat", **kw),
                    db.dsq_batch(q, scopes, executor="sharded", **kw))
    for i in range(B):           # the per-request front door, too
        a = db.dsq(q[i], scopes[i], k=5, executor="flat")
        b = db.dsq(q[i], scopes[i], k=5, executor="sharded")
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.ids, b.ids)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_three_precisions_bitwise_and_like_reference(n_shards):
    """fp32 / int8 / PQ batches on 1, 4, 8 shards equal the port's flat
    batch bit for bit, a loop of ``dsq(executor="sharded")`` equals a loop
    over flat, and both match the reference's flat batch; again after a
    ``dsm_batch`` and after a compaction."""
    db, rng, rdb = _mixed_db(n_shards, ref_too=True)
    B = 8
    q = rng.normal(size=(B, D)).astype(np.float32)
    scopes = [["/a/", "/", "/a/b2/", "/a/b1/"][i % 4] for i in range(B)]

    def check(label, with_ref=True):
        for prec, rk in PRECISIONS:
            mine = _batch(db, q, scopes, "sharded", prec, rk)
            _assert_bitwise(_batch(db, q, scopes, "flat", prec, rk), mine,
                            f"{label} {prec}")
            if with_ref:
                _assert_like_reference(
                    mine, _batch(rdb, q, scopes, "flat", prec, rk),
                    f"{label} {prec} vs reference")
        for i in (0, 1, 2):
            for prec, rk in PRECISIONS:
                a = db.dsq(q[i], scopes[i], k=5, executor="flat",
                           precision=prec, rescore_k=rk)
                b = db.dsq(q[i], scopes[i], k=5, executor="sharded",
                           precision=prec, rescore_k=rk)
                np.testing.assert_array_equal(a.ids, b.ids)
                np.testing.assert_array_equal(a.scores, b.scores)

    check("fresh")
    ops_ = [("mkdir", "/z/"), ("move", "/a/b1/", "/z/"),
            ("merge", "/a/b3/", "/a/b4/"), ("remove", "/a/b5/")]
    for d in (db, rdb):
        d.dsm_batch(ops_)
    check("after dsm")
    ex = db.executors["sharded"]
    p0 = ex.masks_patched
    db.maintenance(policy=MaintenancePolicy(tombstone_fraction=0.01,
                                            tombstone_min=1)).run_all()
    assert db.store.n_deleted == 0 and ex.masks_patched > p0
    check("after compaction", with_ref=False)


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_sharded_metrics_match_flat(metric):
    """l2 and cos at three precisions on 4 shards: bitwise equal to flat on
    the CPU (each shard's l2 norms are its rows' own sums, one per row, as
    the store's are; on a card l2 is held to the reference's tolerance)."""
    rng = np.random.default_rng(2)
    db = DirectoryVectorDB(dim=D, metric=metric, calibration=False,
                           device="cpu")
    db.ingest(rng.normal(size=(600, D)).astype(np.float32), _paths(600))
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=4)
    q = rng.normal(size=(8, D)).astype(np.float32)
    scopes = ["/", "/a/", "/a/b1/", "/a/b2/"] * 2
    for prec, rk in PRECISIONS:
        _assert_bitwise(_batch(db, q, scopes, "flat", prec, rk),
                        _batch(db, q, scopes, "sharded", prec, rk),
                        f"{metric} {prec}")


def test_sharded_scope_table_hits_and_accounting():
    db, rng = _mixed_db(4)
    ex = db.executors["sharded"]
    B = 8
    q = rng.normal(size=(B, D)).astype(np.float32)
    scopes = ["/a/", "/"] * (B // 2)
    acct = db.dsq_batch(q, scopes, k=5, executor="sharded")[0].batch
    assert acct.n_shards == ex.n_shards == 4
    assert acct.shard_mask_bytes > 0 and acct.shard_db_bytes > 0
    assert acct.collective_bytes == 4 * B * 5 * 8
    m0 = ex.mask_bytes_uploaded
    r2 = db.dsq_batch(q, scopes, k=5, executor="sharded")[0].batch
    assert ex.mask_bytes_uploaded == m0       # token-validated slot hits
    assert r2.shard_mask_hits == r2.plan_groups.get("scan")
    assert r2.shard_mask_bytes == 0 and r2.shard_db_bytes == 0
    assert ex.stats()["slots"] == 2 and ex.stats()["n_shards"] == 4


def test_sharded_table_grows_past_slot_capacity():
    """More unique scan scopes than slots: the table grows (a same-batch
    eviction would rank requests against the wrong words)."""
    db, rng = _mixed_db(4, table_slots=2)
    ex = db.executors["sharded"]
    B = 12
    q = rng.normal(size=(B, D)).astype(np.float32)
    paths = ["/"] * B
    exc = [[f"/a/b{i % 6}/"] for i in range(B)]   # 6 unique broad scopes
    _assert_bitwise(db.dsq_batch(q, paths, k=5, exclude=exc,
                                 executor="flat"),
                    db.dsq_batch(q, paths, k=5, exclude=exc,
                                 executor="sharded"))
    assert ex.table_slots >= 6


def test_sharded_dsm_delta_patches_resident_masks():
    db, rng = _mixed_db(4)
    ex = db.executors["sharded"]
    B = 8
    q = rng.normal(size=(B, D)).astype(np.float32)
    db.dsq_batch(q, ["/a/", "/"] * (B // 2), k=5, executor="sharded")
    m0, p0 = ex.mask_bytes_uploaded, ex.masks_patched
    db.dsm_batch([("mkdir", "/z/"), ("move", "/a/b1/", "/z/")])
    assert ex.masks_patched > p0 and ex.mask_bytes_patched > 0
    # only the words spanning the moved aggregate were copied
    full = ex.view.n_words * 4
    assert ex.mask_bytes_patched < (ex.masks_patched - p0) * full
    _assert_bitwise(db.dsq_batch(q, ["/a/", "/"] * (B // 2), k=5,
                                 executor="flat"),
                    db.dsq_batch(q, ["/a/", "/"] * (B // 2), k=5,
                                 executor="sharded"))
    assert ex.mask_bytes_uploaded == m0, "patched slots re-uploaded"


def test_sharded_view_incremental_resharding():
    db, rng = _mixed_db(4, n=600)
    ex = db.executors["sharded"]
    q = rng.normal(size=(4, D)).astype(np.float32)
    db.dsq_batch(q, ["/"] * 4, k=5, executor="sharded")
    cap0, r0, b0 = ex.view.cap, ex.view.reshards, ex.view.db_bytes_uploaded
    n_new = cap0 - len(db.store)
    assert n_new > 0 and cap0 % (32 * 4) == 0
    db.ingest(rng.normal(size=(n_new, D)).astype(np.float32),
              ["/a/"] * n_new)
    _assert_bitwise(db.dsq_batch(q, ["/", "/a/"] * 2, k=5, executor="flat"),
                    db.dsq_batch(q, ["/", "/a/"] * 2, k=5,
                                 executor="sharded"))
    assert ex.view.reshards == r0
    assert ex.view.db_bytes_uploaded - b0 == n_new * D * 4
    db.ingest(rng.normal(size=(8, D)).astype(np.float32), ["/a/"] * 8)
    _assert_bitwise(db.dsq_batch(q, ["/", "/a/"] * 2, k=5, executor="flat"),
                    db.dsq_batch(q, ["/", "/a/"] * 2, k=5,
                                 executor="sharded"))
    assert ex.view.reshards == r0 + 1 and ex.view.cap == 2 * cap0


@pytest.mark.parametrize("tier", ["int8", "pq"])
def test_sharded_view_code_mirrors_incremental(tier):
    """The int8 and PQ mirrors (``tests/test_quantized.py``'s and
    ``test_pq.py``'s sharded cases): copied rows equal the store's codes
    across 4 shards, in-capacity growth copies only the new rows, growth
    past capacity rebuilds at the doubled capacity."""
    rng = np.random.default_rng(3)
    st = VectorStore(D, "ip", device="cpu")
    st.add(rng.normal(size=(40, D)).astype(np.float32))
    ex = ShardedExecutor(st, n_shards=4)

    def mirror():
        if tier == "int8":
            codes, scales = ex.view.q_device()
            np.testing.assert_array_equal(
                torch.cat(scales).numpy()[: len(st)], st.q_scales)
            return torch.cat(codes).numpy(), st.q_vectors
        return torch.cat(ex.view.pq_device()).numpy(), st.pq_codes

    def uploaded():
        return (ex.view.q_bytes_uploaded if tier == "int8"
                else ex.view.pq_bytes_uploaded)

    ex.sync()
    got, want = mirror()
    assert got.shape[0] == ex.view.cap
    np.testing.assert_array_equal(got[:40], want)
    up0 = uploaded()
    st.add(rng.normal(size=(2, D)).astype(np.float32))
    ex.sync()
    got, want = mirror()
    np.testing.assert_array_equal(got[:42], want)
    per_row = D + 4 if tier == "int8" else st.pq_codebook.m
    assert uploaded() - up0 == 2 * per_row
    st.add(rng.normal(size=(ex.view.cap, D)).astype(np.float32))
    ex.sync()
    got, want = mirror()
    assert got.shape[0] == ex.view.cap
    np.testing.assert_array_equal(got[: len(st)], want)


def test_sharded_alive_mask_patches_incrementally():
    db, rng = _mixed_db(4)
    ex = db.executors["sharded"]
    q = rng.normal(size=(4, D)).astype(np.float32)
    db.dsq_batch(q, ["/"] * 4, k=5, executor="sharded")
    full = ex.view.n_words * 4
    a0 = ex.view.alive_bytes_uploaded
    assert a0 >= full
    db.delete(1)
    _assert_bitwise(db.dsq_batch(q, ["/"] * 4, k=5, executor="flat"),
                    db.dsq_batch(q, ["/"] * 4, k=5, executor="sharded"))
    assert 0 < ex.view.alive_bytes_uploaded - a0 < full


def test_sharded_tombstones_and_rmdir():
    db, rng = _mixed_db(4)
    q = rng.normal(size=(6, D)).astype(np.float32)
    db.delete(0)
    db.delete(5)
    db.rmdir("/a/b3/")
    scopes = ["/", "/a/", "/a/b1/"] * 2
    _assert_bitwise(db.dsq_batch(q, scopes, k=5, executor="flat"),
                    db.dsq_batch(q, scopes, k=5, executor="sharded"))
    for r in db.dsq_batch(q, scopes, k=20, executor="sharded"):
        ids = r.ids[r.ids >= 0]
        assert 0 not in ids and 5 not in ids


def test_sharded_scan_masks_stale_tombstoned_candidates():
    """A caller-supplied id set holding tombstones: the shards AND the
    alive words, so deleted rows never resurface on the scan plan, at any
    precision (``tests/test_pq.py``'s tombstone case)."""
    st = VectorStore(D, "ip", device="cpu")
    rng = np.random.default_rng(4)
    st.add(rng.normal(size=(600, D)).astype(np.float32))
    ex = ShardedExecutor(st, n_shards=4)
    q = rng.normal(size=(2, D)).astype(np.float32)
    allc = np.arange(600, dtype=np.uint32)
    top = ex.search(q, 5, candidate_ids=allc, plan="scan")[1][0]
    st.mark_deleted(top[:2])
    for prec in ("fp32", "int8", "pq"):
        _, got = ex.search(q, 5, candidate_ids=allc, plan="scan",
                           precision=prec)
        assert not set(got.ravel().tolist()) & set(top[:2].tolist()), prec


def test_sharded_pq_exhaustive_rescore_equals_fp32():
    st = VectorStore(D, "ip", device="cpu")
    rng = np.random.default_rng(5)
    st.add(rng.normal(size=(3000, D)).astype(np.float32))
    ex = ShardedExecutor(st, n_shards=4)
    q = rng.normal(size=(4, D)).astype(np.float32)
    scope = np.arange(0, 3000, 2, dtype=np.uint32)
    sf, i_f = ex.search(q, 10, candidate_ids=scope, plan="scan")
    for prec in ("int8", "pq"):
        sp, ip_ = ex.search(q, 10, candidate_ids=scope, plan="scan",
                            precision=prec, rescore_k=1500)
        np.testing.assert_array_equal(i_f, ip_)
        np.testing.assert_array_equal(sf, sp)


@pytest.mark.parametrize("n_shards", (4, 8))
def test_empty_lanes_of_a_small_scope_in_a_later_shard(n_shards):
    """A scope smaller than k wholly inside shard 1 or later: its empty
    lanes are -1 / -inf as on flat, never ``s * n_loc - 1``."""
    n = 1024
    rng = np.random.default_rng(6)
    db = DirectoryVectorDB(dim=D, calibration=False, device="cpu")
    paths = ["/big/"] * n
    ex_ids = list(range(700, 703))
    for i in ex_ids:
        paths[i] = "/small/"
    db.ingest(rng.normal(size=(n, D)).astype(np.float32), paths)
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=n_shards)
    ex = db.executors["sharded"]
    ex.sync()
    assert ex_ids[0] // ex.view.n_loc >= 1
    q = rng.normal(size=(3, D)).astype(np.float32)
    words = np.zeros(ex.view.n_words, np.uint32)
    words[ex_ids[0] >> 5] = np.uint32(sum(1 << (i & 31) for i in ex_ids))
    table = dsearch.shard_words(ex.mesh, words[None, :], ex.view.cap)
    for prec in ("fp32", "int8", "pq"):
        if prec == "fp32":
            s, i = ex._launch(q, table, np.zeros(3, np.int32), 10)
        else:
            launch = ex._launch_i8 if prec == "int8" else ex._launch_pq
            i = launch(q, table, np.zeros(3, np.int32), 10)
            s = None
        assert (i[:, 3:] == -1).all() and set(i[:, :3].ravel()) == set(ex_ids)
        if s is not None:
            assert np.isneginf(s[:, 3:]).all()
    for prec, rk in PRECISIONS:
        # "/small/" is a gather scope; forced onto the shards by plan="scan"
        a = db.executors["flat"].search(q, 10, ex_ids, plan="scan",
                                        precision=prec, rescore_k=rk)
        b = ex.search(q, 10, ex_ids, plan="scan", precision=prec,
                      rescore_k=rk)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])
        assert (b[1][:, 3:] == -1).all()


def test_depth_threshold_both_sides():
    """``scan_on_mesh``: a per-shard depth that fits the shards' rows runs
    on them; one past ``n_loc`` runs the flat twin (the same kernels over
    the whole store). Both sides equal the flat batch."""
    db, rng = _mixed_db(8)                  # cap 1024, n_loc 128
    ex = db.executors["sharded"]
    q = rng.normal(size=(6, D)).astype(np.float32)
    scopes = ["/", "/a/"] * 3
    db.dsq_batch(q, scopes, k=5, executor="sharded")
    assert ex.view.n_loc == 128
    for rk, on_mesh in ((128, True), (129, False)):
        assert ex.scan_on_mesh(5, "int8", rk) is on_mesh
        l0 = ex.launches
        _assert_bitwise(_batch(db, q, scopes, "flat", "int8", rk),
                        _batch(db, q, scopes, "sharded", "int8", rk),
                        f"rescore_k={rk}")
        assert (ex.launches > l0) is on_mesh
    assert ex.scan_on_mesh(128, "fp32") and not ex.scan_on_mesh(129, "fp32")


def test_sharded_int8_two_phase_matches_flat_int8():
    """Two-phase int8 on 4 shards equals the flat int8 batch bit for bit,
    and with an exhaustive window the exact fp32 result's ids."""
    db, rng = _mixed_db(4)
    B = 8
    q = rng.normal(size=(B, D)).astype(np.float32)
    scopes = [["/a/", "/", "/a/b2/"][i % 3] for i in range(B)]
    exact = db.dsq_batch(q, scopes, k=5, executor="sharded")
    for rk in (64, len(db.store)):
        sh = _batch(db, q, scopes, "sharded", "int8", rk)
        _assert_bitwise(_batch(db, q, scopes, "flat", "int8", rk), sh)
    for a, b in zip(sh, exact):
        assert set(a.ids[0].tolist()) == set(b.ids[0].tolist())
    acct = sh[0].batch
    assert acct.db_bytes_int8 and acct.rescore_candidates


# ---------------------------------------------------- the 8-shard cases
def test_sharded_int8_8_shards():
    """``test_sharded_int8_8dev``: 8-shard int8 with an exhaustive window
    equals the exact result, and tombstones stay masked."""
    rng = np.random.default_rng(5)
    db = DirectoryVectorDB(dim=D, calibration=False, device="cpu")
    paths = [f"/a/b{i % 5}/" if i % 2 else "/c/" for i in range(900)]
    db.ingest(rng.normal(size=(900, D)).astype(np.float32), paths)
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=8)
    assert db.executors["sharded"].n_shards == 8
    q = rng.normal(size=(6, D)).astype(np.float32)
    scopes = [["/a/", "/", "/c/"][i % 3] for i in range(6)]
    exact = db.dsq_batch(q, scopes, k=5, executor="sharded")
    sh = _batch(db, q, scopes, "sharded", "int8", 900)
    for a, b in zip(sh, exact):
        assert set(a.ids[0].tolist()) == set(b.ids[0].tolist())
    dead = [int(x) for x in exact[1].ids[0][:2]]
    for eid in dead:
        db.delete(eid)
    after = _batch(db, q, scopes, "sharded", "int8", 900)
    assert not ({int(x) for r in after for x in r.ids[0]} & set(dead))


def test_sharded_batch_bit_identical_8_shards():
    """``test_sharded_batch_bit_identical_8dev``: 8 shards equal the flat
    batch, also right after a ``dsm_batch`` of move / merge / remove with
    the resident masks patched, not re-uploaded."""
    rng = np.random.default_rng(1)
    n, d, B = 2000, 32, 24
    paths = [f"/w/p{i % 9}/" if i % 4 else "/w/" for i in range(n)]
    db = DirectoryVectorDB(dim=d, calibration=False, device="cpu")
    db.ingest(rng.normal(size=(n, d)).astype(np.float32), paths)
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=8)
    ex = db.executors["sharded"]
    q = rng.normal(size=(B, d)).astype(np.float32)
    scopes = [["/w/", "/w/p1/", "/", "/w/p3/", "/w/p4/"][i % 5]
              for i in range(B)]
    rec = [bool(i % 3) for i in range(B)]
    _assert_bitwise(db.dsq_batch(q, scopes, k=10, recursive=rec,
                                 executor="flat"),
                    db.dsq_batch(q, scopes, k=10, recursive=rec,
                                 executor="sharded"))
    wide = ["/w/", "/"] * (B // 2)
    db.dsq_batch(q, wide, k=10, executor="sharded")
    m0 = ex.mask_bytes_uploaded
    db.dsm_batch([("mkdir", "/x/"), ("move", "/w/p1/", "/x/"),
                  ("merge", "/w/p3/", "/w/p4/"), ("remove", "/w/p5/")])
    _assert_bitwise(db.dsq_batch(q, wide, k=10, executor="flat"),
                    db.dsq_batch(q, wide, k=10, executor="sharded"))
    assert ex.masks_patched >= 1
    assert ex.mask_bytes_uploaded == m0, "survivors must not re-upload"


def test_sharded_ingest_reshard_8_shards():
    rng = np.random.default_rng(7)
    db = DirectoryVectorDB(dim=D, calibration=False, device="cpu")
    db.ingest(rng.normal(size=(300, D)).astype(np.float32), ["/a/"] * 300)
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=8)
    ex = db.executors["sharded"]
    q = rng.normal(size=(4, D)).astype(np.float32)
    db.dsq_batch(q, ["/"] * 4, k=5, executor="sharded")
    assert ex.view.cap % (32 * 8) == 0
    cap0, r0 = ex.view.cap, ex.view.reshards
    grow = cap0 - len(db.store)
    db.ingest(rng.normal(size=(grow, D)).astype(np.float32), ["/a/"] * grow)
    _assert_bitwise(db.dsq_batch(q, ["/"] * 4, k=5, executor="flat"),
                    db.dsq_batch(q, ["/"] * 4, k=5, executor="sharded"))
    assert ex.view.reshards == r0
    db.ingest(rng.normal(size=(1, D)).astype(np.float32), ["/a/"])
    _assert_bitwise(db.dsq_batch(q, ["/"] * 4, k=5, executor="flat"),
                    db.dsq_batch(q, ["/"] * 4, k=5, executor="sharded"))
    assert ex.view.reshards == r0 + 1 and ex.view.cap == 2 * cap0


# ------------------------------------------------------ concurrency, DSM
def test_concurrent_dsm_batch_against_sharded_batches():
    """A ``dsm_batch(max_workers=4)`` on another thread while sharded
    batches run: every batch completes with live, in-range ids, and once
    the DSM is done the sharded batch equals the flat one bit for bit.
    Whether a slot is patched or evicted under the race may vary."""
    db, rng = _mixed_db(4, n=1200)
    q = rng.normal(size=(8, D)).astype(np.float32)
    scopes = ["/a/", "/", "/a/b2/", "/a/b4/"] * 2
    db.dsq_batch(q, scopes, k=5, executor="sharded")
    errors, done = [], threading.Event()

    def dsm():
        try:
            db.dsm_batch([("mkdir", "/z/"), ("move", "/a/b1/", "/z/"),
                          ("merge", "/a/b3/", "/a/b6/"),
                          ("remove", "/a/b5/"), ("mkdir", "/y/")],
                         max_workers=4)
        except Exception as e:               # noqa: BLE001
            errors.append(e)
        finally:
            done.set()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=dsm)
        t.start()
        rounds = 0
        while not done.is_set() or rounds < 3:
            for r in db.dsq_batch(q, scopes, k=5, executor="sharded"):
                ids = r.ids[r.ids >= 0]
                assert (ids < len(db.store)).all()
            rounds += 1
        t.join(WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not t.is_alive()
    _assert_bitwise(db.dsq_batch(q, scopes, k=5, executor="flat"),
                    db.dsq_batch(q, scopes, k=5, executor="sharded"))
    ex = db.executors["sharded"]
    assert ex.masks_patched + ex.masks_evicted > 0


def test_rebuild_replaces_the_namespace_subscription():
    db, rng = _mixed_db(4)
    old = db.executors["sharded"]
    db.build_ann("sharded", n_shards=2)
    new = db.executors["sharded"]
    q = rng.normal(size=(4, D)).astype(np.float32)
    db.dsq_batch(q, ["/a/", "/"] * 2, k=5, executor="sharded")
    p_old = old.masks_patched + old.masks_evicted
    db.move("/a/b1/", "/")
    assert old.masks_patched + old.masks_evicted == p_old
    assert new.masks_patched + new.masks_evicted > 0
    db.namespace("extra")                    # a later namespace subscribes
    assert "extra" in db._sharded_subs


def test_compaction_patches_sharded_slots(tmp_path):
    """``tests/test_maintenance.py``'s compaction case: the sharded slots
    are patched through the remap (not evicted) and the sharded answers
    still equal flat's."""
    rng = np.random.default_rng(0)
    db = DirectoryVectorDB(dim=D, calibration=False, device="cpu",
                           journal_path=str(tmp_path / "db.journal"))
    for d in ("/a/", "/b/", "/a/sub/"):
        db.mkdir(d)
    ids = db.ingest(rng.normal(size=(400, D)).astype(np.float32),
                    [("/a/", "/b/", "/a/sub/")[i % 3] for i in range(400)])
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=4)
    ex = db.executors["sharded"]
    qs = np.random.default_rng(7).normal(size=(6, D)).astype(np.float32)
    db.dsq_batch(qs, ["/a/"] * 6, k=10, executor="sharded")
    slots = ex.stats()["slots"]
    for i in ids[:150]:
        db.delete(int(i))
    ev0, p0 = ex.masks_evicted, ex.masks_patched
    db.maintenance(policy=MaintenancePolicy(repair_deletes=10 ** 9)).run_all()
    assert len(db.store) == 250 and db.store.n_deleted == 0
    assert ex.masks_evicted == ev0 and ex.masks_patched - p0 >= slots > 0
    assert ex.view.cap == 512                # no re-shard
    for q in qs:
        for path in ("/a/", "/b/", "/"):
            a = db.dsq(q, path, k=10, executor="flat")
            b = db.dsq(q, path, k=10, executor="sharded")
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.scores, b.scores)
    _assert_bitwise(db.dsq_batch(qs, ["/a/", "/"] * 3, k=10,
                                 executor="flat"),
                    db.dsq_batch(qs, ["/a/", "/"] * 3, k=10,
                                 executor="sharded"))


# --------------------------------------------------------- serving, faults
@pytest.fixture(scope="module")
def wiki():
    from repro_torch.datasets import make_wiki_dir
    return make_wiki_dir(scale=0.002, dim=32, n_queries=24, seed=7)


def _wiki_db(wiki, n_shards=4):
    db = DirectoryVectorDB(dim=32, scope_strategy="triehi",
                           calibration=False, device="cpu")
    db.ingest(wiki.vectors, wiki.entry_paths)
    db.build_ann("flat")
    db.build_ann("sharded", n_shards=n_shards)
    return db


def _requests(wiki, n):
    paths = [(wiki.query_anchors[i % 6] or "/") for i in range(n)]
    paths[0] = "/"
    rec = [bool(wiki.query_recursive[i % 6]) for i in range(n)]
    return wiki.queries[:n], paths, rec


def test_scheduled_sharded_bit_identical_with_prepinned_slots(wiki):
    """``tests/test_serving.py``'s sharded case: a pumped batch equals the
    direct batch at three precisions, and the staged pre-pin makes every
    execute-time ``ensure_scope`` a hit."""
    db = _wiki_db(wiki)
    n = 12
    queries, paths, rec = _requests(wiki, n)
    for precision in ("fp32", "int8", "pq"):
        rk = 32 if precision != "fp32" else None
        kw = dict(k=8, executor="sharded", precision=precision, rescore_k=rk)
        direct = db.dsq_batch(queries, paths, recursive=rec, **kw)
        db.executors["sharded"]._slots.clear()     # force fresh pins
        db.executors["sharded"]._free = list(range(
            db.executors["sharded"].table_slots))
        sdsq = ScheduledDSQ(db, cfg=SchedulerConfig(max_batch=n,
                                                    max_wait_ms=1e4), **kw)
        tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
                   for i in range(n)]
        assert sdsq.pump() == n
        got = [t.result(WAIT) for t in tickets]
        _assert_bitwise(got, direct, precision)
        acct = got[0].batch
        assert acct.plan_groups.get("scan", 0) > 0
        assert acct.shard_mask_hits == acct.plan_groups["scan"]
        assert acct.shard_mask_bytes == 0


def test_bit_identity_after_racing_dsm_sharded(wiki):
    db = _wiki_db(wiki)
    n = 8
    queries, paths, rec = _requests(wiki, n)
    src = next(p for p in paths if p != "/")
    sdsq = ScheduledDSQ(db, k=8, executor="sharded",
                        cfg=SchedulerConfig(max_batch=n, max_wait_ms=1e4))
    sched = sdsq.scheduler
    tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
               for i in range(n)]
    with sched._cond:
        batch = sched._form_batch()
    staged, stage_s = sched._do_stage(batch)
    db.dsm_batch([("move", src, "/moved/")])
    sched._run_batch(batch, staged, stage_s, "test")
    direct = db.dsq_batch(queries, paths, k=8, recursive=rec,
                          executor="flat")
    _assert_bitwise([t.result(WAIT) for t in tickets], direct)
    assert sched.stage_faults == 0


def test_breaker_downshift_sharded_to_flat_then_recovery(wiki):
    """``tests/test_faults.py``'s breaker case on the sharded rung, tripped
    at the ``sharded.h2d`` seam: the ladder moves to flat int8 (equal to a
    direct flat int8 batch) and back to sharded fp32 once the breaker
    closes."""
    db = _wiki_db(wiki)
    sched = ScheduledDSQ(db, k=5, executor="sharded", precision="fp32",
                         stage=False,
                         cfg=SchedulerConfig(max_batch=4,
                                             breaker_trip_after=2,
                                             breaker_reset_after=2))
    plan = faults.FaultPlan().add("sharded.h2d", kind="error", count=2)
    with faults.FaultInjector(plan):
        for _ in range(2):
            t = sched.submit(wiki.queries[0], "/")
            assert sched.pump() == 1
            with pytest.raises(faults.FaultError):
                t.result(0)
    assert sched.health == "degraded" and sched.degrade_level == 1
    assert sched.executor == "flat" and sched.precision == "int8"
    assert sched.rescore_k == model_of(db.store).pick_rescore_k(
        5, None, len(db.store))
    tickets = [sched.submit(wiki.queries[i], "/") for i in range(3)]
    assert sched.pump() == 3
    want = db.dsq_batch(wiki.queries[:3], ["/"] * 3, k=5, executor="flat",
                        precision="int8", rescore_k=sched.rescore_k)
    _assert_bitwise([t.result(0) for t in tickets], want)
    sched.submit(wiki.queries[0], "/")
    assert sched.pump() == 1
    assert sched.health == "healthy" and sched.degrade_level == 0
    assert sched.executor == "sharded" and sched.precision == "fp32"
    snap = sched.metrics.snapshot()
    assert snap["degrades"] == 1 and snap["recoveries"] == 1
    assert snap["failed"] == 2


def test_sharded_serving_rag_parity():
    rng = np.random.default_rng(3)
    ctx = ContextDatabase(dim=D, device="cpu")
    for i in range(120):
        path = f"/mem/s{i % 5}/" if i % 2 else "/mem/"
        ctx.add_context(rng.normal(size=D).astype(np.float32), path, "L0",
                        np.arange(4, dtype=np.int32))
    ctx.build("flat")
    ctx.build("sharded", n_shards=4)
    q = rng.normal(size=(4, D)).astype(np.float32)
    scopes = ["/mem/", "/mem/s1/", "/mem/", "/mem/s2/"]
    flat = ctx.retrieve_batch(q, scopes, RAGConfig(k=5, executor="flat"))
    shard = ctx.retrieve_batch(q, scopes, RAGConfig(k=5, executor="sharded"))
    for (ha, _), (hb, sb) in zip(flat, shard):
        assert [h.entry_id for h in ha] == [h.entry_id for h in hb]
        assert sb["n_shards"] == 4 and "collective_bytes" in sb


def test_staging_cannot_evict_a_slot_between_pin_and_launch():
    """A second thread pinning other scopes (the scheduler's staging of
    the next batch) while a batch sits between its pins and its launch
    waits for the launch: with two slots it would otherwise evict the
    batch's slots and the batch would rank against other scopes' words."""
    db, rng = _mixed_db(4, table_slots=2)
    ex = db.executors["sharded"]
    q = rng.normal(size=(4, D)).astype(np.float32)
    scopes = ["/a/b1/", "/a/b1/", "/a/b2/", "/a/b2/"]
    want = db.dsq_batch(q, scopes, k=5, executor="flat")
    assert {r.plan for r in want} == {"scan"}
    from repro_torch.core.interface import normalize_batch
    from repro_torch.vectordb import ScopeKey
    keys = [ScopeKey.from_spec(spec)
            for spec in normalize_batch(["/a/b3/", "/a/b4/"])]
    keys, _ = db.planner().resolve_scopes(db.namespaces["fs"],
                                          len(db.store), keys)
    launch = ex.search_slots
    intruders = []

    def racing_search(*a, **kw):
        def stage():
            for key, ent in keys.items():
                ex.ensure_scope("fs", key, ent)
        t = threading.Thread(target=stage)
        t.start()
        t.join(0.2)                  # blocked on the batch's pin
        intruders.append(t)
        return launch(*a, **kw)

    ex.search_slots = racing_search
    got = db.dsq_batch(q, scopes, k=5, executor="sharded")
    ex.search_slots = launch
    for t in intruders:
        t.join(WAIT)
        assert not t.is_alive()
    assert intruders and ex.masks_evicted >= 2
    _assert_bitwise(got, want)
