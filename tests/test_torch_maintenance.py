"""The port's online maintenance (``repro_torch.vectordb.maintenance``)
against the reference ``repro.vectordb.maintenance``, on
``tests/test_maintenance.py``'s setups (its sharded case is in
``tests/test_torch_sharded.py``).

Across packages: one compaction propagates the same old -> new mapping to
the same scope postings, catalogs, mask-cache entries, IVF member lists
(the reference's partitions handed over by ``convert.ivf_from_state``) and
PG adjacency, and a churn soak ends with the reference's PG recall. Inside
the port: kill points before and after the apply recover to an uncrashed
twin bit for bit, ``recover`` without a manager drops the intent, the
journal auto-compacts, the tombstone log stays bounded, and the scheduler
runs maintenance between batches. The port runs with ``device="cpu"``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro.vectordb import MaintenancePolicy as RefPolicy  # noqa: E402
from repro_torch.core import DSM, DSMJournal  # noqa: E402
from repro_torch.core import paths as P  # noqa: E402
from repro_torch.serving import ScheduledDSQ, SchedulerConfig  # noqa: E402
from repro_torch.vectordb import (DirectoryVectorDB,  # noqa: E402
                                  MaintenancePolicy, PGIndex, VectorStore,
                                  ivf_from_state)

DIM = 16
KINDS = ("maint_pg_repair", "maint_compact", "maint_repartition")
SUBDIRS = ("/a/", "/b/", "/a/sub/")


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=(n, DIM)).astype(np.float32)


def _mkdb(tmp_path, seed=0, n=400, tag="db", ivf=True):
    """``tests/test_maintenance.py``'s deterministic db in the port, with
    the flat, IVF and PG executors; two made with the same seed are
    bit-identical twins."""
    rng, rows = _rows(seed, n)
    db = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu",
                           journal_path=str(tmp_path / f"{tag}.journal"))
    for d in SUBDIRS:
        db.mkdir(d)
    ids = db.ingest(rows, [SUBDIRS[i % 3] for i in range(n)])
    db.build_ann("flat")
    if ivf:
        db.build_ann("ivf", n_lists=8)
    db.build_ann("pg", max_degree=8, ef_construction=24)
    return db, ids, rng


def _ref_mkdb(tmp_path, seed=0, n=400):
    _, rows = _rows(seed, n)
    db = RefDB(dim=DIM, calibration=False,
               journal_path=str(tmp_path / "ref.journal"))
    for d in SUBDIRS:
        db.mkdir(d)
    ids = db.ingest(rows, [SUBDIRS[i % 3] for i in range(n)])
    db.build_ann("flat")
    db.build_ann("ivf", n_lists=8)
    db.build_ann("pg", max_degree=8, ef_construction=24)
    return db, ids


def _queries(seed=7, b=6):
    return np.random.default_rng(seed).normal(
        size=(b, DIM)).astype(np.float32)


def _flat_results(db, qs):
    out = []
    for q in qs:
        for path in ("/a/", "/b/", "/a/sub/", "/"):
            r = db.dsq(q, path, k=10, executor="flat")
            out.append((r.ids.copy(), r.scores.copy(), r.scope_size))
    return out


def _assert_same_db_state(a, b):
    """Bit-identical twin check across every maintained structure."""
    np.testing.assert_array_equal(a.store.vectors, b.store.vectors)
    assert a.store.n_deleted == b.store.n_deleted
    assert a.store.compact_gen == b.store.compact_gen
    ia, ib = a.executors["ivf"], b.executors["ivf"]
    assert ia.repartition_gen == ib.repartition_gen
    np.testing.assert_array_equal(ia.centers, ib.centers)
    np.testing.assert_array_equal(ia._len, ib._len)
    for la, lb in zip(ia.lists, ib.lists):
        np.testing.assert_array_equal(la, lb)
    pa, pb = a.executors["pg"], b.executors["pg"]
    assert pa.repair_gen == pb.repair_gen
    np.testing.assert_array_equal(pa._n_edges, pb._n_edges)
    np.testing.assert_array_equal(pa.neighbors, pb.neighbors)
    for (ids_a, sc_a, n_a), (ids_b, sc_b, n_b) in zip(
            _flat_results(a, _queries()), _flat_results(b, _queries())):
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(sc_a, sc_b)
        assert n_a == n_b


def _catalog(db):
    """Per namespace: entry id -> directory path string."""
    out = {}
    for name, idx in db.namespaces.items():
        out[name] = {int(eid): P.to_str(ref.resolve_forward().path()
                                        if hasattr(ref, "resolve_forward")
                                        else ref.current())
                     for eid, ref in idx.catalog.items()}
    return out


def _record_mapping(mgr):
    seen = []
    propagate = mgr._propagate_remap

    def record(mapping):
        seen.append(np.array(mapping))
        return propagate(mapping)

    mgr._propagate_remap = record
    return seen


# ------------------------------------------------------ across packages
def test_compact_propagates_remap_like_reference(tmp_path):
    """One compaction in both packages (repartition held off: torch and
    XLA k-means round differently): the same mapping, rows, scope postings,
    catalogs, mask-cache entries (tokens carried, words rebuilt for the new
    row count), IVF member lists and PG adjacency."""
    ref, ref_ids = _ref_mkdb(tmp_path)
    mine, ids, _ = _mkdb(tmp_path, ivf=False)
    rivf = ref.executors["ivf"]
    ivf_from_state(mine, rivf.centers, rivf.lists, rivf.repartition_gen)
    qs = _queries()
    for db in (ref, mine):
        db.dsq_batch(qs, ["/a/", "/b/", "/", "/a/sub/", "/a/", "/"], k=10)
    cache = mine.planner().cache
    before = len(cache._entries)
    assert before > 0
    words_before = {key: ent.words.shape[0]
                    for key, ent in cache._entries.items()}
    for db in (ref, mine):
        for i in ids[:150]:
            db.delete(int(i))
    policy = dict(repair_deletes=10 ** 9, pad_waste_min=10 ** 9)
    mgrs = [ref.maintenance(policy=RefPolicy(**policy)),
            mine.maintenance(policy=MaintenancePolicy(**policy))]
    maps = [_record_mapping(m) for m in mgrs]
    ran = [[r["kind"] for r in m.run_all()] for m in mgrs]
    assert ran[0] == ran[1] == ["maint_compact"], ran
    assert len(maps[0]) == len(maps[1]) == 1
    np.testing.assert_array_equal(maps[1][0], maps[0][0])
    new_n = len(mine.store)
    assert new_n == len(ref.store) == 250
    np.testing.assert_array_equal(mine.store.vectors, ref.store.vectors)
    assert _catalog(mine) == _catalog(ref)
    for name, idx in mine.namespaces.items():
        ridx = ref.namespaces[name]
        dirs = sorted(map(P.to_str, idx.list_dirs()))
        assert dirs == sorted(map(P.to_str, ridx.list_dirs()))
        for d in dirs:
            for rec in (True, False):
                np.testing.assert_array_equal(
                    idx.resolve(d, recursive=rec).to_array(),
                    ridx.resolve(d, recursive=rec).to_array())
    rcache = ref.planner().cache
    assert len(cache._entries) == before == len(rcache._entries)
    assert cache.patched == rcache.patched >= before
    rents = {(k.path, k.recursive, k.exclude): e
             for k, e in rcache._entries.items()}
    for key, ent in cache._entries.items():
        rent = rents[(key.path, key.recursive, key.exclude)]
        assert [(repr(node), e) for node, e in ent.tokens] == \
            [(repr(node), e) for node, e in rent.tokens]
        assert ent.n == rent.n == new_n
        np.testing.assert_array_equal(ent.scope.to_array(),
                                      rent.scope.to_array())
        assert ent._words is None                 # rebuilt, not reused
        assert ent.words.shape[0] == (new_n + 31) // 32 < words_before[key]
        np.testing.assert_array_equal(
            ent.words.numpy().view(np.uint32), rent.words)
    for la, lb in zip(mine.executors["ivf"].lists, rivf.lists):
        np.testing.assert_array_equal(la, lb)
    pa, pb = mine.executors["pg"], ref.executors["pg"]
    np.testing.assert_array_equal(pa.neighbors, pb.neighbors)
    np.testing.assert_array_equal(pa._n_edges, pb._n_edges)
    assert pa._entry == pb._entry
    for path in ("/a/", "/b/", "/a/sub/", "/"):
        for q in qs:
            got = mine.dsq(q, path, k=10)
            want = ref.dsq(q, path, k=10)
            assert got.scope_size == want.scope_size
            np.testing.assert_array_equal(got.ids, want.ids)
    mine.check_invariants()


def _soak(db, rng, policy, n_rounds=6):
    """``tests/test_maintenance.py``'s churn soak: delete, drifted
    re-ingest and DSM each round, then every due maintenance op."""
    ids = db.ingest(rng.normal(size=(512, DIM)).astype(np.float32),
                    ["/a/" if i % 2 else "/b/" for i in range(512)])
    db.build_ann("flat")
    db.build_ann("pg", max_degree=8, ef_construction=32)
    mgr = db.maintenance(policy=policy)
    alive = [int(i) for i in ids]
    for rnd in range(n_rounds):
        kill = rng.choice(len(alive), size=48, replace=False)
        for j in sorted(kill, reverse=True):
            db.delete(alive.pop(j))
        loc = float(rng.normal(scale=2.0))
        new = db.ingest(rng.normal(loc=loc,
                                   size=(48, DIM)).astype(np.float32),
                        ["/a/" if i % 2 else "/b/" for i in range(48)])
        alive = [int(i) for i in new] + alive
        db.mkdir(f"/b/r{rnd}/")
        db.move(f"/b/r{rnd}/", "/a/")
        mgr.run_all()
        db.check_invariants()
        am = db.store.alive_bool()
        alive = (np.nonzero(am)[0].tolist() if am is not None
                 else list(range(len(db.store))))
    qs = rng.normal(size=(24, DIM)).astype(np.float32)
    hits = total = 0
    for q in qs:
        exact = db.dsq(q, "/", k=10, executor="flat")
        got = db.dsq(q, "/", k=10, executor="pg", ef_search=64)
        want_ids = {int(i) for i in exact.ids[0] if int(i) >= 0}
        hits += len(want_ids & {int(i) for i in got.ids[0] if int(i) >= 0})
        total += len(want_ids)
    return mgr, hits / max(total, 1)


def test_churn_soak_pg_recall_equals_reference(tmp_path):
    """The same seeded churn through both packages: the same maintenance
    ops, the same surviving rows and PG graph, and the reference's PG
    recall@10; the journal ends with nothing pending."""
    policy = dict(tombstone_min=32, tombstone_fraction=0.10,
                  pad_waste_min=64, pad_waste_fraction=0.25,
                  repair_deletes=16)
    out = []
    for pkg, db in (("ref", RefDB(dim=DIM, calibration=False,
                                  journal_path=str(tmp_path / "r.j"))),
                    ("mine", DirectoryVectorDB(
                        dim=DIM, calibration=False, device="cpu",
                        journal_path=str(tmp_path / "m.j")))):
        db.mkdir("/a/")
        db.mkdir("/b/")
        pol = (RefPolicy if pkg == "ref" else MaintenancePolicy)(**policy)
        mgr, recall = _soak(db, np.random.default_rng(0), pol)
        out.append((db, mgr, recall))
    (ref, rmgr, rrec), (mine, mgr, rec) = out
    assert mgr.stats()["ops_run"] == rmgr.stats()["ops_run"]
    assert mgr.stats()["ops_run"].get("maint_compact", 0) >= 1
    assert mgr.stats()["ops_run"].get("maint_pg_repair", 0) >= 1
    assert mgr.stats()["journal_pending"] == 0
    np.testing.assert_array_equal(mine.store.vectors, ref.store.vectors)
    np.testing.assert_array_equal(mine.executors["pg"].neighbors,
                                  ref.executors["pg"].neighbors)
    assert rec == rrec, (rec, rrec)
    assert rec >= 0.8, rec


# ----------------------------------------------------- crash recovery
@pytest.mark.parametrize("kind", KINDS)
def test_kill_point_before_apply_recovers_bit_identical(kind, tmp_path):
    """Crash between journal BEGIN and the mutation: ``recover`` rolls the
    op forward to the state of a twin that never crashed."""
    db_a, ids_a, _ = _mkdb(tmp_path, seed=3, tag="a")
    db_b, _, _ = _mkdb(tmp_path, seed=3, tag="b")
    for i in ids_a[:120]:
        db_a.delete(int(i))
        db_b.delete(int(i))
    mgr_a, mgr_b = db_a.maintenance(), db_b.maintenance()
    mgr_a._run(kind)
    db_b._dsm["fs"].journal.begin(mgr_b._intent(kind))
    replayed = db_b.recover()
    assert [o.kind for o in replayed["fs"]] == [kind]
    assert mgr_b.ops_replayed == {kind: 1}
    assert mgr_b.stats()["journal_pending"] == 0
    _assert_same_db_state(db_a, db_b)
    db_b.check_invariants()


@pytest.mark.parametrize("kind", KINDS)
def test_kill_point_after_apply_skips_reapply(kind, tmp_path):
    """Crash between the mutation and COMMIT: the generation counter moved
    past the journaled snapshot, so ``recover`` only re-commits."""
    db_a, ids_a, _ = _mkdb(tmp_path, seed=4, tag="a")
    db_b, _, _ = _mkdb(tmp_path, seed=4, tag="b")
    for i in ids_a[:120]:
        db_a.delete(int(i))
        db_b.delete(int(i))
    mgr_a, mgr_b = db_a.maintenance(), db_b.maintenance()
    mgr_a._run(kind)
    op = mgr_b._intent(kind)
    db_b._dsm["fs"].journal.begin(op)
    mgr_b._apply(op)
    replayed = db_b.recover()
    assert replayed["fs"] == []
    assert mgr_b.ops_replayed == {}
    assert mgr_b.stats()["journal_pending"] == 0
    _assert_same_db_state(db_a, db_b)
    db_b.check_invariants()


def test_injected_crash_at_apply_seam_recovers(tmp_path):
    """The ``maint.apply`` fault seam of the port's ``faults``: a crash
    there leaves the intent journaled, and ``recover`` rolls it forward to
    the uncrashed twin."""
    from repro_torch import faults
    db_a, ids_a, _ = _mkdb(tmp_path, seed=5, tag="a")
    db_b, _, _ = _mkdb(tmp_path, seed=5, tag="b")
    for i in ids_a[:120]:
        db_a.delete(int(i))
        db_b.delete(int(i))
    mgr_a, mgr_b = db_a.maintenance(), db_b.maintenance()
    for kind in ("maint_compact", "maint_pg_repair"):
        mgr_a._run(kind)
        plan = faults.FaultPlan().add("maint.apply", kind="crash")
        with faults.FaultInjector(plan):
            with pytest.raises(faults.InjectedCrash):
                mgr_b._run(kind)
        assert [o.kind for o in db_b.recover()["fs"]] == [kind]
    assert mgr_b.ops_replayed == {"maint_compact": 1, "maint_pg_repair": 1}
    _assert_same_db_state(db_a, db_b)


def test_recover_without_manager_drops_intent_safely(tmp_path):
    db, ids, _ = _mkdb(tmp_path, seed=5)
    for i in ids[:120]:
        db.delete(int(i))
    mgr = db.maintenance()
    db._dsm["fs"].journal.begin(mgr._intent("maint_compact"))
    db._dsm["fs"].maintenance_replay = None
    assert db.recover()["fs"] == []
    assert len(db._dsm["fs"].journal.uncommitted()) == 0
    assert db.store.n_deleted == 120
    db.check_invariants()
    assert "maint_compact" in mgr.due()
    mgr.run_all()
    assert db.store.n_deleted == 0
    db.check_invariants()


# ------------------------------------------------ journal and tombstone log
def test_journal_auto_compacts_under_churn(tmp_path):
    jp = str(tmp_path / "dsm.journal")
    j = DSMJournal(jp, auto_compact_every=16)
    last = -1
    high_water = 0
    for i in range(400):
        seq = j.begin(DSM("mkdir", f"/d{i}/"))
        assert seq > last
        last = seq
        j.commit(seq)
        high_water = max(high_water, os.path.getsize(jp))
    assert os.path.getsize(jp) < 8_000 and high_water < 8_000
    crash_seq = j.begin(DSM("move", "/d0/", "/d1/"))
    for i in range(40):
        j.commit(j.begin(DSM("mkdir", f"/e{i}/")))
    reopened = DSMJournal(jp)
    assert reopened.uncommitted() == [
        (crash_seq, DSM("move", "/d0/", "/d1/"))]
    assert reopened.begin(DSM("mkdir", "/x/")) > last


def test_deleted_log_bounded_by_consumers():
    store = VectorStore(dim=DIM, device="cpu")
    store.add(np.random.default_rng(0).normal(
        size=(4096, DIM)).astype(np.float32))
    h = store.register_log_consumer()
    slow = store.register_log_consumer()
    peak = 0
    for wave in range(64):
        ids = list(range(wave * 64, wave * 64 + 64))
        store.mark_deleted(ids)
        peak = max(peak, len(store.deleted_log))
        assert store.consume_deleted_log(h) == ids
        if wave == 31:
            assert len(store.deleted_log) == 32 * 64  # slow pins the log
            assert len(store.consume_deleted_log(slow)) == 32 * 64
    store.unregister_log_consumer(slow)
    assert len(store.deleted_log) == 0
    assert peak <= 32 * 64


# ----------------------------------------------------------- PG upkeep
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pg_connect_symmetry_matches_reference(seed):
    """Build + incremental add churn: the directed edge set stays
    symmetric, and the adjacency equals the reference's."""
    from repro.vectordb import PGIndex as RefPG
    from repro.vectordb import VectorStore as RefStore
    rng = np.random.default_rng(seed)
    mine, theirs = VectorStore(dim=DIM, device="cpu"), RefStore(dim=DIM)
    rows = rng.normal(size=(64, DIM)).astype(np.float32)
    mine.add(rows)
    theirs.add(rows)
    pg = PGIndex(mine, max_degree=4, ef_construction=12)
    rpg = RefPG(theirs, max_degree=4, ef_construction=12)
    for _ in range(8):
        new = rng.normal(size=(int(rng.integers(1, 9)),
                               DIM)).astype(np.float32)
        pg.add(mine.add(new))
        rpg.add(theirs.add(new))
        assert pg.audit()["asymmetric"] == 0
        np.testing.assert_array_equal(pg.neighbors, rpg.neighbors)


# ------------------------------------------------ scheduler integration
def test_scheduler_runs_maintenance_between_batches(tmp_path):
    db, ids, rng = _mkdb(tmp_path, seed=6)
    for i in ids[:150]:
        db.delete(int(i))
    s = ScheduledDSQ(db, k=5, maintenance=True, maintenance_every=2)
    qs = rng.normal(size=(16, DIM)).astype(np.float32)
    futs = [s.submit(qs[i], "/a/") for i in range(16)]
    for _ in range(64):
        if all(f.done() for f in futs):
            break
        s.pump()
    results = [f.result(timeout=5) for f in futs]
    for _ in range(64):
        s.pump()
    assert s.scheduler.maintenance_steps >= 2
    assert s.scheduler.maintenance_error is None
    assert db.store.n_deleted == 0
    db.check_invariants()
    assert all(r is not None and len(r.ids[0]) == 5 for r in results)
    f2 = s.submit(qs[0], "/a/")
    for _ in range(16):
        if f2.done():
            break
        s.pump()
    direct = db.dsq(qs[0], "/a/", k=5, executor="flat")
    np.testing.assert_array_equal(f2.result(timeout=5).ids, direct.ids)
    np.testing.assert_array_equal(f2.result(timeout=5).scores,
                                  direct.scores)


def test_scheduler_maintenance_threaded(tmp_path):
    import time
    db, ids, rng = _mkdb(tmp_path, seed=7)
    for i in ids[:150]:
        db.delete(int(i))
    qs = rng.normal(size=(16, DIM)).astype(np.float32)
    s = ScheduledDSQ(db, k=5, maintenance=True, maintenance_every=2,
                     cfg=SchedulerConfig(max_batch=8, max_wait_ms=2.0))
    with s:
        futs = [s.submit(qs[i % 16], "/b/") for i in range(32)]
        out = [f.result(timeout=30) for f in futs]
        deadline = time.time() + 5
        while s.scheduler.maintenance_steps == 0 and time.time() < deadline:
            time.sleep(0.01)
    assert all(o is not None for o in out)
    assert s.scheduler.maintenance_steps >= 1
    assert s.scheduler.maintenance_error is None
    db.check_invariants()
