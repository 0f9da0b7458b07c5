"""The port's database against the reference flat executor, end to end.

Same smoke-scale WIKI-Dir / ARXIV-Dir data into a reference
``repro.vectordb.DirectoryVectorDB`` and a port one (``device="cpu"``, the
plain PyTorch path), same requests and the same DSM sequence through both:
scope sizes and plans are equal, ids are equal except where the reference's
scores tie within 1e-5 (compared as a set there), and scores agree to
rtol = atol = 1e-5 (XLA:CPU and torch sum fp32 in other orders). Inside the
port, ``dsq_batch`` equals a loop of ``dsq`` bit for bit, crash replay is
bit-identical to an uncrashed twin, and recall@10 against the brute force is
1.0. Only the reference *flat* executor is used as an oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datasets import make_arxiv_dir as ref_make_arxiv  # noqa: E402
from repro.datasets import make_wiki_dir as ref_make_wiki  # noqa: E402
from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.core import DSM  # noqa: E402
from repro_torch.core import paths as P  # noqa: E402
from repro_torch.datasets import (brute_force_ground_truth,  # noqa: E402
                                  make_arxiv_dir, make_wiki_dir)
from repro_torch.kernels.ref import topk_disagreement  # noqa: E402
from repro_torch.vectordb import DirectoryVectorDB, from_state  # noqa: E402

TOL = 1e-5
DIM = 32
STRATEGIES = ("triehi", "pe_online", "pe_offline")


def _wiki():
    return make_wiki_dir(scale=0.002, dim=DIM, n_queries=24, seed=7)


def _arxiv():
    return make_arxiv_dir(scale=0.002, dim=DIM, n_queries=24, seed=1)


DATASETS = {"wiki": _wiki, "arxiv": _arxiv}


def _port_db(ds, strategy="triehi", journal=None):
    db = DirectoryVectorDB(dim=DIM, scope_strategy=strategy,
                           journal_path=journal, calibration=False,
                           device="cpu")
    db.ingest(ds.vectors, ds.entry_paths, namespaces=ds.extra_namespaces)
    db.build_ann("flat")
    return db


def _ref_db(ds, strategy):
    db = RefDB(dim=DIM, scope_strategy=strategy, calibration=False)
    db.ingest(ds.vectors, ds.entry_paths, namespaces=ds.extra_namespaces)
    db.build_ann("flat")
    return db


def _requests(ds, B=16):
    """A serving-shaped batch: the root (a scan group), repeated anchors
    (gather groups), non-recursive scopes and exclusions."""
    anchors = list(dict.fromkeys(ds.query_anchors))
    paths = [anchors[i % min(6, len(anchors))] for i in range(B)]
    paths[0] = paths[8] = "/"
    rec = [bool(i % 3) for i in range(B)]
    rec[0] = rec[8] = True
    exc = [[anchors[3 % len(anchors)]] if i % 8 == 5 else []
           for i in range(B)]
    return ds.queries[:B], paths, rec, exc


def _assert_matches_ref(port, ref, label):
    assert port.scope_size == ref.scope_size, label
    err = topk_disagreement(port.ids, port.scores, ref.ids, ref.scores, TOL)
    assert err is None, f"{label}: {err}"
    empty = ref.ids < 0
    assert np.all(port.scores[empty] == -np.inf), label


def _assert_bitwise(a, b, label):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x.ids, y.ids, err_msg=f"{label} {i}")
        np.testing.assert_array_equal(x.scores, y.scores,
                                      err_msg=f"{label} {i}")
        assert x.scope_size == y.scope_size, (label, i)


def _query_both(port, ref, reqs, label):
    q, paths, rec, exc = reqs
    pb = port.dsq_batch(q, paths, k=10, recursive=rec, exclude=exc)
    rb = ref.dsq_batch(q, paths, k=10, recursive=rec, exclude=exc)
    loop = [port.dsq(q[i], paths[i], k=10, recursive=rec[i], exclude=exc[i])
            for i in range(len(paths))]
    _assert_bitwise(pb, loop, f"{label} port batch vs loop")
    for i in range(len(paths)):
        assert pb[i].plan == rb[i].plan, (label, i)
        _assert_matches_ref(pb[i], rb[i], f"{label} batch {i}")
        _assert_matches_ref(
            loop[i], ref.dsq(q[i], paths[i], k=10, recursive=rec[i],
                             exclude=exc[i]), f"{label} dsq {i}")
    return pb, rb


def _dsm_sequence(db_ref, ds):
    """A DSM sequence valid on the reference's current tree: mkdir, a move
    off a batch anchor's chain, a merge, a rmdir, a dsm_batch of dataset
    templates (rejections allowed) and a point delete."""
    idx = db_ref.namespaces["fs"]
    dirs = [P.to_str(d) for d in idx.list_dirs() if len(d) >= 2]
    _, paths, _, _ = _requests(ds)
    anchor = next(a for a in paths if a != "/")
    sub = next((d for d in dirs if d.startswith(anchor) and d != anchor),
               dirs[0])
    rest = [d for d in dirs if not (P.is_ancestor(P.parse(d), P.parse(sub))
                                    or P.is_ancestor(P.parse(sub),
                                                     P.parse(d)))]
    src, dst = next((a, b) for a in rest for b in rest
                    if not P.is_ancestor(P.parse(a), P.parse(b))
                    and not P.is_ancestor(P.parse(b), P.parse(a)))
    gone = next(d for d in reversed(rest)
                if not any(P.is_ancestor(P.parse(d), P.parse(e))
                           or P.is_ancestor(P.parse(e), P.parse(d))
                           for e in (src, dst)))
    templates = ([("move", s, d) for s, d in ds.moves[:4]]
                 + [("merge", s, d) for s, d in ds.merges[:4]])
    return [("mkdir", "/newdir/"), ("move", sub, "/newdir/"),
            ("merge", src, dst), ("rmdir", gone), ("batch", templates),
            ("delete", 5)]


def _apply(db, step):
    kind, *args = step
    if kind == "batch":
        # one worker: with disjoint ops applied concurrently, whether a cached
        # mask is patched or evicted depends on the order their delta events
        # arrive (in either package), and the test compares those counters
        res = db.dsm_batch(args[0], max_workers=1)
        return [e is None for e in res.errors]
    getattr(db, kind)(*args)
    return None


def _state(db_ref):
    """(vectors, per-namespace path per row, tombstones) of a reference DB,
    as plain arrays and strings."""
    n = len(db_ref.store)
    ns_paths = {}
    for name, idx in db_ref.namespaces.items():
        paths = [None] * n
        for eid, ref in idx.catalog.items():
            path = (ref.resolve_forward().path()
                    if hasattr(ref, "resolve_forward") else ref.current())
            paths[eid] = P.to_str(path)
        ns_paths[name] = paths
    return (db_ref.store.vectors.copy(), ns_paths,
            db_ref.store.deleted_mask().copy())


@pytest.mark.parametrize("name", list(DATASETS))
def test_dirgen_copy_matches_reference(name):
    mine = DATASETS[name]()
    theirs = (ref_make_wiki(scale=0.002, dim=DIM, n_queries=24, seed=7)
              if name == "wiki"
              else ref_make_arxiv(scale=0.002, dim=DIM, n_queries=24, seed=1))
    for field in ("vectors", "queries", "query_recursive"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    for field in ("dirs", "entry_paths", "query_anchors", "moves", "merges",
                  "extra_namespaces"):
        assert getattr(mine, field) == getattr(theirs, field), field


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", list(DATASETS))
def test_port_matches_reference_through_dsm(name, strategy):
    ds = DATASETS[name]()
    port, ref = _port_db(ds, strategy), _ref_db(ds, strategy)
    reqs = _requests(ds)
    pb, _ = _query_both(port, ref, reqs, "before DSM")
    assert {"scan", "gather"} <= {r.plan for r in pb}
    if name == "arxiv":
        q = ds.queries[0]
        _assert_matches_ref(port.dsq(q, "/", namespace="time"),
                            ref.dsq(q, "/", namespace="time"), "time ns")
    for step in _dsm_sequence(ref, ds):
        assert _apply(port, step) == _apply(ref, step), step
    port.check_invariants()
    _query_both(port, ref, reqs, "after DSM")
    pc, rc = port.planner().cache.stats(), ref.planner().cache.stats()
    for key in ("patched", "delta_evictions"):
        assert pc[key] == rc[key], (key, pc, rc)
    if strategy == "triehi":
        assert pc["patched"] > 0

    # the state carried across: rows, tombstones and catalog paths
    vecs, ns_paths, deleted = _state(ref)
    assert deleted.any()
    conv = from_state(vecs, ns_paths, deleted, metric="ip",
                      scope_strategy=strategy, device="cpu",
                      calibration=False)
    _query_both(conv, ref, reqs, "from_state")


def test_recall_at_10_is_one():
    ds = _wiki()
    db = _port_db(ds)
    gt = brute_force_ground_truth(ds, k=10)
    hits = total = 0
    for qi, (q, anchor, rec) in enumerate(zip(ds.queries, ds.query_anchors,
                                              ds.query_recursive)):
        res = db.dsq(q, anchor, k=10, recursive=bool(rec))
        want = gt[qi][gt[qi] >= 0]
        if len(want) == 0:
            assert res.scope_size == 0
            continue
        kth = float(ds.vectors[want[-1]] @ q)
        got = res.ids[0][: len(want)]
        total += len(want)
        hits += sum(1 for i, s in zip(got, res.scores[0])
                    if i in want or s >= kth - TOL)
    assert total > 0 and hits == total


@pytest.mark.parametrize("kill", ["before_mutation", "after_mutation"])
def test_crash_replay_is_bitwise(kill, tmp_path):
    """Kill the process at the journal write of a DSM op (BEGIN never lands,
    or the mutation ran and COMMIT was lost), restart from the journal and
    recover: answers equal an uncrashed twin's bit for bit."""
    ds = _wiki()
    reqs = _requests(ds)
    probe = _ref_db(ds, "triehi")
    steps = [s for s in _dsm_sequence(probe, ds) if s[0] in ("move", "merge")]
    history, crashing = steps[0], steps[1]
    jp = str(tmp_path / "db.journal")
    db = _port_db(ds, journal=jp)
    db.dsq_batch(reqs[0], reqs[1], k=10, recursive=reqs[2], exclude=reqs[3])
    _apply(db, history)
    plan = faults.FaultPlan().add("journal.write", kind="crash",
                                  after=0 if kill == "before_mutation" else 1)
    with faults.FaultInjector(plan):
        with pytest.raises(faults.InjectedCrash):
            _apply(db, crashing)

    restarted = _port_db(ds, journal=jp)
    _apply(restarted, history)
    replayed = restarted.recover()
    want = [] if kill == "before_mutation" else [DSM(*crashing)]
    assert replayed["fs"] == want
    restarted.check_invariants()
    twin = _port_db(ds)
    _apply(twin, history)
    if kill == "after_mutation":
        _apply(twin, crashing)
    q, paths, rec, exc = reqs
    _assert_bitwise(
        restarted.dsq_batch(q, paths, k=10, recursive=rec, exclude=exc),
        twin.dsq_batch(q, paths, k=10, recursive=rec, exclude=exc),
        "recovered vs twin")
    _assert_bitwise(
        [restarted.dsq(q[i], paths[i], k=10, recursive=rec[i])
         for i in range(len(paths))],
        [twin.dsq(q[i], paths[i], k=10, recursive=rec[i])
         for i in range(len(paths))], "recovered vs twin (dsq)")


def test_quantized_precisions_and_other_executors_raise():
    """int8 and pq are served now (tests/test_torch_quantized.py), and so
    are the IVF (tests/test_torch_ivf.py), PG (tests/test_torch_graph.py)
    and sharded (tests/test_torch_sharded.py) executors; an unknown
    executor and unknown precisions raise."""
    db = _port_db(_wiki())
    db.build_ann("ivf", n_lists=8)
    assert db.dsq(db.store.vectors[0], "/", executor="ivf").ids[0, 0] >= 0
    db.build_ann("pg", max_degree=8, ef_construction=16)
    assert db.dsq(db.store.vectors[0], "/", executor="pg").ids[0, 0] >= 0
    db.build_ann("sharded")
    assert db.dsq(db.store.vectors[0], "/",
                  executor="sharded").ids[0, 0] >= 0
    with pytest.raises(ValueError, match="unknown ANN executor"):
        db.build_ann("hnsw")
    q = db.store.vectors[0]
    for precision in ("fp16", "int4"):
        with pytest.raises(ValueError, match="precision"):
            db.dsq(q, "/", precision=precision)
        with pytest.raises(ValueError, match="precision"):
            db.dsq_batch(q[None, :], ["/"], precision=precision)
        with pytest.raises(ValueError, match="precision"):
            db.executors["flat"].search(q, 10, precision=precision)


def test_store_tombstones_log_compact_and_device_mirror():
    """The port's store keeps the reference's tombstone, log-cursor and
    compaction semantics, and its device mirror follows every add (by
    doubling) and every compaction."""
    from repro.vectordb.store import VectorStore as RefStore
    from repro_torch.vectordb import VectorStore
    rng = np.random.default_rng(0)
    mine, theirs = VectorStore(8, "cos", device="cpu"), RefStore(8, "cos")
    h_mine, h_theirs = mine.register_log_consumer(), \
        theirs.register_log_consumer()
    for n_new in (700, 500, 1500):
        rows = rng.normal(size=(n_new, 8)).astype(np.float32)
        np.testing.assert_array_equal(mine.add(rows), theirs.add(rows))
        np.testing.assert_array_equal(mine.device_vectors().numpy(),
                                      theirs.vectors)
    assert mine._dev_rows.shape[0] == 2048 * 2          # doubled, not re-made
    np.testing.assert_array_equal(mine.vectors, theirs.vectors)
    for ids in ([3, 5, 5, 2000], [7], [2699, 2700, -1]):
        mine.mark_deleted(ids)
        theirs.mark_deleted(ids)
    assert mine.consume_deleted_log(h_mine) == \
        theirs.consume_deleted_log(h_theirs)
    np.testing.assert_array_equal(mine.alive_words(), theirs.alive_words())
    np.testing.assert_array_equal(mine.compact(), theirs.compact())
    np.testing.assert_array_equal(mine.vectors, theirs.vectors)
    np.testing.assert_array_equal(mine.device_vectors().numpy(),
                                  theirs.vectors)
    np.testing.assert_allclose(mine.device_sq_norms().numpy(),
                               theirs.sq_norms(), rtol=TOL, atol=TOL)
    assert mine.compact() is None and mine.alive_words() is None


def test_costmodel_decisions_match_reference():
    """Heuristic and measured sources decide exactly as the reference's; an
    artifact from another backend than the device's degrades to roofline,
    whose bandwidth is the H100 data sheet's."""
    from pathlib import Path
    from repro.vectordb import costmodel as ref_cm
    from repro_torch.vectordb import costmodel as cm
    art = str(Path(__file__).resolve().parents[1] / "calibration" / "cpu.json")
    pairs = [(cm.resolve_calibration(False, "cpu"),
              ref_cm.resolve_calibration(False)),
             (cm.resolve_calibration(art, "cpu"),
              ref_cm.resolve_calibration(art))]
    groups = [("scan", "fp32", 5000, 3), ("gather", "fp32", 40, 2),
              ("empty", "fp32", 0, 1)]
    for mine, theirs in pairs:
        assert mine.source == theirs.source
        for n, k in ((1000, 10), (1_940_000, 10), (50, 100)):
            assert mine.gather_threshold(n, k) == theirs.gather_threshold(n, k)
            assert mine.pick_rescore_k(k, None, n) == \
                theirs.pick_rescore_k(k, None, n)
            assert mine.pick_precision("int8", n, k, None) == \
                theirs.pick_precision("int8", n, k, None)
        assert mine.kernel_blocks() == theirs.kernel_blocks()
        assert mine.estimate_batch_ns(groups, 5000, 10, None, 32) == \
            theirs.estimate_batch_ns(groups, 5000, 10, None, 32)
    assert cm.resolve_calibration(False, "cpu").gather_threshold() == 0.05
    roof = cm.resolve_calibration(art, "cuda")
    assert roof.source == "roofline" and cm.HBM_BW == 3.35e12
    assert roof.scan_ns(1000, "fp32", 128) == \
        cm.LAUNCH_NS + 1000 * 512 / 3.35e12 * 1e9


def test_dsq_batch_fallback_forwards_executor_params():
    """Executor params the planner cannot plan (a forced plan) take the
    per-request fallback: bitwise equal to the same dsq calls, and equal to
    the reference's within tolerance."""
    ds = _wiki()
    port, ref = _port_db(ds), _ref_db(ds, "triehi")
    q, paths, rec, _ = _requests(ds)
    batch = port.dsq_batch(q, paths, k=10, recursive=rec, plan="scan")
    loop = [port.dsq(q[i], paths[i], k=10, recursive=rec[i], plan="scan")
            for i in range(len(paths))]
    _assert_bitwise(batch, loop, "fallback batch vs loop")
    assert batch[0].batch.launches == len(paths)
    for i, r in enumerate(ref.dsq_batch(q, paths, k=10, recursive=rec,
                                        plan="scan")):
        _assert_matches_ref(batch[i], r, f"fallback {i}")
    stats = port.stats()
    assert stats["entries"] == len(ds.vectors) and stats["device"] == "cpu"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_concurrent_resolve_during_dsm_batch(strategy):
    """The port's twin of ``tests/test_dsm.py``'s test of the same name:
    two readers resolve (recursively and not) while ``dsm_batch``'s four
    workers move subtrees. No reader may raise (PE-OFFLINE's non-recursive
    resolve once iterated a child set that a concurrent re-key resized),
    TrieHI's recursive read of the root is one snapshot of all 200
    entries, and the index's invariants hold afterwards."""
    import threading

    from repro_torch.core import DSMExecutor, make_scope_index

    idx = make_scope_index(strategy)
    for eid in range(200):
        idx.insert(eid, f"/t{eid % 8}/d{(eid // 8) % 2}/")
    ex = DSMExecutor(idx)
    stop = threading.Event()
    errors: list = []

    def reader():
        try:
            while not stop.is_set():
                got = idx.resolve("/", recursive=True)
                if strategy == "triehi":
                    assert len(got) == 200      # single-aggregate snapshot
                else:
                    assert len(got) <= 200
                for t in range(8):
                    idx.resolve(f"/t{t}/", recursive=True)
                    idx.resolve(f"/t{t}/", recursive=False)
        except Exception as e:                  # pragma: no cover - failure
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for r in range(2):
            ops = [DSM("move", f"/t{t}/d{r}/", f"/x{r}_{t}/")
                   for t in range(8)]
            res = ex.apply_many(ops, max_workers=4)
            assert all(e is None for e in res.errors), res.errors
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors, errors
    idx.check_invariants()
