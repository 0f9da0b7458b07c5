"""The port's continuous-batching front end (``repro_torch.serving.scheduler``
and the async surface of ``serving/rag.py``) against the reference, on
``tests/test_serving.py``'s and ``tests/test_faults.py``'s setups (their
sharded cases are in ``tests/test_torch_sharded.py``).

The scheduler adds no numeric path: a pumped batch is bit-identical to the
port's direct ``dsq_batch`` of the same requests on the flat, IVF and PG
executors at fp32, int8 and PQ, also after a DSM that races the staged
batch, and its ids equal the reference's ``ScheduledDSQ`` (ties within
1e-5 aside; the IVF partitions are the reference's, handed over by
``convert.ivf_from_state``). Around that: flush policy, fairness, typed
backpressure, the seeded arrival process, threaded serving, and the fault
paths (execute failure, deadline, cancel, worker death, stage fault, the
breaker's ladder and its floors). The port runs with ``device="cpu"``;
every ``result()`` has a timeout and every started scheduler stops.
"""
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.datasets import make_wiki_dir  # noqa: E402
from repro.models import model_schema as jschema  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro.serving import rag as jrag  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.ref import topk_disagreement  # noqa: E402
from repro_torch.models import from_reference  # noqa: E402
from repro_torch.serving import (AdmissionError, ContextDatabase,  # noqa: E402
                                 ContinuousScheduler, DeadlineExceeded,
                                 RAGConfig, RAGServer, ScheduledDSQ,
                                 SchedulerConfig, SchedulerUnhealthy,
                                 open_loop_arrivals)
from repro_torch.vectordb import DirectoryVectorDB  # noqa: E402
from repro_torch.vectordb import ivf_from_state, model_of  # noqa: E402

EXECUTORS = ("flat", "ivf", "pg")
PRECISIONS = ("fp32", "int8", "pq")
K = 8
DIM = 32
TOL = 1e-5
WAIT = 30.0                     # every result() waits at most this long


@pytest.fixture(scope="module")
def wiki():
    return make_wiki_dir(scale=0.002, dim=DIM, n_queries=24, seed=7)


@pytest.fixture(scope="module")
def dbs(wiki):
    """(reference, port) databases over the same rows with the flat, IVF
    (the reference's partitions) and PG executors; the port serves PQ with
    the reference's codebook."""
    ref = RefDB(dim=DIM, scope_strategy="triehi", calibration=False)
    mine = DirectoryVectorDB(dim=DIM, scope_strategy="triehi",
                             calibration=False, device="cpu")
    for db in (ref, mine):
        db.ingest(wiki.vectors, wiki.entry_paths)
        db.build_ann("flat")
    ref.build_ann("ivf", n_lists=8)
    rivf = ref.executors["ivf"]
    ivf_from_state(mine, rivf.centers, rivf.lists, rivf.repartition_gen)
    for db in (ref, mine):
        db.build_ann("pg", max_degree=8, ef_construction=16)
    mine.store.set_pq_codebook(ref.store.pq_codebook.centroids,
                               len(ref.store))
    return ref, mine


@pytest.fixture(scope="module")
def db(dbs):
    return dbs[1]


def _requests(wiki, n):
    paths = [(wiki.query_anchors[i % 6] or "/") for i in range(n)]
    paths[0] = "/"
    rec = [bool(wiki.query_recursive[i % 6]) for i in range(n)]
    return wiki.queries[:n], paths, rec


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _noop_sched(cfg, clock=None):
    return ContinuousScheduler(lambda payloads, staged: list(payloads),
                               cfg=cfg, clock=clock)


# ------------------------------------------------------------ flush policy
def test_flush_due_size_vs_deadline():
    clk = _FakeClock()
    s = _noop_sched(SchedulerConfig(max_batch=4, max_wait_ms=10.0), clock=clk)
    assert s._flush_due() is None
    for _ in range(3):
        s.submit("p")
    assert s._flush_due() is None
    clk.t += 0.0099
    assert s._flush_due() is None
    clk.t += 0.0002
    assert s._flush_due() == "deadline"
    s.submit("p")
    assert s._flush_due() == "size"
    with s._cond:
        batch = s._form_batch()
    assert [r.seq for r in batch] == [0, 1, 2, 3]
    assert s._flush_due() is None


def test_flush_reason_reaches_tickets():
    s = _noop_sched(SchedulerConfig(max_batch=2, max_wait_ms=5.0))
    with s:
        t1 = s.submit("a")
        t2 = s.submit("b")
        assert t1.result(WAIT) == "a" and t2.result(WAIT) == "b"
        assert t1.flush == "size" and t1.batch_size == 2
        t3 = s.submit("c")
        assert t3.result(WAIT) == "c"
    assert t3.flush in ("deadline", "drain")
    assert t3.batch_size == 1


# ----------------------------------------------------- weighted-fair admission
@pytest.mark.parametrize("weights,want", [({}, (4, 4)),
                                          ({"a": 3.0, "b": 1.0}, (6, 2))])
def test_fair_and_weighted_shares_match_reference(weights, want):
    """A flooding tenant gets its weighted share and no more; the batch the
    port forms is the reference's (tenants and admission order)."""
    out = []
    for mod in (jsched, None):
        make = (ContinuousScheduler if mod is None
                else mod.ContinuousScheduler)
        cfg = (SchedulerConfig if mod is None else mod.SchedulerConfig)(
            max_batch=8, max_wait_ms=1e4, queue_capacity=1000,
            tenant_weights=weights)
        s = make(lambda payloads, staged: list(payloads), cfg=cfg)
        for i in range(50):
            s.submit(("a", i), tenant="a")
            if i < 4 or weights:
                s.submit(("b", i), tenant="b")
        with s._cond:
            batch = s._form_batch()
        out.append([(r.tenant, r.seq) for r in batch])
    assert out[0] == out[1]
    counts = tuple(sum(1 for t, _ in out[1] if t == x) for x in ("a", "b"))
    assert counts == want
    assert [seq for _, seq in out[1]] == sorted(seq for _, seq in out[1])


# ------------------------------------------------------------- backpressure
def test_backpressure_typed_rejection():
    s = _noop_sched(SchedulerConfig(max_batch=8, max_wait_ms=1e4,
                                    queue_capacity=3))
    for _ in range(3):
        s.submit("ok", tenant="t")
    with pytest.raises(AdmissionError) as ei:
        s.submit("overflow", tenant="t")
    assert ei.value.tenant == "t"
    assert ei.value.queued == 3 and ei.value.capacity == 3
    s.submit("other-tenant-unaffected", tenant="u")
    snap = s.metrics.snapshot()
    assert snap["rejected"] == 1 and snap["submitted"] == 4
    assert snap["shed_rate"] == pytest.approx(1 / 5)


def test_open_loop_arrivals_equal_reference():
    for qps, n, seed in ((50.0, 256, 3), (2000.0, 256, 0)):
        np.testing.assert_array_equal(open_loop_arrivals(qps, n, seed=seed),
                                      jsched.open_loop_arrivals(qps, n,
                                                                seed=seed))
    a = open_loop_arrivals(50.0, 256, seed=3)
    assert np.all(np.diff(a) >= 0)
    assert not np.array_equal(a, open_loop_arrivals(50.0, 256, seed=4))


# ------------------------------------------------------------- bit-identity
@pytest.mark.parametrize("executor", EXECUTORS)
def test_scheduled_bit_identical_to_direct(executor, dbs, wiki):
    """pump() reproduces the exact coalesced batch: ids and score bits equal
    the port's direct dsq_batch at every precision, and the ids the
    reference's ScheduledDSQ."""
    ref, mine = dbs
    n = 12
    queries, paths, rec = _requests(wiki, n)
    for precision in PRECISIONS:
        rescore = 4 * K if precision != "fp32" else None
        kw = dict(k=K, executor=executor, precision=precision,
                  rescore_k=rescore)
        direct = mine.dsq_batch(queries, paths, recursive=rec, **kw)
        out = []
        for make, cfg, db in ((ScheduledDSQ, SchedulerConfig, mine),
                              (jsched.ScheduledDSQ, jsched.SchedulerConfig,
                               ref)):
            sdsq = make(db, cfg=cfg(max_batch=n, max_wait_ms=1e4), **kw)
            tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
                       for i in range(n)]
            assert sdsq.pump() == n
            out.append([t.result(WAIT) for t in tickets])
        label = f"{executor}/{precision}"
        for i, (got, theirs) in enumerate(zip(*out)):
            np.testing.assert_array_equal(got.ids[0], direct[i].ids[0],
                                          err_msg=label)
            np.testing.assert_array_equal(got.scores[0], direct[i].scores[0],
                                          err_msg=label)
            assert got.scope_size == theirs.scope_size, label
            err = topk_disagreement(got.ids, got.scores, theirs.ids,
                                    theirs.scores, TOL)
            assert err is None, f"{label} request {i}: {err}"
        assert out[0][0].batch.sched_batches == 1


def test_bit_identity_after_racing_dsm(wiki):
    """A DSM lands between staging and execution: execution re-resolves
    (the staged scopes were stamped with pre-DSM tokens) and matches a
    fresh direct dsq_batch."""
    db = DirectoryVectorDB(dim=DIM, scope_strategy="triehi",
                           calibration=False, device="cpu")
    db.ingest(wiki.vectors, wiki.entry_paths)
    db.build_ann("flat")
    n = 8
    queries, paths, rec = _requests(wiki, n)
    src = next(p for p in paths if p != "/")
    sdsq = ScheduledDSQ(db, k=K, cfg=SchedulerConfig(max_batch=n,
                                                     max_wait_ms=1e4))
    sched = sdsq.scheduler
    tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
               for i in range(n)]
    with sched._cond:
        batch = sched._form_batch()
    staged, stage_s = sched._do_stage(batch)
    assert isinstance(staged, np.ndarray)         # the CPU stages numpy
    np.testing.assert_array_equal(staged, queries)
    db.dsm_batch([("move", src, "/moved/")])
    sched._run_batch(batch, staged, stage_s, "test")
    direct = db.dsq_batch(queries, paths, k=K, recursive=rec)
    for i, t in enumerate(tickets):
        res = t.result(WAIT)
        np.testing.assert_array_equal(res.ids[0], direct[i].ids[0])
        np.testing.assert_array_equal(res.scores[0], direct[i].scores[0])
    assert sched.stage_faults == 0


def test_threaded_end_to_end_matches_direct(db, wiki):
    """The collector / executor pair under concurrent submitters: every
    ticket resolves, and on flat each equals its direct single-request
    dsq bit for bit."""
    n = 24
    queries, paths, rec = _requests(wiki, n)
    sdsq = ScheduledDSQ(db, k=K, cfg=SchedulerConfig(max_batch=6,
                                                     max_wait_ms=5.0))
    tickets = [None] * n
    with sdsq:
        def client(lo, hi):
            for i in range(lo, hi):
                tickets[i] = sdsq.submit(queries[i], paths[i],
                                         recursive=rec[i])
        threads = [threading.Thread(target=client, args=(j, j + 8))
                   for j in range(0, n, 8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [t.result(WAIT) for t in tickets]
    for i, res in enumerate(results):
        direct = db.dsq(queries[i], paths[i], k=K, recursive=rec[i])
        np.testing.assert_array_equal(res.ids[0], direct.ids[0])
        np.testing.assert_array_equal(res.scores[0], direct.scores[0])
    snap = sdsq.metrics.snapshot()
    assert snap["completed"] == n and snap["failed"] == 0
    assert snap["batches"] >= n // 6
    assert snap["accounting"]["sched_batches"] == snap["batches"]
    assert sdsq.scheduler.stage_faults == 0 and sdsq.health == "healthy"


# ------------------------------------------------------------ fault paths
def test_execute_failure_fans_out_to_tickets():
    def boom(payloads, staged):
        raise ValueError("batch died")

    s = ContinuousScheduler(boom, cfg=SchedulerConfig(max_batch=4,
                                                      max_wait_ms=1e4))
    t1, t2 = s.submit("a"), s.submit("b")
    assert s.pump() == 2
    for t in (t1, t2):
        with pytest.raises(ValueError, match="batch died"):
            t.result(WAIT)


def test_deadline_exceeded_typed_shed_at_formation():
    clk = _FakeClock()
    s = _noop_sched(SchedulerConfig(max_batch=8, deadline_ms=50.0), clock=clk)
    t1 = s.submit("a")
    t2 = s.submit("b", deadline_ms=500.0)
    clk.t += 0.2
    assert s.pump() == 1
    assert t2.result(0) == "b"
    with pytest.raises(DeadlineExceeded) as ei:
        t1.result(0)
    assert ei.value.deadline_ms == pytest.approx(50.0)
    assert ei.value.waited_ms == pytest.approx(200.0)
    assert s._pending == 0
    snap = s.metrics.snapshot()
    assert snap["expired"] == 1 and snap["completed"] == 1
    assert snap["shed_rate"] == pytest.approx(0.5)


def test_cancel_frees_slot():
    s = _noop_sched(SchedulerConfig(max_batch=8, queue_capacity=2))
    t1 = s.submit("a")
    t2 = s.submit("b")
    with pytest.raises(AdmissionError):
        s.submit("c")
    assert t1.cancel() is True and t1.cancel() is True
    assert s.pump() == 1
    assert t2.result(0) == "b"
    assert t1.cancelled and not t1.done()
    assert t2.cancel() is False
    assert s._pending == 0 and s._inflight == 0
    assert s.drain(timeout=0) is True
    assert s.metrics.snapshot()["cancelled"] == 1
    s.submit("d")
    assert s.pump() == 1


@pytest.mark.parametrize("seam", ["sched.execute", "sched.collect"])
def test_worker_thread_death_flips_readonly(seam):
    plan = faults.FaultPlan().add(seam, kind="crash")
    s = _noop_sched(SchedulerConfig(max_batch=4, max_wait_ms=1.0))
    with faults.FaultInjector(plan):
        s.start()
        try:
            t1 = s.submit("a")
            with pytest.raises(SchedulerUnhealthy):
                t1.result(WAIT)
            assert s.health == "readonly"
            assert s.metrics.health == "readonly"
            with pytest.raises(SchedulerUnhealthy):
                s.submit("b")
        finally:
            s.stop()


def test_stage_fault_absorbed_bit_identical(db, wiki):
    sched = ScheduledDSQ(db, k=5, executor="flat", stage=True,
                         cfg=SchedulerConfig(max_batch=8))
    plan = faults.FaultPlan().add("sched.stage", kind="error")
    with faults.FaultInjector(plan):
        tickets = [sched.submit(wiki.queries[i], "/") for i in range(4)]
        assert sched.pump() == 4
    got = [t.result(0) for t in tickets]
    want = db.dsq_batch(wiki.queries[:4], ["/"] * 4, k=5, executor="flat")
    assert sched.scheduler.stage_faults == 1
    assert sched.health == "healthy"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.ids, g.ids)
        np.testing.assert_array_equal(w.scores, g.scores)


def test_breaker_downshift_then_recovery(db, wiki):
    """Two failed batches trip the breaker: fp32 flat downshifts to the
    recall-clamped int8 plan (bit-identical to a direct int8 batch), and
    sustained success restores the healthy configuration."""
    sched = ScheduledDSQ(db, k=5, executor="flat", precision="fp32",
                         stage=False,
                         cfg=SchedulerConfig(max_batch=4,
                                             breaker_trip_after=2,
                                             breaker_reset_after=2))
    plan = faults.FaultPlan().add("sched.execute", kind="error", count=2)
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
    got = [t.result(0) for t in tickets]
    want = db.dsq_batch(wiki.queries[:3], ["/"] * 3, k=5, executor="flat",
                        precision="int8", rescore_k=sched.rescore_k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.ids, g.ids)
        np.testing.assert_array_equal(w.scores, g.scores)
    sched.submit(wiki.queries[0], "/")
    assert sched.pump() == 1
    assert sched.health == "healthy" and sched.degrade_level == 0
    assert sched.executor == "flat" and sched.precision == "fp32"
    snap = sched.metrics.snapshot()
    assert snap["degrades"] == 1 and snap["recoveries"] == 1
    assert snap["failed"] == 2


def test_downshift_param_floors_equal_reference(dbs):
    """The IVF nprobe and PG ef_search rungs, floors and restore equal the
    reference's ladder step for step."""
    ref, mine = dbs
    for executor, params in (("ivf", {"nprobe": 8}),
                             ("pg", {"ef_search": 64})):
        ladders = []
        for make, db in ((ScheduledDSQ, mine), (jsched.ScheduledDSQ, ref)):
            s = make(db, k=5, executor=executor, precision="int8",
                     stage=False, **params)
            rungs = []
            for _ in range(5):
                s._downshift()
                rungs.append((s.precision, dict(s.executor_params)))
            s._upshift()
            rungs.append((s.executor_params, s.degrade_level))
            ladders.append(rungs)
        assert ladders[0] == ladders[1], executor
    floor = model_of(mine.store).default_nprobe(mine.executors["ivf"].n_lists)
    s = ScheduledDSQ(mine, k=5, executor="ivf", nprobe=8, stage=False)
    s._downshift()
    assert s.executor_params["nprobe"] == max(floor, 4)
    s = ScheduledDSQ(mine, k=5, executor="pg", ef_search=64, stage=False)
    s._downshift()
    assert s.executor_params["ef_search"] == 32


# ----------------------------------------------------------- RAG async API
def test_context_database_async_parity_and_stats(wiki):
    """``submit_retrieve`` equals ``retrieve_batch`` over the same batch
    (hits and stats, plus the scheduler's terms), and the reference's
    hits."""
    ctx = ContextDatabase(dim=DIM, device="cpu")
    jctx = jrag.ContextDatabase(dim=DIM)
    rng = np.random.default_rng(0)
    for i in range(min(120, len(wiki.entry_paths))):
        toks = rng.integers(0, 99, size=12)
        for c in (ctx, jctx):
            c.add_context(wiki.vectors[i], wiki.entry_paths[i],
                          ("L0", "L1", "L2")[i % 3], toks)
    ctx.build("flat")
    jctx.build("flat")
    cfg = RAGConfig(k=5)
    n = 6
    queries, paths, _ = _requests(wiki, n)
    ctx.start_serving(cfg, SchedulerConfig(max_batch=n, max_wait_ms=50.0))
    try:
        with pytest.raises(RuntimeError):
            ctx.start_serving(cfg)
        tickets = [ctx.submit_retrieve(queries[i], paths[i])
                   for i in range(n)]
        async_res = [t.result(WAIT) for t in tickets]
        snap = ctx.serving_stats(reset=True)
    finally:
        ctx.stop_serving()
    sync_res = ctx.retrieve_batch(queries, paths, cfg)
    ref_res = jctx.retrieve_batch(queries, paths, jrag.RAGConfig(k=5))
    for (ha, sa), (hs, ss), (hr, _) in zip(async_res, sync_res, ref_res):
        assert [h.entry_id for h in ha] == [h.entry_id for h in hs] \
            == [h.entry_id for h in hr]
        assert sa["scope_size"] == ss["scope_size"]
        assert "sched_occupancy" in sa and "sched_occupancy" not in ss
    assert snap["completed"] == n and snap["qps"] > 0
    assert ctx._serving is None
    with pytest.raises(RuntimeError):
        ctx.serving_stats()


def test_rag_server_submit_matches_answer_and_reference(wiki):
    """``RAGServer.start`` / ``submit`` serves the coalesced batch with the
    tokens ``answer`` gives for it, equal to the reference's served tokens
    (the reference's own LM parameters, smoke width)."""
    ctx = ContextDatabase(dim=DIM, device="cpu")
    jctx = jrag.ContextDatabase(dim=DIM)
    rng = np.random.default_rng(2)
    for i in range(min(50, wiki.n_entries)):
        toks = rng.integers(0, 200, size=8)
        for c in (ctx, jctx):
            c.add_context(wiki.vectors[i], wiki.entry_paths[i], "L0", toks)
    ctx.build("flat")
    jctx.build("flat")
    jcfg = jsmoke("qwen3-0.6b").replace(vocab_size=256)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(0), jcfg.param_dtype())
    cfg = smoke_config("qwen3-0.6b").replace(vocab_size=256)
    model = from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rcfg = RAGConfig(k=3, token_budget=32)
    server = RAGServer(ctx, model, cfg, rcfg)
    jserver = jrag.RAGServer(jctx, jp, jcfg,
                             jrag.RAGConfig(k=3, token_budget=32))
    n = 3
    queries, paths, rec = _requests(wiki, n)
    prompt = np.arange(4, dtype=np.int32)
    served = []
    for srv, scfg in ((server, SchedulerConfig), (jserver,
                                                  jsched.SchedulerConfig)):
        # one size-flushed batch of all n requests
        srv.start(scfg(max_batch=n, max_wait_ms=1e4), max_new_tokens=2)
        try:
            tickets = [srv.submit(queries[i], paths[i], prompt=prompt,
                                  recursive=rec[i]) for i in range(n)]
            served.append([t.result(WAIT) for t in tickets])
            assert all(t.batch_size == n and t.flush == "size"
                       for t in tickets)
            assert srv.serving_stats()["completed"] == n
        finally:
            srv.stop()
    out = server.answer(queries, paths, [prompt], max_new_tokens=2,
                        recursive=rec)
    for i, (got, theirs) in enumerate(zip(*served)):
        np.testing.assert_array_equal(got["tokens"], out["tokens"][i])
        np.testing.assert_array_equal(got["tokens"], theirs["tokens"])
        assert [h.entry_id for h in got["hits"]] == \
            [h.entry_id for h in theirs["hits"]]
        strip = {key: v for key, v in got["retrieval_stats"].items()
                 if not key.endswith("_us")}
        want = {key: v for key, v in out["retrieval_stats"][i].items()
                if not key.endswith("_us")}
        assert strip == want
