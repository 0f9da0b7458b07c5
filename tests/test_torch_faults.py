"""Fault-injection framework (``repro_torch/faults.py``) + graceful
degradation, run on the port; the twin of ``tests/test_faults.py`` without
the three tests that ``tests/test_torch_serving.py`` already twins by name
(the deadline shed, the absorbed stage fault and the breaker's downshift).

Three layers of contract:

* **Framework** — seeded determinism (same plan seed -> same trip pattern),
  exact ``after``/``count`` windows, latency-only rules, thread-safe trip
  accounting, process-global install discipline.
* **Degradation** — every injected failure surfaces as a *typed* outcome,
  never a hang or a silent wrong answer: transient host-fetch faults retry
  with backoff (bit-identical results, retries accounted), deadline misses
  shed with :class:`DeadlineExceeded` at batch formation, cancelled tickets
  free their admission slot, worker-thread death flips the scheduler to
  ``readonly`` (queued + in-flight tickets resolve with
  :class:`SchedulerUnhealthy`, submits fail fast), breaker trips walk the
  recall-clamped downshift ladder and sustained success walks back up.
* **Chaos soak** — a seeded random fault schedule over concurrent serve +
  ingest + DSM churn + online maintenance: every request resolves with a
  result or a typed error inside a bounded wall clock, crash-recovery keeps
  the store in differential parity with the pure-Python oracle, and the
  journal settles with nothing pending.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch import faults
from repro_torch.core import paths as P
from repro_torch.core.ops import DSMJournal
from repro_torch.datasets import make_wiki_dir
from repro_torch.serving.scheduler import (AdmissionError, ContinuousScheduler,
                                     DeadlineExceeded, ScheduledDSQ,
                                     SchedulerConfig, SchedulerUnhealthy)
from repro_torch.vectordb import DirectoryVectorDB, MaintenancePolicy
from repro_torch.vectordb.costmodel import model_of

from test_torch_differential import PyOracle

DIM = 16
K = 5


# ---------------------------------------------------------------- framework
def _trip_pattern(plan: faults.FaultPlan, seam: str, n: int):
    """Fire ``seam`` n times under a fresh injector; True where it tripped."""
    pattern = []
    with faults.FaultInjector(plan) as inj:
        for _ in range(n):
            try:
                faults.fire(seam)
                pattern.append(False)
            except faults.FaultError:
                pattern.append(True)
    assert faults.active() is None          # uninstalled on exit
    assert inj.trips.get(seam, 0) == sum(pattern)
    return pattern


def test_after_count_window_is_exact():
    plan = faults.FaultPlan(seed=0).add("x", kind="error", after=2, count=2)
    assert _trip_pattern(plan, "x", 6) == [False, False, True, True,
                                           False, False]


def test_seeded_determinism():
    mk = lambda seed: faults.FaultPlan(seed=seed).add(
        "x", kind="error", p=0.5, count=None)
    a = _trip_pattern(mk(7), "x", 40)
    b = _trip_pattern(mk(7), "x", 40)
    c = _trip_pattern(mk(8), "x", 40)
    assert a == b                            # same seed -> same schedule
    assert a != c                            # different seed -> different
    assert 0 < sum(a) < 40                   # p=0.5 actually probabilistic


def test_latency_rule_sleeps_then_continues():
    plan = faults.FaultPlan().add("slow", kind="latency", latency_s=0.05)
    with faults.FaultInjector(plan) as inj:
        t0 = time.perf_counter()
        assert faults.fire("slow") is None   # no error raised
        assert time.perf_counter() - t0 >= 0.04
        assert faults.fire("slow") is None   # count=1: second hit clean
    assert inj.trips == {"slow": 1}


def test_enospc_is_a_real_oserror():
    import errno
    with faults.FaultInjector(faults.FaultPlan().add("j", kind="enospc")):
        with pytest.raises(OSError) as ei:
            faults.fire("j")
        assert ei.value.errno == errno.ENOSPC


def test_injected_crash_escapes_except_exception():
    assert not issubclass(faults.InjectedCrash, Exception)
    with faults.FaultInjector(faults.FaultPlan().add("c", kind="crash")):
        with pytest.raises(faults.InjectedCrash):
            try:
                faults.fire("c")
            except Exception:                # noqa: BLE001 — must NOT catch
                pytest.fail("InjectedCrash was swallowed by except Exception")


def test_nested_install_raises_and_fire_is_noop_when_uninstalled():
    assert faults.fire("anything") is None   # no injector: free no-op
    inj = faults.FaultInjector(faults.FaultPlan().add("x"))
    with inj:
        with pytest.raises(RuntimeError):
            faults.FaultInjector(faults.FaultPlan()).install()
    assert faults.active() is None


def test_thread_safe_trip_accounting():
    plan = faults.FaultPlan().add("t", kind="transient", count=7)
    tripped = []
    with faults.FaultInjector(plan) as inj:
        def worker():
            for _ in range(50):
                try:
                    faults.fire("t")
                except faults.TransientFault:
                    tripped.append(1)
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(tripped) == 7                 # count honored across threads
    assert inj.total_trips() == 7


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def wiki():
    return make_wiki_dir(scale=0.002, dim=32, n_queries=16, seed=7)


@pytest.fixture(scope="module")
def db(wiki):
    db = DirectoryVectorDB(dim=32, scope_strategy="triehi", device="cpu")
    db.ingest(wiki.vectors, wiki.entry_paths)
    db.build_ann("flat")
    db.build_ann("ivf", n_lists=8)
    db.build_ann("pg", max_degree=8, ef_construction=16)
    db.build_ann("sharded")
    return db


def _submit_n(sched, wiki, n, **kw):
    tickets = []
    for i in range(n):
        tickets.append(sched.submit(wiki.queries[i], "/", **kw))
    return tickets


# ------------------------------------------------- host-fetch bounded retry
def test_host_fetch_transient_retry_bit_identical(db, wiki):
    q = wiki.queries[:4]
    paths = ["/"] * 4
    want = db.dsq_batch(q, paths, k=K, executor="flat", precision="int8")
    r0 = db.store.host_fetch_retries
    plan = faults.FaultPlan(seed=1).add("store.host_fetch",
                                        kind="transient", count=2)
    with faults.FaultInjector(plan) as inj:
        got = db.dsq_batch(q, paths, k=K, executor="flat", precision="int8")
    assert inj.trips == {"store.host_fetch": 2}
    assert db.store.host_fetch_retries - r0 == 2
    # retries are invisible to results AND surfaced in the accounting
    assert got[0].batch.host_fetch_retries == 2
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.ids, g.ids)
        np.testing.assert_array_equal(w.scores, g.scores)


def test_host_fetch_retry_exhaustion_is_typed(db, wiki):
    f0 = db.store.host_fetch_failures
    plan = faults.FaultPlan().add("store.host_fetch", kind="transient",
                                  count=None)
    with faults.FaultInjector(plan):
        with pytest.raises(faults.FaultError):
            db.dsq(wiki.queries[0], "/", k=K, executor="flat",
                   precision="int8")
    assert db.store.host_fetch_failures == f0 + 1


# ------------------------------------------------------ deadlines + cancel
class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _noop_sched(cfg, clock=None):
    return ContinuousScheduler(lambda payloads, staged: list(payloads),
                               cfg=cfg, clock=clock)


def test_cancel_frees_slot_and_is_not_counted_forever():
    s = _noop_sched(SchedulerConfig(max_batch=8, queue_capacity=2))
    t1 = s.submit("a")
    t2 = s.submit("b")
    with pytest.raises(AdmissionError):      # queue at capacity
        s.submit("c")
    assert t1.cancel() is True
    assert t1.cancel() is True               # idempotent while unresolved
    assert s.pump() == 1                     # t1 reaped, t2 served
    assert t2.result(0) == "b"
    assert t1.cancelled and not t1.done()    # abandoned, never resolved
    assert t2.cancel() is False              # too late: already resolved
    assert s._pending == 0 and s._inflight == 0
    assert s.drain(timeout=0) is True        # the leak fix: slot released
    assert s.metrics.snapshot()["cancelled"] == 1
    s.submit("d")                            # capacity available again
    assert s.pump() == 1


# ------------------------------------------------------- worker-thread death
def test_executor_thread_death_flips_readonly_and_fails_fast():
    plan = faults.FaultPlan().add("sched.execute", kind="crash")
    s = _noop_sched(SchedulerConfig(max_batch=4, max_wait_ms=1.0))
    with faults.FaultInjector(plan):
        s.start()
        t1 = s.submit("a")
        with pytest.raises(SchedulerUnhealthy):
            t1.result(5.0)                   # in-flight batch resolved typed
        assert s.health == "readonly"
        assert s.metrics.health == "readonly"
        with pytest.raises(SchedulerUnhealthy):
            s.submit("b")                    # fail fast, not queue forever
        s.stop()                             # clean join, no deadlock


def test_collector_thread_death_resolves_formed_batch():
    plan = faults.FaultPlan().add("sched.collect", kind="crash")
    s = _noop_sched(SchedulerConfig(max_batch=4, max_wait_ms=1.0))
    with faults.FaultInjector(plan):
        s.start()
        t1 = s.submit("a")
        with pytest.raises(SchedulerUnhealthy):
            t1.result(5.0)                   # batch had left the queues
        assert s.health == "readonly"
        s.stop()


# --------------------------------------------------- degradation ladder
def test_sharded_h2d_fault_degrades_to_flat(db, wiki):
    sched = ScheduledDSQ(db, k=K, executor="sharded", precision="fp32",
                         stage=False,
                         cfg=SchedulerConfig(max_batch=4,
                                             breaker_trip_after=2))
    plan = faults.FaultPlan().add("sharded.h2d", kind="error", count=None)
    with faults.FaultInjector(plan):
        for _ in range(2):                   # H2D path fails every batch
            (t,) = _submit_n(sched, wiki, 1)
            sched.pump()
            with pytest.raises(faults.FaultError):
                t.result(0)
        assert sched.health == "degraded" and sched.executor == "flat"
        # flat avoids the faulting H2D seam entirely: serving continues
        tickets = _submit_n(sched, wiki, 2)
        assert sched.pump() == 2
        got = [t.result(0) for t in tickets]
    want = db.dsq_batch(wiki.queries[:2], ["/"] * 2, k=K, executor="flat",
                        precision="int8", rescore_k=sched.rescore_k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.ids, g.ids)


def test_downshift_param_floors_ivf_and_pg(db):
    ivf = ScheduledDSQ(db, k=K, executor="ivf", precision="int8",
                       nprobe=8, stage=False)
    floor = model_of(db.store).default_nprobe(db.executors["ivf"].n_lists)
    ivf._downshift()
    assert ivf.executor_params["nprobe"] == max(floor, 4)
    for _ in range(4):                       # ladder is floor-clamped
        ivf._downshift()
    assert ivf.executor_params["nprobe"] >= floor
    ivf._upshift()
    assert ivf.executor_params["nprobe"] == 8 and ivf.degrade_level == 0

    pg = ScheduledDSQ(db, k=K, executor="pg", precision="int8",
                      ef_search=64, stage=False)
    pg._downshift()
    assert pg.executor_params["ef_search"] == 32
    for _ in range(4):
        pg._downshift()
    assert pg.executor_params["ef_search"] >= 2 * K


# -------------------------------------------------------------- chaos soak
_SOAK_POLICY = MaintenancePolicy(
    tombstone_min=8, tombstone_fraction=0.05,
    pad_waste_min=32, pad_waste_fraction=0.10,
    repair_deletes=4, n_iters=2, sample=64)


def _recover_bounded(db, reopen):
    """Settle the journal under still-armed fault rules: recovery itself may
    trip (crash-during-recovery), so retry a bounded number of times —
    each retry consumes rule budget, so convergence is guaranteed and a
    hang is impossible."""
    ex = db._dsm["fs"]
    for _ in range(8):
        try:
            if reopen:                       # simulated restart: journal
                ex.journal = DSMJournal(     # state must come from disk
                    ex.journal.path,
                    fsync_on_commit=ex.journal.fsync_on_commit)
            return db.recover()
        except faults.InjectedCrash:
            reopen = True
        except OSError:
            reopen = False
    raise AssertionError("recovery did not converge in bounded retries")


def _churn(db, oracle, op, *args):
    """One journaled DSM op under possible injected journal faults. ENOSPC
    (an Exception) models a failed append with the process alive;
    short_write raises InjectedCrash — simulated death, so the journal
    reopens from disk. recover() then settles any durable intent and a
    ``has_dir`` probe decides whether the op landed, keeping the oracle
    in lockstep either way."""
    idx = db.namespaces["fs"]
    try:
        getattr(db, op)(*args)
    except faults.InjectedCrash:
        _recover_bounded(db, reopen=True)
    except OSError:
        _recover_bounded(db, reopen=False)
    else:
        getattr(oracle, op)(*args)
        return True
    if op == "mkdir":
        applied = idx.has_dir(args[0])
    else:                                    # move(src, new_parent)
        src, npar = P.parse(args[0]), P.parse(args[1])
        applied = idx.has_dir(npar + (src[-1],))
    if applied:
        getattr(oracle, op)(*args)
    return applied


def _maintain(db, mgr, oracle, alive):
    """One maintenance step under journal faults. Compaction application is
    detected from the store itself (row count shrinks) — robust even when
    the fault hit the COMMIT append — and rekeys the oracle through the
    order-preserving remap, exactly as the differential harness does."""
    n0 = len(db.store)
    alive_b = db.store.alive_bool()
    try:
        mgr.step()
    except faults.InjectedCrash:
        _recover_bounded(db, reopen=True)
    except OSError:
        _recover_bounded(db, reopen=False)
    if len(db.store) != n0:                  # compaction landed
        alive_rows = (np.nonzero(alive_b)[0] if alive_b is not None
                      else np.arange(n0))
        mapping = np.full(n0, -1, np.int64)
        mapping[alive_rows] = np.arange(len(alive_rows))
        oracle.entries = {int(mapping[e]): d
                          for e, d in oracle.entries.items()}
        oracle.vectors = {int(mapping[e]): v
                          for e, v in oracle.vectors.items()}
        alive[:] = [int(mapping[i]) for i in alive]
        assert all(i >= 0 for i in alive)


def _check_served(res, q, oracle, path, degraded):
    """Oracle parity for one served request: the scope is always exact;
    healthy fp32 must return the exact top-k (tie-tolerant), a degraded
    (int8, narrowed) answer must still be in-scope with true fp32 scores —
    narrower search, never a wrong one."""
    scope = oracle.resolve(path, recursive=True)
    assert res.scope_size == len(scope)
    ids = [int(i) for i in res.ids[0] if int(i) >= 0]
    scores = [float(s) for s, i in zip(res.scores[0], res.ids[0])
              if int(i) >= 0]
    assert set(ids) <= scope, set(ids) - scope
    osc = oracle.scores(q, ids)
    for i, s in zip(ids, scores):
        assert abs(osc[i] - s) < 1e-4 * max(1.0, abs(s)), (i, s, osc[i])
    if not degraded:
        want = oracle.topk(q, scope, K)
        want_ids = {i for i, _ in want}
        for miss in want_ids - set(ids):
            tie = min(scores) if scores else -np.inf
            assert abs(dict(want)[miss] - tie) < 1e-5, (miss, tie)


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_soak(seed, tmp_path):
    """Randomized fault schedule over serve + ingest + churn + maintenance:
    bounded wall clock, every ticket resolves typed, differential-oracle
    parity after every recovery, journal settles clean."""
    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    db = DirectoryVectorDB(dim=DIM, scope_strategy="triehi", device="cpu",
                           journal_path=str(tmp_path / "soak"))
    oracle = PyOracle()
    dirs = ["/a", "/a/b", "/c", "/c/d", "/e"]
    for d in dirs:
        db.mkdir(d)
        oracle.mkdir(d)
    vecs = rng.normal(size=(160, DIM)).astype(np.float32)
    paths = [(["/"] + dirs)[int(rng.integers(6))] for _ in range(160)]
    ids = db.ingest(vecs, paths)
    oracle.ingest(ids, vecs, paths)
    alive = [int(i) for i in ids]
    db.build_ann("flat")
    db.build_ann("ivf", n_lists=8)
    mgr = db.maintenance(policy=_SOAK_POLICY)
    sched = ScheduledDSQ(db, k=K, executor="flat", precision="fp32",
                         cfg=SchedulerConfig(max_batch=8,
                                             deadline_ms=30_000.0,
                                             breaker_trip_after=2,
                                             breaker_reset_after=2))
    plan = (faults.FaultPlan(seed=1000 + seed)
            .add("store.host_fetch", kind="transient", p=0.05, count=12)
            .add("store.host_fetch", kind="latency", p=0.03, count=8,
                 latency_s=0.001)
            .add("sched.execute", kind="error", p=0.10, count=5)
            .add("sched.stage", kind="error", p=0.05, count=3)
            .add("journal.write", kind="enospc", p=0.20, count=3)
            .add("journal.write", kind="short_write", p=0.12, count=2)
            .add("maint.apply", kind="crash", p=0.30, count=2))
    outcomes = {"ok": 0, "deadline": 0, "fault": 0}
    all_tickets = []
    mv_seq = 0
    with faults.FaultInjector(plan) as inj:
        for rnd in range(40):
            roll = rng.random()
            if roll < 0.25:                  # ingest (not journaled)
                n = int(rng.integers(1, 5))
                ds = sorted(P.to_str(d) for d in oracle.dirs)
                ps = [ds[int(rng.integers(len(ds)))] for _ in range(n)]
                vs = rng.normal(size=(n, DIM)).astype(np.float32)
                new = db.ingest(vs, ps)
                oracle.ingest(new, vs, ps)
                alive.extend(int(i) for i in new)
            elif roll < 0.40 and alive:      # delete (not journaled)
                eid = alive.pop(int(rng.integers(len(alive))))
                db.delete(eid)
                oracle.delete(eid)
            elif roll < 0.55:                # journaled churn under faults
                mv_seq += 1
                made = _churn(db, oracle, "mkdir", f"/e/m{mv_seq}")
                if made and rng.random() < 0.5:
                    _churn(db, oracle, "move", f"/e/m{mv_seq}", "/c")
            elif roll < 0.70:                # maintenance under faults
                _maintain(db, mgr, oracle, alive)
            # serve: submit a few queries (one with an already-spent
            # budget — must shed typed, not hang), pump, settle tickets
            batch = []
            for i in range(int(rng.integers(1, 4))):
                q = rng.normal(size=DIM).astype(np.float32)
                ds = sorted(P.to_str(d) for d in oracle.dirs)
                path = ds[int(rng.integers(len(ds)))]
                dl = 0.0 if (rnd % 10 == 5 and i == 0) else None
                batch.append((sched.submit(q, path, deadline_ms=dl), q, path))
            # the batch executes under the configuration armed *before* this
            # pump (execute snapshots it); an upshift landing mid-pump would
            # otherwise mislabel a degraded answer as exact
            was_degraded = sched.degrade_level > 0
            sched.pump()
            all_tickets.extend(t for t, _, _ in batch)
            for t, q, path in batch:
                try:
                    res = t.result(timeout=30.0)
                except DeadlineExceeded:
                    outcomes["deadline"] += 1
                except faults.FaultError:    # includes TransientFault
                    outcomes["fault"] += 1
                else:
                    _check_served(res, q, oracle, path,
                                  degraded=was_degraded)
                    outcomes["ok"] += 1
        while sched.scheduler._pending:      # drain the tail
            sched.pump()
        # ---- post-chaos invariants -------------------------------------
        assert inj.total_trips() > 0         # the chaos actually happened
    assert all(t.done() or t.cancelled for t in all_tickets)
    assert outcomes["ok"] > 20
    assert outcomes["deadline"] >= 1         # forced zero-budget submits shed
    snap = sched.metrics.snapshot()
    assert snap["shed_rate"] <= 0.5
    # journal settles: nothing pending live, nothing replayed on a clean
    # reopen, and reopening twice reads back the identical record stream
    assert mgr.stats()["journal_pending"] == 0
    assert db.recover() == {"fs": []}
    db.check_invariants()
    jpath = db._dsm["fs"].journal.path
    j1, j2 = DSMJournal(jpath), DSMJournal(jpath)
    assert j1.uncommitted() == [] and j2.uncommitted() == []
    assert j1._seq == j2._seq == db._dsm["fs"].journal._seq
    # differential parity after all recoveries: every directory scope
    # resolves to exactly the oracle's entry set
    idx = db.namespaces["fs"]
    for d in sorted(oracle.dirs):
        got = {int(i) for i in idx.resolve(d, recursive=True).to_array()}
        assert got == oracle.resolve(P.to_str(d), recursive=True), d
    assert time.monotonic() - t_start < 120.0    # bounded wall clock
