"""The port's spans and counters (``repro_torch.trace``): a profiled
scheduled batch exports every span, nested; without a recording profiler a
span is the shared do-nothing object and no ``record_function`` is made;
the executor's phase counters fit inside ``ann_ns``, count at least two
copies back a launch and sum under ``merge``; and a recording profiler
leaves every answer bit for bit as it was. Everything runs on a small
``device="cpu"`` database."""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.datasets import make_wiki_dir
from repro_torch.serving import ScheduledDSQ, SchedulerConfig
from repro_torch.vectordb import DirectoryVectorDB
from repro_torch.vectordb.planner import BatchAccounting

K = 5
SCHED = ("sched.form", "sched.stage", "sched.exec", "sched.done",
         "sched.maint")
DB = ("db.plan", "db.rank", "db.finish")
RANK = (trace.PUT, trace.RUN, trace.GET)


@pytest.fixture(scope="module")
def wiki():
    return make_wiki_dir(scale=0.002, dim=16, n_queries=24, seed=5)


@pytest.fixture(scope="module")
def db(wiki):
    db = DirectoryVectorDB(dim=16, scope_strategy="triehi",
                           calibration=False, device="cpu")
    db.ingest(wiki.vectors, wiki.entry_paths)
    db.build_ann("flat")
    return db


def _requests(wiki, n=12):
    """Half the requests scope the whole tree (one scan group), the rest
    the directory of one entry each, alone (small scopes: gather
    groups)."""
    paths = ["/" if i % 2 == 0
             else wiki.entry_paths[97 * i % len(wiki.entry_paths)]
             for i in range(n)]
    rec = [i % 2 == 0 for i in range(n)]
    return wiki.queries[:n], paths, rec


def _batch(db, wiki, precision="fp32"):
    q, paths, rec = _requests(wiki)
    return db.dsq_batch(q, paths, k=K, recursive=rec, precision=precision)


def test_span_without_a_recording_profiler_is_the_shared_no_op(
        db, wiki, monkeypatch):
    assert not trace.recording()
    assert trace.span("db.rank") is trace.span("sched.exec")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while not profiling")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("db.rank"):
        pass
    res = _batch(db, wiki)                  # every span and tile of a batch
    assert res[0].batch.rank_syncs > 0


def test_profiled_scheduled_batch_exports_every_span_nested(db, wiki,
                                                            tmp_path):
    steps = []

    def maintain():
        steps.append(1)
        return {"ops": 0}
    sdsq = ScheduledDSQ(db, k=K, namespace="fs",
                        cfg=SchedulerConfig(max_batch=16, max_wait_ms=50.0),
                        maintenance=maintain, maintenance_every=1)
    q, paths, rec = _requests(wiki)
    tickets = [sdsq.submit(q[i], paths[i], recursive=rec[i])
               for i in range(len(paths))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert sdsq.pump() == len(paths)
    acct = tickets[0].result(timeout=30.0).batch
    assert set(acct.plan_groups) == {"gather", "scan"}
    assert steps
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = {}
    for e in events:
        a = float(e["ts"])
        spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    for name in SCHED + DB + RANK:
        assert name in spans, name

    def inside(child, parent):
        return all(any(pa <= a and b <= pb for pa, pb in spans[parent])
                   for a, b in spans[child])

    def outside(child, parent):
        return not any(pa <= a and b <= pb for pa, pb in spans[parent]
                       for a, b in spans[child])
    for name in DB:
        assert inside(name, "sched.exec"), name
    for name in RANK:
        assert inside(name, "db.rank"), name
    for name in ("sched.form", "sched.stage", "sched.done", "sched.maint"):
        assert outside(name, "sched.exec"), name
    # each executor call's phases tile it: the copies back count 2 a launch
    assert acct.rank_syncs == 2 * acct.launches


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_phase_counters_fit_in_ann_ns_and_merge_sums_them(db, wiki,
                                                          precision):
    a = _batch(db, wiki, precision)[0].batch
    b = _batch(db, wiki, precision)[0].batch
    for acct in (a, b):
        assert acct.rank_host_ns > 0 and acct.rank_wait_ns > 0
        assert acct.rank_host_ns + acct.rank_wait_ns <= acct.ann_ns
        # the flat launch tiles the executor layer: little is left over
        assert acct.rank_host_ns + acct.rank_wait_ns >= 0.9 * acct.ann_ns
        assert acct.rank_syncs >= acct.launches > 0
    total = BatchAccounting().merge(a).merge(b)
    for name in ("rank_host_ns", "rank_wait_ns", "rank_syncs"):
        assert getattr(total, name) == getattr(a, name) + getattr(b, name)
    assert "rank_syncs" in total.snapshot()
    assert not hasattr(total, "sched_shed")


def test_nested_tiles_count_each_moment_once():
    acct = BatchAccounting()
    t0 = time.perf_counter_ns()
    with trace.counting(acct), trace.Tiles(trace.RUN, spans=False):
        time.sleep(0.01)                    # the outer dispatch: host
        with trace.Tiles() as inner:        # pauses the outer
            inner.to(trace.GET)
            time.sleep(0.02)                # a copy back: wait
            inner.synced(2)
        time.sleep(0.01)                    # the outer again: host
    total = time.perf_counter_ns() - t0
    assert acct.rank_wait_ns >= 20_000_000
    assert acct.rank_host_ns >= 20_000_000
    assert acct.rank_host_ns + acct.rank_wait_ns <= total
    assert acct.rank_syncs == 2


def test_no_batch_no_counting(db, wiki):
    assert trace.current() is None
    acct = BatchAccounting()
    with trace.counting(acct):
        assert trace.current() is acct
    assert trace.current() is None
    # a direct call ranks outside any batch: its tiles count nothing
    q, paths, _ = _requests(wiki)
    db.executors["flat"].search(q[:2], K)
    assert acct.rank_syncs == 0 and acct.rank_host_ns == 0


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_answers_are_bit_identical_under_a_recording_profiler(db, wiki,
                                                              precision):
    plain = _batch(db, wiki, precision)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _batch(db, wiki, precision)
    for p, t in zip(plain, traced):
        np.testing.assert_array_equal(p.ids, t.ids)
        np.testing.assert_array_equal(p.scores, t.scores)
