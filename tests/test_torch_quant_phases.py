"""The two phases of the quantized plan in the port's tracing.

A small ARXIV-shaped ``device="cpu"`` database (subject and temporal trees,
both ingested) answers int8, PQ and fp32 batches. The always-on counters
``approx_ns`` (phase 1: the int8 / PQ scan or gather and its copy back) and
``rescore_ns`` (the exact fp32 ``gather_rescore``) lie inside the
executor's ``rank_host_ns + rank_wait_ns``; ``gather_alone`` counts the
gather groups ranked one executor call each; an fp32 batch reads 0 in all
three. The spans ``rank.approx`` and ``rank.rescore`` exist only while a
profiler records, and nothing changes an answer: a batch equals a loop of
``dsq`` bit for bit, counted or not.
"""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.datasets import make_arxiv_dir
from repro_torch.vectordb import DirectoryVectorDB
from repro_torch.vectordb.planner import BatchAccounting

K = 10
DIM = 32
NAMESPACES = ("fs", "time")
QUANTIZED = ("int8", "pq")
PHASES = ("approx_ns", "rescore_ns", "gather_alone")


@pytest.fixture(scope="module")
def arxiv():
    return make_arxiv_dir(scale=0.004, dim=DIM, n_queries=32, seed=11)


@pytest.fixture(scope="module")
def db(arxiv):
    db = DirectoryVectorDB(dim=DIM, scope_strategy="triehi",
                           calibration=False, device="cpu")
    db.ingest(arxiv.vectors, arxiv.entry_paths,
              namespaces=arxiv.extra_namespaces)
    db.build_ann("flat")
    return db


def _entry_paths(arxiv, namespace):
    return (arxiv.entry_paths if namespace == "fs"
            else arxiv.extra_namespaces[namespace])


def _requests(db, arxiv, namespace):
    """The whole tree (a scan group), every directory's own rows (one
    non-recursive scope each: those past the rescore window and under the
    gather crossover are int8 / PQ gather groups, the rest fp32 gather or
    scan groups) and, on the subject tree, the dataset's own anchors."""
    dirs = sorted(set(_entry_paths(arxiv, namespace)))
    paths = ["/"] + dirs
    rec = [True] + [False] * len(dirs)
    if namespace == "fs":
        paths += list(arxiv.query_anchors)
        rec += [bool(r) for r in arxiv.query_recursive]
    q = arxiv.queries[np.arange(len(paths)) % len(arxiv.queries)]
    return q, paths, rec


def _spy_groups(db, namespace, monkeypatch):
    """The planner's groups of every batch, as it made them."""
    planner = db.planner(namespace)
    made = []
    plan = planner.plan

    def spied(*a, **kw):
        groups = plan(*a, **kw)
        made.append(groups)
        return groups
    monkeypatch.setattr(planner, "plan", spied)
    return made


def _batch(db, arxiv, namespace, precision):
    q, paths, rec = _requests(db, arxiv, namespace)
    return db.dsq_batch(q, paths, k=K, recursive=rec, namespace=namespace,
                        precision=precision)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.ids, w.ids, err_msg=str(i))
        np.testing.assert_array_equal(g.scores, w.scores, err_msg=str(i))


@pytest.mark.parametrize("namespace", NAMESPACES)
@pytest.mark.parametrize("precision", QUANTIZED)
def test_quantized_batch_counts_both_phases_inside_the_rank_terms(
        db, arxiv, namespace, precision, monkeypatch):
    made = _spy_groups(db, namespace, monkeypatch)
    acct = _batch(db, arxiv, namespace, precision)[0].batch
    (groups,) = made
    alone = [g for g in groups if g.plan == "gather"
             and g.precision == precision]
    assert alone, "no quantized gather group: the test lost its subject"
    assert any(g.plan == "scan" for g in groups)
    assert acct.approx_ns > 0 and acct.rescore_ns > 0
    assert (acct.approx_ns + acct.rescore_ns
            <= acct.rank_host_ns + acct.rank_wait_ns <= acct.ann_ns)
    assert acct.gather_alone == len(alone)
    assert acct.gather_alone + acct.gather_listed == acct.plan_groups[
        "gather"]


@pytest.mark.parametrize("namespace", NAMESPACES)
def test_fp32_batch_reads_zero_in_every_phase_counter(db, arxiv, namespace):
    acct = _batch(db, arxiv, namespace, "fp32")[0].batch
    assert acct.plan_groups.get("gather", 0) == acct.gather_listed > 0
    for name in PHASES:
        assert getattr(acct, name) == 0, name
    assert acct.rank_host_ns > 0 and acct.rank_syncs > 0


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("precision", ("int8", "pq", "fp32"))
def test_batch_equals_a_loop_of_dsq_bit_for_bit(db, arxiv, precision,
                                                counted):
    q, paths, rec = _requests(db, arxiv, "fs")
    res = db.dsq_batch(q, paths, k=K, recursive=rec, precision=precision)
    outer = BatchAccounting()
    with trace.counting(outer) if counted else trace.counting(None):
        loop = [db.dsq(q[i], paths[i], k=K, recursive=rec[i],
                       precision=precision) for i in range(len(paths))]
    _assert_bitwise(res, loop)
    # ``dsq`` ranks through the same executor calls: under an accounting
    # they count there, outside one nowhere
    quantized = precision != "fp32"
    assert (outer.approx_ns > 0) == (counted and quantized)
    assert (outer.rescore_ns > 0) == (counted and quantized)
    assert outer.gather_alone == 0          # no batch launch in a loop


@pytest.mark.parametrize("precision", QUANTIZED)
def test_profiled_batch_exports_both_phase_spans_nested(db, arxiv, tmp_path,
                                                        precision):
    plain = _batch(db, arxiv, "fs", precision)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _batch(db, arxiv, "fs", precision)
    _assert_bitwise(traced, plain)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = {}
    for e in events:
        a = float(e["ts"])
        spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))

    def inside(child, parent):
        return all(any(pa <= a and b <= pb for pa, pb in spans[parent])
                   for a, b in spans[child])
    acct = traced[0].batch
    # one phase-1 region a scan launch and a quantized gather group, one
    # rescore each
    n_calls = acct.gather_alone + 1
    assert len(spans[trace.APPROX]) == n_calls
    assert len(spans[trace.RESCORE]) == n_calls
    for name in (trace.APPROX, trace.RESCORE):
        assert inside(name, "db.rank"), name
        assert len(name) <= 12 and sorted([name, "sched.exec"])[0] == name
    # each region holds its executor call's tiles, down to the copy back
    for name in (trace.APPROX, trace.RESCORE):
        for pa, pb in spans[name]:
            assert any(pa <= a and b <= pb for a, b in spans[trace.GET])


@pytest.mark.parametrize("precision", QUANTIZED)
def test_phase_regions_make_no_record_function_unless_profiling(
        db, arxiv, precision, monkeypatch):
    assert not trace.recording()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while not profiling")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    acct = _batch(db, arxiv, "fs", precision)[0].batch
    assert acct.approx_ns > 0 and acct.rescore_ns > 0


@pytest.mark.parametrize("region,field", [(trace.approx, "approx_ns"),
                                          (trace.rescore, "rescore_ns")])
def test_region_adds_its_host_time_to_its_counter_only(region, field):
    acct = BatchAccounting()
    with region():                      # outside a batch: nothing counted
        time.sleep(0.002)
    assert getattr(acct, field) == 0
    t0 = time.perf_counter_ns()
    with trace.counting(acct), trace.Tiles(trace.RUN, spans=False):
        with region():
            time.sleep(0.01)
    total = time.perf_counter_ns() - t0
    assert 10_000_000 <= getattr(acct, field) <= acct.rank_host_ns <= total
    others = [f for f in ("approx_ns", "rescore_ns") if f != field]
    assert all(getattr(acct, f) == 0 for f in others)


@pytest.mark.parametrize("name", PHASES)
def test_merge_sums_and_snapshot_lists_each_phase_counter(db, arxiv, name):
    a = _batch(db, arxiv, "fs", "int8")[0].batch
    b = _batch(db, arxiv, "time", "int8")[0].batch
    total = BatchAccounting().merge(a).merge(b)
    assert getattr(total, name) == getattr(a, name) + getattr(b, name) > 0
    assert total.snapshot()[name] == getattr(total, name)
