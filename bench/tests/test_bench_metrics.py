"""Each metric's arithmetic, the roofline's counts, and the discovery of
cells, configurations, traffic and metrics by name."""
import types

import numpy as np
import pytest

from bench import devtrace, harness, roofline

from _bench_helpers import ROOT, bench_with


def _fake_run():
    run = types.SimpleNamespace()
    run.t0, run.t1, run.seconds, run.t_drained = 10.0, 20.0, 10.0, 25.0
    # arrivals 9.5 (warm-up), 10..19 in the window, 20.5 (after it)
    run.arrival = [9.5] + [10.0 + i for i in range(10)] + [20.5]
    run.done_t = [9.6] + [10.1 + i for i in range(10)] + [20.6]
    run.status = [harness.OK] * 12
    run.status[5] = harness.SHED          # arrival 14.0: waits to 25.0
    run.done_t[5] = float("nan")
    run.ops = []
    for name in ("in_window", "_window_dsq", "dsq_latencies",
                 "ok_latencies", "dsq_completed_in_window", "counts"):
        setattr(run, name, getattr(harness.Run, name).__get__(run))
    return run


def test_tail_covers_every_window_request_and_the_rate_the_whole_window():
    run = _fake_run()
    lat = run.dsq_latencies()
    assert len(lat) == 10                             # window arrivals only
    assert lat[4] == pytest.approx(11.0)              # shed: until the drain
    p95 = harness.load_module("metrics", "dsq_p95_ms").read(run, {})
    assert p95 == pytest.approx(np.percentile(lat, 95) * 1e3)
    qps = harness.load_module("metrics", "dsq_qps").read(run, {})
    assert qps == pytest.approx(9 / 10.0)             # 9 answered in window
    assert run.counts() == {"attempted": 10, "failed": 1, "never": 0}


def test_roofline_counts_equal_hand_counts():
    # two requests of d = 4, scopes of 3 and 5 rows, union 6 rows, k = 2
    w = roofline.batch_work("fp32", 4, 2, 2, [3, 5], 6)
    assert w["fp32_flops"] == 2 * 4 * (3 + 5)
    assert w["bytes"] == 4 * 4 * 6 + 4 * 4 * 2 + 8 * 2 * 2
    # int8, window 4: the 3-row scope is ranked exactly, the 5-row one is
    # scanned at int8 (union of scanned scopes: 5 rows) and 4 rescored
    w8 = roofline.batch_work("int8", 4, 2, 4, [3, 5], 5)
    assert w8["int8_ops"] == 2 * 4 * 5
    assert w8["fp32_flops"] == 2 * 4 * (3 + 4)
    assert w8["bytes"] == (4 + 4) * 5 + 4 * 4 * 7 + (5 * 4 + 4) * 2 + 8 * 2 * 2
    peaks = roofline.PEAKS
    assert roofline.bound_s(w, peaks) == max(w["fp32_flops"] / 67e12,
                                             w["bytes"] / 3.35e12)


def test_devtrace_reads_busy_idle_and_each_batch_ranking_kernels():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.traced",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.batch#7",
         "ts": 10, "dur": 50, "tid": 2},
        {"ph": "X", "cat": "user_annotation", "name": "dsq.rank",
         "ts": 20, "dur": 30, "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 21, "dur": 1, "tid": 2, "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 1, "tid": 3, "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": "scan_pass1_tiled", "ts": 25,
         "dur": 20, "tid": 7, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 40, "dur": 20,
         "tid": 7, "args": {"correlation": 6}},
    ]
    info = devtrace.parse(ev, launched=1)
    assert info.window_s == pytest.approx(100e-6)
    assert info.busy_s == pytest.approx(35e-6)        # 25..60
    assert info.rank_s == {7: pytest.approx(20e-6)}   # kernel 6 is not its
    assert info.launches == {"launch_counters": 1, "trace_scan_pass1": 1}
    # each idle gap is named by the spans open at its midpoint
    assert info.gaps == {"bench.batch": pytest.approx(25e-6),   # 0..25
                         "no span": pytest.approx(40e-6)}       # 60..100
    b = info.breakdown()
    assert b["device_ops"][0] == ["scan_pass1_tiled", pytest.approx(20e-6)]


@pytest.mark.parametrize("cell", ["wiki-fp32.dsq-sat", "arxiv-int8.dsq-open",
                                  "wiki-fp32.dsq-dsm"])
def test_cells_configs_traffic_and_metrics_found_by_name(cell):
    spec = harness.cell_spec(cell, bench_with(cell))
    assert spec["config"]["name"] == spec["entry"]["config"]
    for s in spec["workload"]["streams"]:
        assert hasattr(harness.load_module("traffic", s["kind"]), "Stream")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    # a split name falls back to its quantity's reader
    assert (harness.load_module("metrics", "ann_ms.sat").__file__
            == str(ROOT / "bench" / "metrics" / "ann_ms.py"))


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"]
