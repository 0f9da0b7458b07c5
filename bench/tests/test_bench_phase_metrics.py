"""The readers of the quantized plan's two phases (``approx_ms``,
``rescore_ms``) and of the gather groups ranked one call each
(``gather_alone``): means over the window's batches, nothing from a
program whose accounting lacks the counters; and the cell that reports
them, ``arxiv-int8.dsq-open``, found by name in ``BENCHMARK.json``."""
import io
import types

import pytest

from bench import harness

from _bench_helpers import SMALL, small_spec

CELL = "arxiv-int8.dsq-open"
PHASE_LAYERS = ["approx_ms.open", "rescore_ms.open", "gather_alone.open"]
TWINS = ["queue_wait_ms.open", "directory_ms.open", "scope_hit_pct.open",
         "ann_ms.open", "rank_roofline.open", "idle_pct.open"]


def _run(accts):
    run = types.SimpleNamespace()
    batches = [types.SimpleNamespace(acct=a) for a in accts]
    run.window_batches = lambda: batches
    return run


def _acct(approx_ns, rescore_ns, alone):
    return types.SimpleNamespace(ann_ns=approx_ns + rescore_ns + 1_000,
                                 approx_ns=approx_ns, rescore_ns=rescore_ns,
                                 gather_alone=alone)


@pytest.mark.parametrize("name,want", [("approx_ms.open", 2.5),
                                       ("rescore_ms.open", 0.75),
                                       ("gather_alone.open", 1.5)])
def test_phase_readers_average_the_window_batches(name, want):
    run = _run([_acct(1_000_000, 500_000, 0), None,
                _acct(4_000_000, 1_000_000, 3)])
    got = harness.load_module("metrics", name).read(run, {})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", PHASE_LAYERS)
def test_phase_readers_report_nothing_without_batches_or_counters(name):
    mod = harness.load_module("metrics", name)
    assert mod.read(_run([]), {}) is None
    assert mod.read(_run([None]), {}) is None
    # an accounting from a program that predates the counters
    assert mod.read(_run([types.SimpleNamespace(ann_ns=5)]), {}) is None


def test_the_int8_cell_is_listed_with_its_metrics():
    spec = harness.cell_spec(CELL)
    assert spec["entry"]["config"] == "arxiv-int8"
    assert spec["entry"]["chips"] == 1
    assert spec["config"]["precision"] == "int8"
    assert [s["qps"] for s in spec["workload"]["streams"]] == [400.0]
    assert {m["name"] for m in spec["end_to_end"]} == {"dsq_qps", "setup_s"}
    layers = {m["name"]: m for m in spec["per_layer"]}
    assert set(layers) == set(TWINS + PHASE_LAYERS)
    assert all(m["moves"] == "dsq_qps" and m["workloads"] == [CELL]
               for m in layers.values())
    # the saturating cell reports none of them
    sat = harness.cell_spec("wiki-fp32.dsq-sat")
    assert not {m["name"] for m in sat["per_layer"]} & set(layers)


def test_traced_int8_run_splits_ann_ms_into_its_phases(tmpdir_env):
    line = harness.execute(small_spec(CELL), 2 ** 31 + 29, 1.0, True,
                           device="cpu", overrides=SMALL, out=io.StringIO(),
                           err=io.StringIO())
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(PHASE_LAYERS) <= set(got)
    assert got["approx_ms.open"] > 0 and got["rescore_ms.open"] > 0
    assert got["approx_ms.open"] + got["rescore_ms.open"] <= got[
        "ann_ms.open"]
    assert line["metrics"]["gather_alone.open"]["unit"] == "groups"
