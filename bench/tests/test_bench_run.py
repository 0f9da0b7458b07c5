"""A whole run on the CPU at a small size: the result line's keys, the
checks beside their limits, and a traced run's per-layer metrics."""
import io
import json

import pytest

from bench import harness

from _bench_helpers import SMALL, small_spec

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(cell, faults=None, trace=False, seed=2 ** 31 + 11):
    out, err = io.StringIO(), io.StringIO()
    line = harness.execute(small_spec(cell), seed, 1.0, trace, device="cpu",
                           overrides=SMALL, faults=faults, out=out, err=err)
    json.dumps(line)
    return line, err.getvalue()


@pytest.mark.parametrize("cell", ["wiki-fp32.dsq-sat", "arxiv-int8.dsq-open",
                                  "wiki-fp32.dsq-dsm"])
def test_sound_run_is_correct_and_prints_the_result_keys(tmpdir_env, cell):
    line, err = _run(cell)
    assert list(line) == KEYS                        # the checks come last
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    spec = small_spec(cell)
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["device"]["platform"] == "cpu"
    # every compared number is on standard error, beside its limit
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err


def test_traced_run_reports_per_layer_metrics(tmpdir_env):
    line, _ = _run("arxiv-int8.dsq-open", trace=True)
    spec = small_spec("arxiv-int8.dsq-open")
    names = {m["name"] for m in spec["per_layer"]}
    # the CPU has no device trace: the rooflines find nothing to read
    assert {"queue_wait_ms.open", "directory_ms.open",
            "ann_ms.open"} <= set(line["metrics"]) <= names
    assert "rank_roofline.open" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_open_loop_without_a_swept_rate_refuses_to_run():
    # the DSM cell's file carries no rate until a sweep has found one
    spec = harness.cell_spec("wiki-fp32.dsq-dsm",
                             harness.with_workload("wiki-fp32.dsq-dsm"))
    params = spec["workload"]["streams"][0]
    assert params["kind"] == "open_loop" and params["qps"] is None
    with pytest.raises(ValueError, match="sweep"):
        harness.load_module("traffic", "open_loop").Stream(None, params, 7)


def test_set_up_freezes_its_objects_until_the_program_is_freed(tmpdir_env):
    import gc
    run = harness.Run(small_spec("wiki-fp32.dsq-sat"), 5, 1.0, False, "cpu",
                      overrides=SMALL, out=io.StringIO())
    run.setup()
    frozen = gc.get_freeze_count()
    assert frozen > 0
    run.free_program()
    assert gc.get_freeze_count() < frozen
