"""Small versions of the benchmark's cells, for its CPU tests."""
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[2]

SMALL = {"scale": 0.002, "dim": 32, "query_pool": 1024, "check_sample": 128,
         "warm_s": 0.3}


# the cells whose files are kept for a later change (not yet in
# BENCHMARK.json), with the metrics they would report
LATER = {"arxiv-int8.dsq-open": ["dsq_p95_ms"],
         "wiki-fp32.dsq-dsm": ["dsq_p95_ms", "dsm_p95_ms"]}
LATER_LAYERS = ["queue_wait_ms.open", "directory_ms.open",
                "scope_hit_pct.open", "ann_ms.open",
                "rank_roofline.open", "idle_pct.open"]


def bench_with(cell: str) -> dict:
    """BENCHMARK.json, with ``cell`` and its metrics added when it is one
    of the cells kept for later."""
    bench = harness.with_workload(cell)
    if cell not in LATER:
        return bench
    for name in LATER[cell]:
        bench["end_to_end"].append({"name": name, "unit": "ms",
                                    "better": "lower",
                                    "source": "host_clock",
                                    "workloads": [cell]})
    layers = LATER_LAYERS + (["dsm_apply_ms"] if "dsm" in cell else [])
    for name in layers:
        bench["per_layer"].append({"name": name, "unit": "ms",
                                   "workloads": [cell]})
    return bench


def small_spec(cell: str, rate: float = 150.0, clients: int = 32,
               max_batch: int = 16) -> dict:
    spec = harness.cell_spec(cell, bench_with(cell))
    spec["config"]["scheduler"]["max_batch"] = max_batch
    for s in spec["workload"]["streams"]:
        if s["kind"] == "open_loop":
            s["qps"] = rate
        if s["kind"] == "closed_loop":
            s["clients"] = clients
        if s["kind"] == "dsm_stream":
            s["ops_per_s"] = 40.0
    return spec
