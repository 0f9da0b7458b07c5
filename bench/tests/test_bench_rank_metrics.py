"""The executor phase readers (``rank_host_ms``, ``rank_wait_ms``,
``rank_syncs``): means over the window's batches, and nothing from a
program whose accounting lacks the counters."""
import types

import pytest

from bench import harness


def _run(accts):
    run = types.SimpleNamespace()
    batches = [types.SimpleNamespace(acct=a) for a in accts]
    run.window_batches = lambda: batches
    return run


def _acct(host_ns, wait_ns, syncs):
    return types.SimpleNamespace(ann_ns=host_ns + wait_ns + 1_000,
                                 rank_host_ns=host_ns, rank_wait_ns=wait_ns,
                                 rank_syncs=syncs)


@pytest.mark.parametrize("name,want", [("rank_host_ms.sat", 3.0),
                                       ("rank_wait_ms.sat", 0.5),
                                       ("rank_syncs.sat", 201.0)])
def test_phase_readers_average_the_window_batches(name, want):
    run = _run([_acct(2_000_000, 250_000, 200), None,
                _acct(4_000_000, 750_000, 202)])
    got = harness.load_module("metrics", name).read(run, {})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["rank_host_ms.sat", "rank_wait_ms.sat",
                                  "rank_syncs.sat"])
def test_phase_readers_report_nothing_without_the_counters(name):
    mod = harness.load_module("metrics", name)
    assert mod.read(_run([]), {}) is None
    # an accounting from before the counters existed
    assert mod.read(_run([types.SimpleNamespace(ann_ns=5)]), {}) is None
