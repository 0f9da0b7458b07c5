"""The check comes out false when the timed path is broken underneath,
once for each fault a cell can have: an answer altered where it is made,
half of a batch left out, a DSM step that leaves the state unchanged. (One
card: no exchange between cards to leave out.)"""
import numpy as np
import pytest

from test_bench_run import _run


def _alter_answer(run):
    """The first id of every answer replaced where the executor makes it."""
    ex = run.db.executors["flat"]
    for name in ("search", "search_multi"):
        fn = getattr(ex, name)

        def wrapped(*a, _fn=fn, **kw):
            scores, ids = _fn(*a, **kw)
            ids = ids.copy()
            ids[:, 0] = np.where(ids[:, 0] >= 0,
                                 (ids[:, 0] + 1) % len(run.db.store), -1)
            return scores, ids
        setattr(ex, name, wrapped)


def _drop_half_the_batch(run):
    """The second half of every batch is left unanswered (empty)."""
    inner = run._execute

    def wrapped(payloads, staged):
        results = inner(payloads, staged)
        for r in results[len(results) // 2:]:
            r.ids = np.full_like(r.ids, -1)
            r.scores = np.full_like(r.scores, -np.inf)
        return results
    run._execute = wrapped


def _dsm_state_unchanged(run):
    """Every DSM op acknowledged, none applied."""
    from repro_torch.core import DSMBatchResult

    def fake(ops, **kw):
        return DSMBatchResult(results=[None] * len(ops),
                              errors=[None] * len(ops))
    run.db.dsm_batch = fake


@pytest.mark.parametrize("cell,fault", [
    ("wiki-fp32.dsq-sat", _alter_answer),
    ("arxiv-int8.dsq-open", _alter_answer),
    ("wiki-fp32.dsq-sat", _drop_half_the_batch),
    ("arxiv-int8.dsq-open", _drop_half_the_batch),
    ("wiki-fp32.dsq-dsm", _dsm_state_unchanged),
])
def test_broken_timed_path_is_not_correct(tmpdir_env, cell, fault):
    line, _ = _run(cell, faults=fault)
    assert not line["correct"], line["checks"]
