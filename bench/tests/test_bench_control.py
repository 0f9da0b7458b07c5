"""The controls, the reference put in the program's place at a lower
precision, come out not correct (at a small size; the card runs them at
the cells' size with ``bench/control.py``)."""
import numpy as np
import pytest
import torch

from bench import control, harness

from _bench_helpers import SMALL, small_spec


def _readings(cell, device="cpu", seed=3):
    run = harness.Run(small_spec(cell), seed, 1.0, False, device,
                      overrides=SMALL)
    return dict(control.readings(run, 256, 40,
                                 np.random.default_rng([seed, 7])))


@pytest.mark.parametrize("cell,name", [
    ("wiki-fp32.dsq-sat", "int8_no_rescore"),
    ("arxiv-int8.dsq-open", "int4"),
    ("arxiv-int8.dsq-open", "int8_no_rescore"),
    ("wiki-fp32.dsq-dsm", "int8_no_rescore"),
])
def test_lower_precision_control_fails_the_check(cell, name):
    checks = _readings(cell)[name]
    assert not harness.passed(checks), checks


@pytest.mark.gpu
def test_tf32_control_fails_the_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    checks = _readings("wiki-fp32.dsq-sat", device="cuda")["tf32"]
    assert not harness.passed(checks), checks
