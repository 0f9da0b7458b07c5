"""The port's four examples run end to end on the CPU (``--device cpu``),
each in a subprocess with a timeout, and the quickstart's result lines
equal those of the reference's quickstart run beside it: scope sizes, top
ids, invariants, bit-identity verdicts and recall, with timings and byte
counts stripped."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# lines that name the cost model's source or backend, or read its
# prediction against a measurement: the reference's calibration/cpu.json
# was measured by the other package, so these may differ
MAY_DIFFER = ("model: CostModel(", "int8 request under the measured model")

_TIME = re.compile(r"\s*\d+(?:\.\d+)?\s*(?:us|ms|s)\b")
_BYTES = re.compile(r"\b\d+B\b")
# launch counts: the reference launches once per gather-plan scope, the
# port ranks a batch's fp32 gather scopes in one launch; the port's sharded
# line also names its batch's plans, which the reference's does not
_LAUNCHES = re.compile(r"\b(\d+) launches\b")
_PLANS = re.compile(r" \(plans: \{[^}]*\}\)")
_GATHER = re.compile(r"'gather': (\d+)")

def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    return env


def _start(script, *argv):
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script),
                             *argv], env=_env(), cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return out


def _result_lines(text):
    return [_BYTES.sub("<bytes>", _TIME.sub(" <time>", line))
            for line in text.splitlines()
            if line.strip() and not line.startswith(MAY_DIFFER)]


def test_quickstart_matches_reference_lines():
    port = _start("torch_quickstart.py", "--device", "cpu")
    ref = _start("quickstart.py")
    got, want = _finish(port), _finish(ref)
    assert "invariants OK" in got and "bit-identical" in got
    got, want = _result_lines(got), _result_lines(want)
    assert len(got) == len(want)
    counted = 0
    for mine, theirs in zip(got, want):
        n, m = _LAUNCHES.search(mine), _LAUNCHES.search(theirs)
        if n is None or m is None:
            assert mine == theirs
            continue
        counted += 1
        plans = _GATHER.search(theirs) or _GATHER.search(mine)
        if not _PLANS.search(theirs):
            mine = _PLANS.sub("", mine)
        assert (_LAUNCHES.sub("<n> launches", mine)
                == _LAUNCHES.sub("<n> launches", theirs))
        # the batch's gather scopes (none on the IVF and PG lines) take one
        # launch, not one each
        gather = int(plans.group(1)) if plans else 0
        n, m = int(n.group(1)), int(m.group(1))
        assert n == m - gather + (gather > 0), (mine, n, m, gather)
    assert counted == 4


def test_rag_serve_example_runs():
    out = _finish(_start("torch_rag_serve.py", "--device", "cpu",
                         "--requests", "3", "--new-tokens", "4",
                         "--contexts", "200"))
    assert "served 3 requests x 4 tokens" in out
    assert out.rstrip().endswith("OK")


def test_openviking_example_matches_reference_lines():
    got = _finish(_start("torch_openviking_context.py", "--device", "cpu"))
    want = _finish(_start("openviking_context.py"))
    assert got.rstrip().endswith("OK")
    assert _result_lines(got) == _result_lines(want)


def test_train_small_example_runs(tmp_path):
    out = _finish(_start("torch_train_small.py", "--device", "cpu",
                         "--steps", "5", "--ckpt-dir", str(tmp_path)))
    assert "arch=mamba2-130m" in out and out.rstrip().endswith("done")
    assert any(tmp_path.iterdir())           # a checkpoint was written


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_rag_serve.py",
                                    "torch_openviking_context.py",
                                    "torch_train_small.py"])
def test_examples_default_to_the_card(script):
    """Without ``--device`` each example asks for the card, and raises
    where there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           "--steps", "1"] if script == "torch_train_small.py"
                          else [sys.executable,
                                str(ROOT / "examples" / script)],
                          env=_env(), cwd=str(ROOT), capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
