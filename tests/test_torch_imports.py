"""The port stands alone: importing every module of ``repro_torch`` (and the
chip smoke script) pulls in neither JAX nor any module of the ``repro``
package, and a database asked for the default device does not quietly run
on the CPU when there is no card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), " ".join(bad))
"""


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + [env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, _, bad = proc.stdout.strip().partition(" ")
    assert int(n_mods) >= 25, proc.stdout          # every module was walked
    assert bad == "", f"port imported {bad}"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from repro_torch.vectordb import DirectoryVectorDB
    with pytest.raises(RuntimeError, match="CUDA"):
        DirectoryVectorDB(dim=16)
    db = DirectoryVectorDB(dim=16, device="cpu")
    assert db.device.type == "cpu"
