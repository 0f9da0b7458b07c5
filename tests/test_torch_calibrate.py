"""The port's calibration sweep (``repro_torch.analysis.calibrate``) on the
CPU at its smoke grid (dim 32, ~4 s), against the reference's
``repro.analysis.calibrate`` and ``calibration/cpu.json``.

The artifact round-trips through ``CalibrationArtifact`` with the
reference's schema (the same keys as ``calibration/cpu.json``) and loads
as ``"measured"`` on a database of its backend, with the cost model's
clamps holding. The rescore recall curve is a recall, deterministic for a
seed, and equals the reference's; so does the IVF nprobe recall curve,
because at this size the port's k-means partitions are XLA's (ROADMAP
"Standing differences" names sizes where they are not). The block sweep
counts each wrapper's default launch among its candidates, and an
installed artifact's blocks leave every answer unchanged.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import calibrate as jcal  # noqa: E402
from repro_torch.analysis import calibrate as cal  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.vectordb import (CalibrationArtifact,  # noqa: E402
                                  DirectoryVectorDB, model_of)
from repro_torch.vectordb.costmodel import (NPROBE_FLOOR,  # noqa: E402
                                            THRESHOLD_BOUNDS,
                                            TUNABLE_KERNELS)
from repro_torch.vectordb.quant import DEFAULT_RESCORE_FACTOR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def artifact():
    return cal.calibrate(dim=32, seed=0, smoke=True, device="cpu")


def test_artifact_schema_and_roundtrip(artifact, tmp_path):
    want = json.loads((ROOT / "calibration" / "cpu.json").read_text())
    data = artifact.data
    assert sorted(data) == sorted(want)
    assert sorted(data["terms"]) == sorted(want["terms"])
    assert data["backend"] == "cpu" and data["device_kind"] == "cpu"
    assert sorted(data["terms"]["kernel_blocks"]) == sorted(TUNABLE_KERNELS)
    for spec in data["terms"]["kernel_blocks"].values():
        assert sorted(spec) == ["block_n", "block_q", "us"]
    for prec in ("fp32", "int8", "pq"):
        assert sorted(data["terms"]["scan_ns"][prec]) == ["a", "per_byte"]
    path = tmp_path / "cpu.json"
    artifact.save(str(path))
    back = CalibrationArtifact.load(str(path))
    assert back.data == json.loads(json.dumps(data))
    assert back.backend == "cpu" and back.dim == 32


def test_measured_model_clamps_hold(artifact):
    db = DirectoryVectorDB(dim=32, calibration=artifact.data, device="cpu")
    model = model_of(db.store)
    assert model.source == "measured"
    lo, hi = THRESHOLD_BOUNDS
    assert lo <= model.gather_threshold(1000, 10) <= hi
    assert model.pick_rescore_k(10, None, 1000) >= DEFAULT_RESCORE_FACTOR * 10
    assert model.default_nprobe(64) >= NPROBE_FLOOR
    # the kernel blocks were installed; results do not depend on them
    assert ops.get_block_overrides() == model.kernel_blocks()
    ops.set_block_overrides({})


def test_rescore_recall_curve_equals_reference():
    mine = cal.sweep_rescore_recall(2048, 32, 10, seed=0, device="cpu")
    theirs = jcal.sweep_rescore_recall(2048, 32, 10, seed=0)
    assert mine == theirs


def test_nprobe_curve_equals_reference(artifact):
    """At this size the port's k-means partitions are the reference's, so
    the recall curve and the default it picks are equal too; the times are
    each package's own."""
    curve = artifact.terms["nprobe"]["curve"]
    assert all(c["ns"] > 0 for c in curve)
    default, theirs = jcal.sweep_nprobe(2048, 32, 10, 1, seed=0)
    assert [(c["nprobe"], c["recall"]) for c in curve] == [
        (c["nprobe"], c["recall"]) for c in theirs]
    assert artifact.terms["nprobe"]["default"] == default


def test_block_sweep_candidates_include_the_default(monkeypatch):
    """With no other candidate the sweep returns each wrapper's default;
    under equal times the default (timed first) is kept."""
    for name in TUNABLE_KERNELS:
        bq, bn = cal.default_blocks(name, 8, 512, 32, 10, "cpu")
        assert bq == (64 if name.startswith("multi") else 8) and bn == 512
    only = cal.sweep_kernel_blocks(512, 32, 8, 10, 1, 0, (), "cpu")
    for name, spec in only.items():
        assert (spec["block_q"], spec["block_n"]) == cal.default_blocks(
            name, 8, 512, 32, 10, "cpu")
    timed = []

    def flat_clock(fn, repeat, device=None):
        timed.append(fn)
        return 1000.0
    monkeypatch.setattr(cal, "_clock_ns", flat_clock)
    ops.set_block_overrides({"scoped_topk": (8, 128)})
    tied = cal.sweep_kernel_blocks(512, 32, 8, 10, 1, 0, (128, 256), "cpu")
    assert ops.get_block_overrides() == {"scoped_topk": (8, 128)}
    ops.set_block_overrides({})
    assert len(timed) == 3 * len(TUNABLE_KERNELS)
    for name, spec in tied.items():
        assert spec["block_n"] == 512, name


def test_installed_blocks_leave_answers_unchanged(artifact):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(700, 32)).astype(np.float32)
    paths = [f"/d{i % 5}/" for i in range(700)]
    q = rng.normal(size=(6, 32)).astype(np.float32)
    scopes = ["/", "/d1/", "/d2/"] * 2
    out = []
    for calib in (False, artifact.data):
        db = DirectoryVectorDB(dim=32, calibration=calib, device="cpu")
        db.ingest(rows, paths)
        db.build_ann("flat")
        out.append(db.dsq_batch(q, scopes, k=5))
        loop = [db.dsq(q[i], scopes[i], k=5) for i in range(6)]
        for a, b in zip(out[-1], loop):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.scores, b.scores)
    ops.set_block_overrides({})
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_cli_writes_the_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(cal, "calibrate", lambda **kw: CalibrationArtifact({
        "schema_version": 1, "backend": kw["device"], "dim": kw["dim"],
        "terms": {}}))
    out = tmp_path / "a.json"
    assert cal.main(["--device", "cpu", "--out", str(out), "--smoke"]) == 0
    assert CalibrationArtifact.load(str(out)).backend == "cpu"
    monkeypatch.chdir(tmp_path)
    assert cal.main(["--device", "cpu", "--smoke"]) == 0
    assert (tmp_path / "calibration" / "cpu.json").exists()
