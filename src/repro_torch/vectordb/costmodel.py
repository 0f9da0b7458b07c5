"""Calibrated planner cost model — ONE measured decision layer.

Every post-resolution decision this system makes (gather-vs-scan plan shape,
fp32/int8/pq precision, rescore window width, IVF probe depth, kernel block
tiling, scheduler batch/wait targets) used to live in hand-set module
constants. This module replaces the constants with a :class:`CostModel` that
answers each question from one of three sources, in strength order:

* ``"measured"`` — a per-backend microbenchmark sweep
  (``repro.analysis.calibrate`` in the JAX package; the port's own sweep
  is still to come) persisted as a versioned JSON
  **calibration artifact**: linear scan/gather/rescore cost terms fitted
  against corpus size, the measured gather/scan crossover, a recall-gated
  rescore factor, an nprobe recall/latency curve, the fastest kernel block
  shapes, and the batch-size service curve.
* ``"roofline"`` — the analytic fallback when an artifact exists but was
  calibrated on a *different* backend string: bandwidth terms from the
  H100 SXM data sheet (:data:`HBM_BW`; a measured artifact never transfers
  across backends — the whole point of calibrating).
* ``"heuristic"`` — the hand-set constants, bit-for-bit: this is the default
  when no artifact is supplied, and the contract is that a heuristic model
  reproduces the pre-cost-model planner EXACTLY (gather threshold 0.05,
  rescore factor 4, nprobe 8, stock scheduler config, stock kernel blocks).

Correctness envelope — measured decisions may only move *latency*, never
recall, so every measured answer is clamped against the hand-set floor:
``pick_rescore_k`` never narrows below ``DEFAULT_RESCORE_FACTOR * k``,
``default_nprobe`` never probes fewer than 8 lists, ``pick_precision`` may
only *upgrade* toward exact fp32 (the int8 path on backends without an int8
GEMM — XLA:CPU — is the canonical measured win), and the crossover threshold
is clamped to a sane band. A randomly-perturbed artifact can therefore change
plans but never degrade the recall gates (the differential-fuzz row enforces
this).

Bit-identity contract: flat loop, flat batch and sharded paths all read the
SAME model instance through :func:`model_of(store)`, and every decision is a
pure function of (model, sizes) — so for any *fixed* artifact the whole
executor matrix stays bit-identical, exactly as with the hand-set constants.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .quant import DEFAULT_RESCORE_FACTOR, resolve_rescore_k

# HBM bandwidth of the roofline source: NVIDIA's H100 SXM data sheet figure
# (3.35 TB/s), the card this port targets -- not a measurement
HBM_BW = 3.35e12

SCHEMA_VERSION = 1
ENV_CALIBRATION = "REPRO_CALIBRATION"

# THE hand-set gather/scan selectivity crossover (re-exported by flat.py,
# which owns the decision *rule*; this module owns the *threshold*)
GATHER_THRESHOLD = 0.05

# measured answers are clamped to this crossover band: below it the gather
# plan would practically never fire, above it a scan would practically never
# fire — both are certainly a mis-fit artifact, not a real machine
THRESHOLD_BOUNDS = (0.005, 0.35)
NPROBE_FLOOR = 8                 # the hand-set default; measured never probes less

# roofline-fallback constants: dispatch overhead per launch and the random-
# access penalty of a gathered row fetch vs the streaming scan read
LAUNCH_NS = 50_000.0
GATHER_PENALTY = 8.0

TUNABLE_KERNELS = ("scoped_topk", "scoped_topk_i8", "scoped_topk_pq",
                   "multi_scope_topk", "multi_scope_topk_i8",
                   "multi_scope_topk_pq")


def _current_backend(device=None) -> str:
    """Backend string of a torch device (``"cuda"`` or ``"cpu"``) -- the
    database passes its own device; ``None`` means the default ``"cuda"``."""
    return torch.device("cuda" if device is None else device).type


class CalibrationArtifact:
    """Versioned JSON calibration artifact: validated dict + load/save.

    Schema (``schema_version == 1``)::

        {"schema_version": 1, "backend": "cpu", "device_kind": "...",
         "dim": 64, "batch": 8, "seed": 0, "created": <unix ts>,
         "terms": {
           "row_bytes":   {prec: bytes-per-row at ``dim``},
           "scan_ns":     {prec: {"a":  ns, "per_byte": ns}},
           "gather_ns":   {"a": ns, "per_row": ns},
           "rescore_ns":  {"a": ns, "per_row": ns},
           "gather_threshold": float,
           "rescore_factor":   int,   "rescore_recall": {factor: recall},
           "nprobe":      {"default": int, "curve": [...]},
           "kernel_blocks": {kernel: {"block_q": q, "block_n": n, "us": t}},
           "scheduler":   {"max_batch": int, "max_wait_ms": float,
                           "service_us": {batch: us}}}}

    Any other ``schema_version`` is rejected loudly — a silently re-interpreted
    stale artifact is exactly the mis-tuned-threshold bug class the VDBMS bugs
    survey warns about.
    """

    REQUIRED = ("backend", "dim", "terms")

    def __init__(self, data: Dict):
        if not isinstance(data, dict):
            raise ValueError(f"calibration artifact must be a dict, "
                             f"got {type(data).__name__}")
        version = data.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"calibration artifact schema_version {version!r} is not "
                f"{SCHEMA_VERSION}; recalibrate")
        missing = [key for key in self.REQUIRED if key not in data]
        if missing:
            raise ValueError(f"calibration artifact missing keys {missing}")
        self.data = data

    @property
    def backend(self) -> str:
        return str(self.data["backend"])

    @property
    def dim(self) -> int:
        return int(self.data["dim"])

    @property
    def terms(self) -> Dict:
        return self.data["terms"]

    @classmethod
    def load(cls, path: str) -> "CalibrationArtifact":
        with open(path) as f:
            return cls(json.load(f))

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.data, f, indent=1, sort_keys=True)
            f.write("\n")


class CostModel:
    """One queryable decision layer over a calibration source.

    ``source`` is ``"measured"`` (artifact matches the running backend),
    ``"roofline"`` (artifact from another backend — analytic fallback), or
    ``"heuristic"`` (no artifact — the hand-set constants, exactly)."""

    def __init__(self, source: str,
                 artifact: Optional[CalibrationArtifact] = None):
        assert source in ("heuristic", "roofline", "measured"), source
        self.source = source
        self.artifact = artifact

    def __repr__(self) -> str:
        backend = self.artifact.backend if self.artifact else None
        return f"CostModel(source={self.source!r}, backend={backend!r})"

    @classmethod
    def heuristic(cls) -> "CostModel":
        return HEURISTIC

    @classmethod
    def from_artifact(cls, artifact: CalibrationArtifact,
                      backend: Optional[str] = None,
                      device=None) -> "CostModel":
        """Measured when the artifact's backend matches the running one,
        roofline fallback otherwise — measurements never transfer across
        backends."""
        backend = _current_backend(device) if backend is None else backend
        if artifact.backend != backend:
            return cls("roofline", artifact)
        return cls("measured", artifact)

    # ------------------------------------------------------------ cost terms
    def row_bytes(self, precision: str, dim: int) -> float:
        if self.source == "measured":
            per = self.artifact.terms.get("row_bytes", {}).get(precision)
            if per is not None:
                return float(per) * dim / max(self.artifact.dim, 1)
        return {"fp32": 4.0 * dim, "int8": dim + 4.0,
                "pq": max(dim / 4.0, 1.0)}[precision]

    def scan_ns(self, n: int, precision: str = "fp32",
                dim: int = 64) -> float:
        """Predicted ns of one scan-plan launch over an ``n``-row store."""
        nbytes = n * self.row_bytes(precision, dim)
        if self.source == "measured":
            t = self.artifact.terms["scan_ns"].get(precision)
            if t is not None:
                return float(t["a"]) + float(t["per_byte"]) * nbytes
        return LAUNCH_NS + nbytes / HBM_BW * 1e9

    def gather_ns(self, m: int, dim: int = 64) -> float:
        """Predicted ns of one fp32 gather-plan launch over ``m`` rows."""
        if self.source == "measured":
            t = self.artifact.terms.get("gather_ns")
            if t is not None:
                return float(t["a"]) + float(t["per_row"]) * m
        return LAUNCH_NS + m * self.row_bytes("fp32", dim) \
            * GATHER_PENALTY / HBM_BW * 1e9

    def rescore_ns(self, r: int, dim: int = 64) -> float:
        """Predicted ns of one exact fp32 gather-rescore over ``r`` rows."""
        if self.source == "measured":
            t = self.artifact.terms.get("rescore_ns")
            if t is not None:
                return float(t["a"]) + float(t["per_row"]) * r
        return LAUNCH_NS + r * self.row_bytes("fp32", dim) \
            * GATHER_PENALTY / HBM_BW * 1e9

    # ------------------------------------------------------------- decisions
    def gather_threshold(self, n: Optional[int] = None,
                         k: Optional[int] = None) -> float:
        """Selectivity fraction below which the gather plan wins — the
        threshold ``flat.choose_plan`` (THE shared rule) compares against."""
        lo, hi = THRESHOLD_BOUNDS
        if self.source == "measured":
            t = self.artifact.terms.get("gather_threshold")
            if t is not None:
                return min(max(float(t), lo), hi)
        if self.source == "roofline":
            # crossover of m*penalty streaming-equivalent bytes vs n bytes
            return min(max(1.0 / GATHER_PENALTY, lo), hi)
        return GATHER_THRESHOLD

    def pick_precision(self, requested: str, n: int, k: int,
                       rescore_k: Optional[int], tiered: bool = False,
                       dim: int = 64) -> str:
        """Effective request precision. Measured models may *upgrade*
        ``int8`` to exact fp32 when the measured fp32 scan undercuts the
        int8 scan + rescore (XLA:CPU has no int8 GEMM kernel, so this is the
        common CPU verdict); recall can only improve. ``pq`` is never
        flipped — it is the tiered-serving format and its request may be a
        budget-forced upgrade that fp32 rows cannot serve — and a tiered
        store pins whatever precision the caller landed on."""
        if (self.source != "measured" or requested != "int8" or tiered
                or n == 0):
            return requested
        r = resolve_rescore_k(k, self.pick_rescore_k(k, rescore_k, n), n)
        quantized = self.scan_ns(n, "int8", dim) + self.rescore_ns(r, dim)
        exact = self.scan_ns(n, "fp32", dim)
        return "fp32" if exact <= quantized else requested

    def pick_rescore_k(self, k: int, rescore_k: Optional[int],
                       n: int) -> Optional[int]:
        """Effective ``rescore_k`` request value: an explicit caller value
        always wins; measured models substitute their recall-gated factor,
        floored at the hand-set ``DEFAULT_RESCORE_FACTOR`` so the window
        never narrows below the pre-cost-model recall contract."""
        if rescore_k is not None or self.source != "measured":
            return rescore_k
        factor = self.artifact.terms.get("rescore_factor")
        if factor is None:
            return None
        return max(int(factor), DEFAULT_RESCORE_FACTOR) * k

    def default_nprobe(self, n_lists: int) -> int:
        """IVF probe depth when the caller does not pass ``nprobe``; measured
        answers are floored at the hand-set 8 (recall never drops) and capped
        at ``n_lists``."""
        if self.source == "measured":
            got = self.artifact.terms.get("nprobe", {}).get("default")
            if got is not None:
                return max(NPROBE_FLOOR, min(int(got), max(n_lists, 1)))
        return min(NPROBE_FLOOR, max(n_lists, 1)) if n_lists else NPROBE_FLOOR

    def kernel_blocks(self) -> Dict[str, Tuple[int, int]]:
        """Fastest-measured ``(block_q, block_n)`` per kernel wrapper
        (empty for heuristic/roofline — the wrappers keep their defaults)."""
        if self.source != "measured":
            return {}
        out: Dict[str, Tuple[int, int]] = {}
        for name, spec in self.artifact.terms.get("kernel_blocks",
                                                  {}).items():
            out[name] = (int(spec["block_q"]), int(spec["block_n"]))
        return out

    def scheduler_defaults(self) -> Optional[Dict[str, object]]:
        """Measured continuous-batching defaults (``max_batch`` at the knee
        of the service-time curve, ``max_wait_ms`` sized to one service
        interval, adaptive refinement on) — None for heuristic/roofline, so
        ``SchedulerConfig()`` stays the stock hand-set config."""
        if self.source != "measured":
            return None
        sched = self.artifact.terms.get("scheduler")
        if not sched:
            return None
        return {"max_batch": max(1, int(sched["max_batch"])),
                "max_wait_ms": float(sched["max_wait_ms"]),
                "adaptive": True}

    # ----------------------------------------------------------- maintenance
    def compact_ns(self, n: int, dim: int = 64) -> float:
        """Predicted ns of one store compaction over ``n`` rows: slide the
        fp32 rows and code slabs in host RAM (~row bytes moved twice) plus
        the device re-upload of the compacted rows."""
        return 3.0 * self.scan_ns(n, "fp32", dim)

    def repartition_ns(self, n: int, dim: int = 64,
                       n_iters: int = 10) -> float:
        """Predicted ns of one IVF repartition over ``n`` rows: ``n_iters``
        Lloyd sweeps over the training sample plus one full re-assignment —
        every stage streams the fp32 rows, so it prices as scans."""
        return (n_iters + 2.0) * self.scan_ns(n, "fp32", dim)

    def pg_repair_ns(self, n: int, damaged: int, ef: int = 32,
                     dim: int = 64) -> float:
        """Predicted ns of one PG repair pass: an O(n) adjacency audit plus
        one beam search (~``ef`` gathers) per damaged node re-link."""
        return self.scan_ns(n, "fp32", dim) + damaged * self.gather_ns(ef, dim)

    # ---------------------------------------------------------- observability
    def estimate_batch_ns(self, groups: Sequence[Tuple[str, str, int, int]],
                          n: int, k: int, rescore_k: Optional[int],
                          dim: int) -> int:
        """Predicted ANN ns for one planned batch — the predicted-vs-actual
        term ``BatchAccounting`` surfaces. ``groups`` rows are
        ``(plan, precision, scope_size, n_requests)``; scan groups share one
        launch per precision (mirroring the real launch structure), gather
        groups cost one launch each. Heuristic models predict 0 (they have
        no cost terms — the observability contract is 'no number' rather
        than a made-up one)."""
        if self.source == "heuristic":
            return 0
        total = 0.0
        scan_precs: List[str] = []
        for plan, prec, size, n_req in groups:
            if plan == "empty":
                continue
            r = resolve_rescore_k(k, rescore_k, max(size, 1))
            if plan == "gather":
                total += self.gather_ns(size, dim)
                if prec in ("int8", "pq"):
                    total += self.rescore_ns(r, dim)
            elif prec not in scan_precs:
                scan_precs.append(prec)
                total += self.scan_ns(n, prec, dim)
                if prec in ("int8", "pq"):
                    total += self.rescore_ns(
                        resolve_rescore_k(k, rescore_k, n), dim)
        return int(total)


HEURISTIC = CostModel("heuristic")


def model_of(store) -> CostModel:
    """THE accessor every decision site uses: the store's attached model, or
    the heuristic singleton — one source of truth per database, which is what
    keeps flat/batch/sharded decisions bit-identical."""
    model = getattr(store, "cost_model", None)
    return model if model is not None else HEURISTIC


def resolve_calibration(calibration=None, device=None) -> CostModel:
    """Normalize every way a caller can name a calibration into a CostModel:

    * ``None``  — read the :data:`ENV_CALIBRATION` env var (a path); absent
      or empty means heuristic. This is how CI runs the whole tier-1 suite
      under a freshly generated artifact without touching every test.
    * ``False`` — explicitly pin the heuristic model (ignores the env var;
      tests asserting hand-set planner internals use this).
    * a path / dict / :class:`CalibrationArtifact` — load + backend-match.
    * a :class:`CostModel` — passed through.

    ``device`` is the database's torch device: an artifact is ``measured``
    only when it was calibrated on that device's backend.
    """
    if calibration is False:
        return HEURISTIC
    if calibration is None:
        path = os.environ.get(ENV_CALIBRATION, "")
        if not path:
            return HEURISTIC
        calibration = path
    if isinstance(calibration, CostModel):
        return calibration
    if isinstance(calibration, CalibrationArtifact):
        return CostModel.from_artifact(calibration, device=device)
    if isinstance(calibration, dict):
        return CostModel.from_artifact(CalibrationArtifact(calibration),
                                       device=device)
    return CostModel.from_artifact(
        CalibrationArtifact.load(os.fspath(calibration)), device=device)


def install_kernel_tuning(model: CostModel) -> None:
    """Push a measured model's fastest block shapes into the kernel wrapper
    registry (``repro_torch.kernels.ops``). Kernel tiling is a pure performance knob —
    results are block-shape independent — so a process-global registry is
    correct; the last measured artifact installed wins."""
    from ..kernels import ops
    ops.set_block_overrides(model.kernel_blocks())


__all__ = ["SCHEMA_VERSION", "ENV_CALIBRATION", "GATHER_THRESHOLD",
           "THRESHOLD_BOUNDS", "NPROBE_FLOOR", "TUNABLE_KERNELS",
           "CalibrationArtifact", "CostModel", "HEURISTIC", "model_of",
           "resolve_calibration", "install_kernel_tuning"]
