"""Peaks of the card and the work a DSQ batch needs: the yardstick of every
roofline share the benchmark reports.

Peaks are NVIDIA's H100 SXM data-sheet figures (dense, no sparsity): fp32
outside the tensor cores (the configurations promise exact fp32 ranking,
so TF32 is not a peak they may use), int8 on the tensor cores, and HBM3.

The work counts come from the reference's scope sets, never from the
kernels that ran, so a later kernel that changes how a batch is ranked is
held to the same bound:

* operations: 2 d per admitted (query, row) pair, at the precision the plan
  scans; the int8 plan scans only scopes wider than its rescore window (a
  narrower scope is ranked exactly in fp32) and adds 2 d fp32 FLOPs per
  rescored candidate;
* bytes: every row of the union of the scanned scopes read once at the
  scanned precision (fp32: 4 d; int8: d codes plus a 4-byte scale), the
  rescored fp32 rows, the queries, and k (score, id) pairs of 8 bytes per
  request written back.

The bound is the largest of the three times (fp32 operations, int8
operations, bytes), each a lower bound on the batch's device time.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAKS = {"hbm_bytes_s": 3.35e12, "fp32_flops": 67e12, "int8_ops": 1979e12}


def batch_work(precision: str, dim: int, k: int, window: int,
               scope_rows: Sequence[int], union_rows: int) -> Dict[str, float]:
    """Operations and bytes a batch needs. ``scope_rows`` is each request's
    scope size; ``union_rows`` the size of the union of the scanned scopes
    (for int8: of those wider than ``window``)."""
    B = len(scope_rows)
    out_bytes = 8.0 * k * B
    if precision == "fp32":
        return {"fp32_flops": 2.0 * dim * float(sum(scope_rows)), "int8_ops": 0.0,
                "bytes": 4.0 * dim * union_rows + 4.0 * dim * B + out_bytes}
    rescored = float(sum(min(window, m) for m in scope_rows))
    scanned = float(sum(m for m in scope_rows if m > window))
    return {"fp32_flops": 2.0 * dim * rescored,
            "int8_ops": 2.0 * dim * scanned,
            "bytes": ((dim + 4.0) * union_rows + 4.0 * dim * rescored
                      + (5.0 * dim + 4.0) * B + out_bytes)}


def bound_s(work: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The least time the card could take for ``work``."""
    return max(work["fp32_flops"] / peaks["fp32_flops"],
               work["int8_ops"] / peaks["int8_ops"],
               work["bytes"] / peaks["hbm_bytes_s"])
