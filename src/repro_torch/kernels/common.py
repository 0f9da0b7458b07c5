"""Tensor helpers shared by the main path and the plain versions.

Neither is a kernel or a kernel's plain version: the flat executor's scan
plan unpacks a scope's packed words into the dense mask ``scoped_topk``
takes, and the store computes the squared row norms the l2 score reads,
on whatever device the database lives.
"""
from __future__ import annotations

import torch


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32-viewed packed words -> (..., n) bool. Bit j of word w
    selects row 32w+j (little-endian, like ``RoaringBitmap.to_words``);
    ``(w >> j) & 1`` is right under the arithmetic shift of int32."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., :, None] >> shifts) & 1
    return (bits.reshape(*words.shape[:-1], -1) != 0)[..., :n]


def row_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """(n,) fp32 squared row norms: the ``||x||^2`` term of the l2 score."""
    rows = rows.float()
    return (rows * rows).sum(dim=1)
