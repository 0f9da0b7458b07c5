"""Rescore-window rule of the quantized tiers (numpy, copied from
``repro.vectordb.quant``).

The fp32 path only needs the window rule, which the planner's precision
choice reads. The int8 scalar quantizer (``quantize_rows``,
``int_exact_dot``) and the PQ codebook arrive with the int8/PQ slice.
"""
from __future__ import annotations

from typing import Optional

# int8 scan phase keeps this many candidates per query (times k) before the
# exact fp32 rescore, unless the caller passes an explicit ``rescore_k``
DEFAULT_RESCORE_FACTOR = 4


def resolve_rescore_k(k: int, rescore_k: Optional[int], n: int) -> int:
    """Effective int8-phase candidate count: the caller's ``rescore_k``
    (defaulting to ``DEFAULT_RESCORE_FACTOR * k``), at least ``k``, at most
    the ``n`` rows that exist."""
    r = DEFAULT_RESCORE_FACTOR * k if rescore_k is None else int(rescore_k)
    return max(1, min(max(r, k), n)) if n > 0 else max(k, 1)
