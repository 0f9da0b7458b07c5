"""Symmetric int8 scalar quantization — the device tier's compact row format.

The quantized tier trades exactness for bytes exactly the way production
VDBMSs ship it (SQ-8 in the Pan et al. / Ma et al. survey taxonomies): each
row is stored as int8 codes plus ONE fp32 scale, so the device store shrinks
~4x (``dim + 4`` bytes per row vs ``4 * dim``) and the scan reads a quarter
of the HBM bytes. Scoring is *asymmetric-free*: queries are quantized with
their own per-row scale, the MXU/ALU accumulates the int8 dot in int32, and
the two scales multiply back in at merge time:

    score(q, x)  ≈  dot_i32(q_i8, x_i8) * q_scale * x_scale

which is EXACT for the quantized operands (int32 accumulation never rounds
for d * 127^2 << 2^31), so the only error is the per-component rounding of
the codes themselves. The two-phase execution plan (int8 scan selects
``rescore_k >= k`` candidates, exact fp32 gather-rescore ranks the final
top-k) then erases that error for every candidate the scan surfaces — the
recall contract of ``benchmarks/bench_quantized.py``.

Copied from ``repro.vectordb.quant`` with no logic changed, so both packages
produce the same codes, codebooks and LUTs. The reference's
``int_exact_dot`` (a JAX primitive) has no copy here: the int8 scores come
from the ``scoped_topk_i8`` kernels and their plain versions in
``kernels/ref.py``.

Convention: all-zero rows quantize to scale 1.0 / all-zero codes so
dequantization is total (no divide-by-zero, no NaN scores).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# int8 scan phase keeps this many candidates per query (times k) before the
# exact fp32 rescore, unless the caller passes an explicit ``rescore_k``
DEFAULT_RESCORE_FACTOR = 4

Q_MAX = 127


def quantize_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization.

    Returns ``(codes (n, d) int8, scales (n,) float32)`` with
    ``scale = max|row| / 127`` (1.0 for all-zero rows) and
    ``codes = round(row / scale)`` clipped to ``[-127, 127]``.
    """
    rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
    amax = np.max(np.abs(rows), axis=1)
    scales = np.where(amax > 0.0, amax / Q_MAX, 1.0).astype(np.float32)
    codes = np.clip(np.rint(rows / scales[:, None]), -Q_MAX, Q_MAX)
    return codes.astype(np.int8), scales


def dequantize_rows(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_rows`: ``codes * scale`` per row, fp32."""
    return codes.astype(np.float32) * np.asarray(
        scales, dtype=np.float32)[:, None]


def resolve_rescore_k(k: int, rescore_k: Optional[int], n: int) -> int:
    """Effective int8-phase candidate count: the caller's ``rescore_k``
    (defaulting to ``DEFAULT_RESCORE_FACTOR * k``), at least ``k``, at most
    the ``n`` rows that exist."""
    r = DEFAULT_RESCORE_FACTOR * k if rescore_k is None else int(rescore_k)
    return max(1, min(max(r, k), n)) if n > 0 else max(k, 1)


# -------------------------------------------------------------------- PQ/ADC
#
# Product quantization: split each row into M contiguous subvectors of
# dsub = dim / M components, k-means each subspace into 256 centroids, store
# one uint8 centroid index per subspace. A row costs M bytes instead of
# 4 * dim — 1/16 at the default dsub = 4 — which is what finally lets the
# device tier hold a corpus whose fp32 rows exceed the device byte budget.
#
# Scoring is asymmetric distance computation (ADC): the query is NOT
# quantized. Per query we build one (M, 256) lookup table of subvector
# scores against every centroid, and a row's approximate score is the sum
# of M table entries selected by its codes. The LUT folds the metric in so
# the scan itself is metric-free:
#
#   ip / cos :  lut[m, c] = q_m . C[m, c]          => sum = q . x_hat
#   l2       :  lut[m, c] = 2 q_m . C[m, c] - |C[m, c]|^2
#                                           => sum = 2 q . x_hat - |x_hat|^2
#
# matching the fp32 scan's "larger is better" l2 identity (2 q.x - |x|^2),
# so every executor ranks ADC scores the same way it ranks exact ones. As
# with int8, the ADC phase only *selects* rescore_k candidates; the exact
# fp32 gather-rescore ranks the final top-k.

PQ_N_CENTROIDS = 256
PQ_TRAIN_SAMPLE = 4096
PQ_TRAIN_ITERS = 10


def default_pq_m(dim: int) -> int:
    """Default subspace count: the largest divisor of ``dim`` that is at
    most ``dim // 4`` (dsub >= 4 => codes are <= 1/16 of fp32 bytes)."""
    target = max(1, dim // 4)
    for m in range(target, 0, -1):
        if dim % m == 0:
            return m
    return 1


class PQCodebook:
    """Per-subspace k-means codebook with frozen-after-training encode.

    The codebook trains ONCE on an ingest sample (deterministic given
    ``seed``), then incrementally encodes every later row with the frozen
    centroids — the same watermark pattern the int8 mirror uses — so codes
    for already-ingested rows never change under DSM or further ingest.
    """

    def __init__(self, dim: int, m: Optional[int] = None, seed: int = 0):
        m = default_pq_m(dim) if m is None else int(m)
        if m <= 0 or dim % m != 0:
            raise ValueError(f"pq m {m} must divide dim {dim}")
        self.dim = dim
        self.m = m
        self.dsub = dim // m
        self.seed = seed
        self.centroids: Optional[np.ndarray] = None  # (m, 256, dsub) f32

    @property
    def trained(self) -> bool:
        return self.centroids is not None

    def _require_trained(self) -> None:
        if self.centroids is None:
            raise ValueError(
                "PQ codebook not trained: the codebook trains on the rows "
                "present at first use, so precision='pq' (and pq_lut/encode/"
                "decode) needs a non-empty store first")

    def train(self, rows: np.ndarray) -> None:
        """Lloyd k-means per subspace on (a sample of) ``rows``; empty
        clusters keep their previous centroid (the IVF trainer's rule)."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        rng = np.random.default_rng(self.seed)
        n = len(rows)
        if n > PQ_TRAIN_SAMPLE:
            rows = rows[rng.choice(n, size=PQ_TRAIN_SAMPLE, replace=False)]
            n = PQ_TRAIN_SAMPLE
        k = PQ_N_CENTROIDS
        cents = np.empty((self.m, k, self.dsub), np.float32)
        for m in range(self.m):
            sub = rows[:, m * self.dsub:(m + 1) * self.dsub]
            init = rng.choice(n, size=k, replace=n < k)
            c = sub[init].copy()
            for _ in range(PQ_TRAIN_ITERS):
                assign = self._assign(sub, c)
                counts = np.bincount(assign, minlength=k).astype(np.float32)
                sums = np.zeros_like(c)
                np.add.at(sums, assign, sub)
                nonempty = counts > 0
                c[nonempty] = sums[nonempty] / counts[nonempty, None]
            cents[m] = c
        self.centroids = cents

    @staticmethod
    def _assign(sub: np.ndarray, cents: np.ndarray) -> np.ndarray:
        # argmin |x - c|^2 == argmin |c|^2 - 2 x.c  (drop the |x|^2 term)
        d2 = (cents * cents).sum(axis=1)[None, :] - 2.0 * (sub @ cents.T)
        return np.argmin(d2, axis=1)

    def encode(self, rows: np.ndarray) -> np.ndarray:
        """Nearest-centroid codes, ``(n, M) uint8``."""
        self._require_trained()
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        out = np.empty((len(rows), self.m), np.uint8)
        for m in range(self.m):
            sub = rows[:, m * self.dsub:(m + 1) * self.dsub]
            out[:, m] = self._assign(sub, self.centroids[m]).astype(np.uint8)
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Reconstruct ``(n, dim)`` fp32 rows from codes."""
        self._require_trained()
        codes = np.atleast_2d(np.asarray(codes))
        parts = [self.centroids[m][codes[:, m].astype(np.intp)]
                 for m in range(self.m)]
        return np.concatenate(parts, axis=1)

    def lut(self, queries: np.ndarray, metric: str) -> np.ndarray:
        """Per-query ADC tables, ``(nq, M, 256) float32`` (metric folded
        in — see the module docstring identity)."""
        self._require_trained()
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        sub_q = queries.reshape(len(queries), self.m, self.dsub)
        dots = np.einsum("qmd,mcd->qmc", sub_q, self.centroids,
                         dtype=np.float32)
        if metric == "l2":
            cent_sq = (self.centroids * self.centroids).sum(axis=2)
            return (2.0 * dots - cent_sq[None]).astype(np.float32)
        return dots.astype(np.float32)

    def nbytes(self) -> int:
        """Codebook bytes (O(1) model state, reported separately from the
        per-row code bytes)."""
        if self.centroids is None:
            return 0
        return int(self.centroids.nbytes)
