"""Roofline accounting of an (arch x shape) cell on NVIDIA H100 cards (the
port of ``repro/analysis/roofline.py``).

Three terms per cell, from the H100 SXM data sheet:

    compute    = FLOPs      / (chips x 989e12 FLOP/s dense bf16)
    memory     = HBM bytes  / (chips x 3.35e12 B/s)
    collective = link bytes / (450e9 B/s NVLink, one direction)

The reference reads FLOPs and bytes from XLA's cost analysis of a compiled
step and collective bytes from its HLO text (``cost_summary``,
``parse_collectives``); the port compiles nothing, so both have no
counterpart here. In their place :func:`step_cost` counts the work of one
step from the model's schema, the same whatever implements it. The
accounting functions (:class:`RooflineTerms`, :func:`terms_from`,
:func:`extrapolate`, :func:`model_flops_estimate`,
:func:`hbm_bytes_analytic`) are the reference's, logic unchanged, over the
port's copies of ``ArchConfig`` and ``ShapeSpec``, so they give the
reference's numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

# NVIDIA H100 SXM5 data sheet (dense, no sparsity): tensor-core bf16
# FLOP/s, non-tensor fp32 FLOP/s, tensor-core int8 OP/s, HBM3 bytes/s,
# and NVLink 4's 900 GB/s halved to one direction
PEAK_FLOPS = 989e12        # bf16 per card
PEAK_FLOPS_FP32 = 67e12
PEAK_OPS_INT8 = 1979e12
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # bytes/s per card, one direction


def extrapolate(l1: Dict[str, float], l2: Dict[str, float],
                n_layers: int, keys=("flops", "bytes", "link_bytes")
                ) -> Dict[str, float]:
    """total(L) = L1 + (L-1) * (L2 - L1), per metric."""
    out = {}
    for k in keys:
        a, b = l1.get(k, 0.0), l2.get(k, 0.0)
        delta = max(b - a, 0.0)
        out[k] = a + (n_layers - 1) * delta
        out[f"per_layer_{k}"] = delta
    return out


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    model_flops: float = 0.0
    hlo_flops: float = 0.0
    hlo_memory_s: float = 0.0   # the reference's unfused-HLO upper bound

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 = perfectly compute-bound."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0


def terms_from(metrics: Dict[str, float], chips: int,
               model_flops: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        compute_s=metrics.get("flops", 0.0) / (chips * PEAK_FLOPS),
        memory_s=metrics.get("bytes", 0.0) / (chips * HBM_BW),
        collective_s=metrics.get("link_bytes", 0.0) / LINK_BW,
        chips=chips,
        model_flops=model_flops,
        hlo_flops=metrics.get("flops", 0.0),
    )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference), N = active params."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def hbm_bytes_analytic(cfg, shape) -> float:
    """Analytic *global* HBM traffic per step, the reference's closed form
    (its comments name TPU fusion; the formula holds for any device that
    fuses the element-wise work around each product).

    train:   params 2B read + grads 2B written + 2 moments f32 read+write
             + params f32-ish write  (global = N * 22B)
             + per-layer activation streams (~12 D-wide read/writes per token,
             x2 for the remat recompute) + logits f32 read+write
    prefill: params read once + ~8 D-wide streams per token per layer
             + KV cache write
    decode:  params read + full KV cache read + small vectors

    ``cfg.param_count()`` counts the final norm twice, as the reference's
    does, so this equals the reference's number.
    """
    N = cfg.param_count()
    D = cfg.d_model
    L = cfg.n_layers + cfg.encoder_layers
    B = shape.global_batch
    S = shape.seq_len
    kvb = 2 * cfg.kv_heads * cfg.hd * 2          # k+v bytes/token/layer (bf16)
    if shape.kind == "train":
        tokens = B * S
        act = tokens * D * 2 * 12 * L * 2        # streams x remat recompute
        logits = 2 * tokens * cfg.vocab_size * 4
        return N * 22.0 + act + logits
    if shape.kind == "prefill":
        tokens = B * S
        act = tokens * D * 2 * 8 * L
        kv = tokens * kvb * cfg.n_layers
        return N * 2.0 + act + kv
    # decode: one token/seq; attention layers read the whole cache
    cache_read = B * S * kvb * cfg.n_layers if not cfg.attn_free else 0
    ssm_state = 0
    if cfg.attn_free or cfg.hybrid:
        d_in = cfg.ssm_expand * D
        ssm_state = 2 * B * cfg.n_layers * (d_in // max(cfg.ssm_head_dim, 1)
                                            * cfg.ssm_head_dim * cfg.ssm_state
                                            ) * 4
    return N * 2.0 + cache_read + ssm_state + B * D * 2 * 8 * L


def _leaf_macs(spec) -> float:
    """Multiply-adds per token of one per-layer leaf: the product of its
    dims for a matrix, a head-split projection or a depthwise filter; 0
    for vectors (norms, biases, scalars)."""
    if len(spec.shape) < 2:
        return 0.0
    return float(math.prod(spec.shape))


def _layer_macs(schema, cfg, skip=()) -> float:
    """Multiply-adds per token of one layer's projection leaves (routed
    experts: ``top_k`` of ``E``); sub-trees named in ``skip`` are left
    out."""
    total = 0.0
    for key, sub in schema.items():
        if key in skip:
            continue
        if isinstance(sub, dict):
            total += _layer_macs(sub, cfg)
        elif sub.logical[:1] == ("experts",):
            total += _leaf_macs(sub) * cfg.moe_top_k / cfg.n_experts
        else:
            total += _leaf_macs(sub)
    return total


def _causal_pairs(q: int, ctx: int, window: int) -> float:
    """(query, key) pairs of the ``q`` queries at the last positions of a
    ``ctx``-long causal context: position i sees i + 1 keys, at most
    ``window`` of them (0 = no limit)."""
    def tri(n: int) -> float:              # sum of (i + 1) over i < n
        return n * (n + 1) / 2.0
    first = ctx - q
    if not window:
        return tri(ctx) - tri(first)
    m = min(max(window, first), ctx)       # positions from m on see window
    return tri(m) - tri(first) + (ctx - m) * window


def step_cost(cfg, shape) -> Dict[str, float]:
    """FLOPs, HBM bytes and link bytes of one step of ``cfg`` at ``shape``,
    counted from the schema (no compiler, no device).

    FLOPs = mult x (2 T_tok P + 2 T_head D V + attention), with mult = 3
    for ``train`` (forward and the two backward products), 1 otherwise;
    T_tok = B S tokens (train, prefill) or B (decode) through every
    decoder layer's projection leaves, whose per-token multiply-adds P sum
    the product of each matrix leaf's dims (attention, MLP, router, shared
    and routed experts at ``top_k / E``, the SSM's in / out projections and
    depthwise filter); T_head = B S (train) or B (prefill and decode, which
    take logits at the last position) through the LM head. The encoder of
    an encoder-decoder model runs B x ``encoder_seq`` frames through its
    layers, and the decoder's cross-attention keys and values are
    projected from those frames, in train and prefill only (decode reads
    them from the cache). Attention = 4 B H hd x (query, key) pairs per
    attention layer: causal over the context S + ``meta_tokens`` (global
    layers) or at most the window (local layers); decode's one query sees
    the whole context; cross-attention and the encoder's own attention
    see all ``encoder_seq`` frames. The SSD scan's state products are not
    counted (under 1% of the projections at these shapes).

    Bytes are :func:`hbm_bytes_analytic`; link bytes are 0 on one card.
    """
    from ..models.transformer import encoder_layer_schema, layer_schema

    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    tok = B * (S if shape.kind != "decode" else 1)
    head_tok = B * S if train else B
    lay = layer_schema(cfg)
    flops = 2.0 * tok * cfg.n_layers * _layer_macs(lay, cfg, skip=("xattn",))
    flops += 2.0 * head_tok * cfg.d_model * cfg.vocab_size
    H, hd = cfg.n_heads, cfg.hd
    if not cfg.attn_free:
        ctx = S + cfg.meta_tokens
        q = ctx if shape.kind != "decode" else 1
        for w in cfg.layer_windows():
            flops += 4.0 * B * H * hd * _causal_pairs(q, ctx, int(w))
    if cfg.is_encdec:
        xa = lay["xattn"]
        frames = B * cfg.encoder_seq
        q_side = _leaf_macs(xa["wq"]) + _leaf_macs(xa["wo"])
        kv_side = _leaf_macs(xa["wk"]) + _leaf_macs(xa["wv"])
        flops += 2.0 * tok * cfg.n_layers * q_side
        flops += 4.0 * tok * H * hd * cfg.encoder_seq * cfg.n_layers
        if shape.kind != "decode":
            flops += 2.0 * frames * cfg.n_layers * kv_side
            flops += cfg.encoder_layers * (
                2.0 * frames * _layer_macs(encoder_layer_schema(cfg), cfg)
                + 4.0 * B * H * hd * cfg.encoder_seq * cfg.encoder_seq)
    if train:
        flops *= 3.0
    return {"flops": flops, "bytes": float(hbm_bytes_analytic(cfg, shape)),
            "link_bytes": 0.0}


__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_FP32", "PEAK_OPS_INT8", "HBM_BW",
           "LINK_BW", "RooflineTerms", "terms_from", "extrapolate",
           "model_flops_estimate", "hbm_bytes_analytic", "step_cost"]
