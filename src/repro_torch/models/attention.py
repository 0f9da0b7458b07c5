"""GQA attention: the prefill path in plain PyTorch and the cache decode path
through kernel 10 (the port of ``repro/models/attention.py``).

Prefill computes what the reference's ``flash_attention`` computes (causal,
sliding window, chunk and ``q_offset`` masks), the way its one-block case
does it: fp32 scores, the row max, ``p = exp(s - m)`` rounded to v's type
for the PV product, then division by the fp32 row sum. The reference does
this part in lax, not in Pallas, so the port keeps it in PyTorch.

Decode builds the reference's per-position validity (cache length, window,
chunk; ``attention.py:382-390``) as a ``(B, S)`` mask and calls
``kernels.ops.flash_decode``: the hand-written kernel on a card, its plain
version on the CPU. The reference's ``decode_attention`` is a plain einsum
and never reaches its Pallas ``flash_decode``; both compute the same
function. The static-band variants (``local_attention``,
``chunked_attention``, only with ``layer_group > 1``) wait for the hybrid
configs (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels import ops
from .layers import Spec, apply_rope, rms_norm

NEG_INF = float(np.finfo(np.float32).min)
#: bytes of fp32 scores one prefill pass may hold; larger batches are cut
SCORE_BYTES = 2 << 30


def attn_schema(cfg) -> Dict[str, Spec]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    s: Dict[str, Spec] = {
        "wq": Spec((D, H, hd), ("embed_fsdp", "heads", "head_dim")),
        "wk": Spec((D, KV, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wv": Spec((D, KV, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wo": Spec((H, hd, D), ("heads", "head_dim", "embed_fsdp")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((H, hd), ("heads", "head_dim"), "zeros")
        s["bk"] = Spec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = Spec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = Spec((hd,), (None,), "ones")
        s["k_norm"] = Spec((hd,), (None,), "ones")
    return s


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def qkv_project(p, x: torch.Tensor, cfg, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), RoPE applied."""
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("b...hk,hkd->b...d") as one matmul."""
    H, hd, D = wo.shape
    return attn.reshape(*attn.shape[:-2], H * hd) @ wo.reshape(H * hd, D)


def _local_mask(qi: torch.Tensor, kj: torch.Tensor, causal: bool,
                window: int, chunk: int) -> torch.Tensor:
    """(q, k) validity from absolute indices."""
    qi_, kj_ = qi[:, None], kj[None, :]
    m = torch.ones(qi.shape[0], kj.shape[0], dtype=torch.bool,
                   device=qi.device)
    if causal:
        m &= kj_ <= qi_
    if window > 0:
        m &= (qi_ - kj_) < window
    if chunk > 0:
        m &= torch.div(qi_, chunk, rounding_mode="floor") == torch.div(
            kj_, chunk, rounding_mode="floor")
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, chunk: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's type.
    The batch is cut so one pass holds at most :data:`SCORE_BYTES` of fp32
    scores."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    valid = _local_mask(q_offset + torch.arange(Sq, device=dev),
                        torch.arange(Skv, device=dev), causal, int(window),
                        int(chunk))
    invalid = ~valid
    step = max(1, SCORE_BYTES // max(1, H * Sq * Skv * 4))
    out = torch.empty_like(q)
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        qg = q[sl].reshape(-1, Sq, KV, G, hd).permute(0, 2, 3, 1, 4).float()
        kt = k[sl].permute(0, 2, 3, 1).float()[:, :, None]  # (b,KV,1,hd,Skv)
        s = torch.matmul(qg, kt).mul_(scale)                # (b,KV,G,Sq,Skv)
        s.masked_fill_(invalid, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_().masked_fill_(invalid, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype != torch.float32:
            p = p.to(v.dtype).float()
        vt = v[sl].permute(0, 2, 1, 3).float()[:, :, None]  # (b,KV,1,Skv,hd)
        o = torch.matmul(p, vt).div_(l.clamp_min_(1e-30))   # (b,KV,G,Sq,hd)
        out[sl] = o.permute(0, 3, 1, 2, 4).reshape(-1, Sq, H, hd).to(q.dtype)
    return out


# --------------------------------------------------------------- decode path


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0, chunk: int = 0) -> torch.Tensor:
    """One-token attention against a static cache: q (B, H, hd); caches
    (B, KV, S, hd); cache_len (B,) = valid positions (the new token sits at
    cache_len - 1). Position j is admitted when j < cache_len, and within
    ``window`` / the same ``chunk`` as the new token where the layer has
    them. Kernel 10 on a card, its plain version on the CPU."""
    pos = torch.arange(k_cache.shape[2], device=cache_len.device)[None, :]
    qpos = (cache_len - 1)[:, None]
    valid = pos < cache_len[:, None]
    if window > 0:
        valid &= (qpos - pos) < window
    if chunk > 0:
        valid &= torch.div(qpos, chunk, rounding_mode="floor") == torch.div(
            pos, chunk, rounding_mode="floor")
    return ops.flash_decode(q, k_cache, v_cache, valid.to(torch.int8))
