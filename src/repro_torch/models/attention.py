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
function. With ``layer_group > 1`` the local layers take the static-band
variants (:func:`local_attention`, :func:`chunked_attention`), which issue
only the in-band work, over whichever attention the caller names.

Training differentiates through :func:`flash_attention`, a
``torch.autograd.Function`` carrying the reference's custom VJP
(``repro/models/attention.py:171-258``): a blocked forward with an online
softmax that saves the fp32 output and each row's running max and sum, and
a backward that recomputes ``p`` block by block from them, so neither pass
holds more than one (block_q, block_k) tile of scores per head. Or through
:func:`naive_attention` (``cfg.attn_impl == "naive"``), plain autograd over
the whole score matrix. :func:`attention` (prefill) stays as it is: it works
in place and carries no gradient. No TPU kernel lies on the training path:
the reference's flash attention is lax, not Pallas.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


# ------------------------------------------------------------- training path


def _grouped(q: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, KV, G, S, hd)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)


def _ungrouped(o: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, S, hd) -> (B, S, KV * G, hd)."""
    B, KV, G, S, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, KV * G, hd)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Unblocked attention (materializes the (Sq, Skv) scores), plain
    autograd: fp32 scores, a softmax, ``p`` rounded to v's type for the PV
    product (``repro/models/attention.py::naive_attention``)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dev = q.device
    valid = _local_mask(q_offset + torch.arange(Sq, device=dev),
                        torch.arange(Skv, device=dev), causal, int(window),
                        int(chunk))
    s = _grouped(q, KV).float() @ k.permute(0, 2, 3, 1).float()[:, :, None]
    s = (s * (1.0 / np.sqrt(hd))).masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~valid, 0.0)
    out = p.to(v.dtype).float() @ v.permute(0, 2, 1, 3).float()[:, :, None]
    return _ungrouped(out).to(q.dtype)


def _spans(n: int, block: int) -> List[Tuple[int, int]]:
    return [(i, min(i + block, n)) for i in range(0, n, block)]


class _FlashAttention(torch.autograd.Function):
    """``_flash_core`` with its custom VJP (``_flash_fwd`` / ``_flash_bwd``).
    Tiles are (B, KV, G * bq, ...) so that a GQA group's queries share one
    product with their key block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset, block_q,
                block_k):
        B, Sq, H, hd = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        G = H // KV
        scale = 1.0 / np.sqrt(hd)
        dev = q.device
        qg = _grouped(q, KV)                          # (B, KV, G, Sq, hd)
        kt = k.permute(0, 2, 3, 1)                    # (B, KV, hd, Skv)
        vt = v.permute(0, 2, 1, 3)                    # (B, KV, Skv, hd)
        out = torch.empty(B, KV, G, Sq, hd, dtype=torch.float32, device=dev)
        m = torch.empty(B, KV, G, Sq, dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        for q0, q1 in _spans(Sq, block_q):
            bq = q1 - q0
            qb = qg[:, :, :, q0:q1].float().reshape(B, KV, G * bq, hd)
            q_pos = q_offset + torch.arange(q0, q1, device=dev)
            m_i = torch.full((B, KV, G, bq), NEG_INF, device=dev)
            l_i = torch.zeros(B, KV, G, bq, device=dev)
            acc = torch.zeros(B, KV, G, bq, hd, device=dev)
            for k0, k1 in _spans(Skv, block_k):
                invalid = ~_local_mask(q_pos, torch.arange(k0, k1, device=dev),
                                       causal, window, chunk)
                s = (qb @ kt[..., k0:k1].float()).view(B, KV, G, bq, k1 - k0)
                s = (s * scale).masked_fill(invalid, NEG_INF)
                m_new = torch.maximum(m_i, s.amax(dim=-1))
                alpha = torch.exp(m_i - m_new)
                p = torch.exp(s - m_new[..., None]).masked_fill(invalid, 0.0)
                l_i = l_i * alpha + p.sum(dim=-1)
                pv = (p.to(v.dtype).float().view(B, KV, G * bq, k1 - k0)
                      @ vt[:, :, k0:k1].float()).view(B, KV, G, bq, hd)
                acc = acc * alpha[..., None] + pv
                m_i = m_new
            out[:, :, :, q0:q1] = acc / l_i.clamp_min(1e-30)[..., None]
            m[..., q0:q1] = m_i
            l[..., q0:q1] = l_i
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, chunk, q_offset, block_q, block_k)
        return _ungrouped(out).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        """Block recompute of ``p`` from the saved max and sum; dq
        accumulates over key blocks in order and dk / dv over query blocks
        in order, as the reference's two passes do."""
        q, k, v, out, m, l = ctx.saved_tensors
        causal, window, chunk, q_offset, block_q, block_k = ctx.args
        B, Sq, H, hd = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        G = H // KV
        scale = 1.0 / np.sqrt(hd)
        dev = q.device
        do = _grouped(dout, KV).float()               # (B, KV, G, Sq, hd)
        l_safe = l.clamp_min(1e-30)
        D = (do * out).sum(dim=-1)                    # (B, KV, G, Sq)
        qg = _grouped(q, KV)
        kt = k.permute(0, 2, 1, 3)                    # (B, KV, Skv, hd)
        vt = v.permute(0, 2, 1, 3)
        dq = torch.zeros(B, KV, G, Sq, hd, device=dev)
        dk = torch.zeros(B, KV, Skv, hd, device=dev)
        dv = torch.zeros(B, KV, Skv, hd, device=dev)
        for q0, q1 in _spans(Sq, block_q):
            bq = q1 - q0
            qb = qg[:, :, :, q0:q1].float().reshape(B, KV, G * bq, hd)
            dob = do[:, :, :, q0:q1].reshape(B, KV, G * bq, hd)
            q_pos = q_offset + torch.arange(q0, q1, device=dev)
            m_b = m[..., q0:q1, None]
            l_b = l_safe[..., q0:q1, None]
            D_b = D[..., q0:q1, None]
            dq_b = torch.zeros(B, KV, G * bq, hd, device=dev)
            for k0, k1 in _spans(Skv, block_k):
                bk = k1 - k0
                invalid = ~_local_mask(q_pos, torch.arange(k0, k1, device=dev),
                                       causal, window, chunk)
                kb = kt[:, :, k0:k1].float()
                vb = vt[:, :, k0:k1].float()
                s = (qb @ kb.transpose(-1, -2)).view(B, KV, G, bq, bk) * scale
                p = (torch.exp(s.masked_fill(invalid, NEG_INF) - m_b) / l_b
                     ).masked_fill(invalid, 0.0)
                dp = (dob @ vb.transpose(-1, -2)).view(B, KV, G, bq, bk)
                ds = (p * (dp - D_b) * scale).view(B, KV, G * bq, bk)
                p = p.view(B, KV, G * bq, bk)
                dv[:, :, k0:k1] += p.transpose(-1, -2) @ dob
                dq_b += ds @ kb
                dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qb
            dq[:, :, :, q0:q1] = dq_b.view(B, KV, G, bq, hd)
        return (_ungrouped(dq).to(q.dtype),
                dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype),
                None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    q_offset: int = 0, block_q: int = 1024,
                    block_k: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    type, differentiable in q, k and v (``repro/models/attention.py::
    flash_attention``). The last block of either axis may be short: no
    padding, so no padded-key mask."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 int(chunk), int(q_offset),
                                 max(1, min(block_q, q.shape[1])),
                                 max(1, min(block_k, k.shape[1])))


# ------------------------------------------------ static-local band variants


def attend(impl: str, q, k, v, **kw) -> torch.Tensor:
    """Attention by name: ``"flash"`` / ``"naive"`` (the training paths,
    as the reference's ``attention(impl=...)`` names them; ``block_q`` /
    ``block_k`` go to flash only) or ``"prefill"`` (:func:`attention`,
    serving without autograd)."""
    fns = {"flash": flash_attention, "naive": naive_attention,
           "prefill": attention}
    if impl not in fns:
        raise ValueError(f"impl {impl!r}: flash | naive | prefill")
    if impl != "flash":
        kw.pop("block_q", None)
        kw.pop("block_k", None)
    return fns[impl](q, k, v, **kw)


def _pad_seq(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad dim 1 up to a multiple of ``mult``."""
    pad = (-x.shape[1]) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                      dim=1)
    return x


def local_attention(q, k, v, *, window: int, impl: str = "flash",
                    **kw) -> torch.Tensor:
    """Sliding-window attention with a static window
    (``repro/models/attention.py:309``): query band i attends key bands
    i-1 and i (2w keys) with the window mask, so O(S 2w) work instead of
    O(S^2). Bands fold into the batch; band 0 runs as plain causal
    attention."""
    B, S, H, hd = q.shape
    w = int(window)
    if S <= w:
        return attend(impl, q, k, v, causal=True, window=0, chunk=0, **kw)
    q2, k2, v2 = _pad_seq(q, w), _pad_seq(k, w), _pad_seq(v, w)
    nb = q2.shape[1] // w
    KVh = k.shape[2]
    qb = q2.reshape(B, nb, w, H, hd)
    kb = k2.reshape(B, nb, w, KVh, hd)
    vb = v2.reshape(B, nb, w, KVh, hd)
    out0 = attend(impl, qb[:, 0], kb[:, 0], vb[:, 0], causal=True, window=0,
                chunk=0, **kw)
    q1 = qb[:, 1:].reshape(B * (nb - 1), w, H, hd)
    kcat = torch.cat([kb[:, :-1], kb[:, 1:]], dim=2).reshape(
        B * (nb - 1), 2 * w, KVh, hd)
    vcat = torch.cat([vb[:, :-1], vb[:, 1:]], dim=2).reshape(
        B * (nb - 1), 2 * w, KVh, hd)
    out1 = attend(impl, q1, kcat, vcat, causal=True, window=w, q_offset=w,
                **kw)
    out = torch.cat([out0[:, None], out1.reshape(B, nb - 1, w, H, hd)],
                    dim=1).reshape(B, nb * w, H, hd)
    return out[:, :S]


def chunked_attention(q, k, v, *, chunk: int, impl: str = "flash",
                      **kw) -> torch.Tensor:
    """Chunked local attention (llama4's local layers) with a static chunk
    (``repro/models/attention.py:343``): block-diagonal causal attention,
    O(S c) instead of O(S^2)."""
    B, S, H, hd = q.shape
    c = int(chunk)
    if S <= c:
        return attend(impl, q, k, v, causal=True, window=0, chunk=0, **kw)
    q2, k2, v2 = _pad_seq(q, c), _pad_seq(k, c), _pad_seq(v, c)
    nc = q2.shape[1] // c
    KVh = k.shape[2]
    out = attend(impl, q2.reshape(B * nc, c, H, hd),
               k2.reshape(B * nc, c, KVh, hd),
               v2.reshape(B * nc, c, KVh, hd),
               causal=True, window=0, chunk=0, **kw)
    return out.reshape(B, nc * c, H, hd)[:, :S]


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
