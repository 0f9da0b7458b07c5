"""Mamba-2 (SSD, state-space duality) mixer in plain PyTorch: the chunked
scan of prefill and training, and the one-token recurrent decode (the port
of ``repro/models/ssm.py``).

Within a chunk the output is the masked, attention-like form; across chunks
a recurrence carries a (H, hd, N) state per head, so decode holds constant
memory. The reference writes this in ``jnp`` / ``lax``, not in Pallas, so
no kernel of the port lies on this path; the einsums run in fp32, and the
port never lets them run in TF32 (``device.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Spec, rms_norm


def ssm_dims(cfg) -> Dict[str, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return dict(d_in=d_in, n_heads=n_heads, conv_dim=conv_dim,
                proj_out=2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state
                + n_heads)


def ssm_schema(cfg) -> Dict[str, Spec]:
    dims = ssm_dims(cfg)
    D = cfg.d_model
    return {
        "in_proj": Spec((D, dims["proj_out"]), ("embed_fsdp", "mlp")),
        "conv_w": Spec((dims["conv_dim"], cfg.ssm_conv), ("mlp", None),
                       "small", 0.5),
        "conv_b": Spec((dims["conv_dim"],), ("mlp",), "zeros"),
        "A_log": Spec((dims["n_heads"],), (None,), "ones"),
        "D_skip": Spec((dims["n_heads"],), (None,), "ones"),
        "dt_bias": Spec((dims["n_heads"],), (None,), "zeros"),
        "norm": Spec((dims["d_in"],), (None,), "ones"),
        "out_proj": Spec((dims["d_in"], D), ("mlp", "embed_fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x (B, L, C); w (C, K). Returns (y, new
    state), the state carrying the last K-1 inputs (B, C, K-1) for decode.
    The taps are summed in fp32 in order k = 0..K-1, as the reference's
    loop does."""
    B, L, C = x.shape
    K = w.shape[1]
    xt = x.transpose(1, 2)                                 # (B, C, L)
    pad = (torch.zeros(B, C, K - 1, dtype=x.dtype, device=x.device)
           if state is None else state)
    full = torch.cat([pad, xt], dim=-1)                    # (B, C, L+K-1)
    wf = w.float()
    y = torch.zeros(B, C, L, dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + full[:, :, k:k + L].float() * wf[:, k][None, :, None]
    y = y + b.float()[None, :, None]
    new_state = full[:, :, L:]                             # last K-1 inputs
    return F.silu(y).to(x.dtype).transpose(1, 2), new_state


def _split_proj(cfg, zxbcdt: torch.Tensor):
    dims = ssm_dims(cfg)
    d_in, gn = dims["d_in"], cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: d_in + d_in + 2 * gn]
    dt = zxbcdt[..., d_in + d_in + 2 * gn:]
    return z, xBC, dt


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan (``repro/models/ssm.py:75``).

    xh (B,L,H,hd) inputs per head; dt (B,L,H) positive step sizes;
    A (H,) negative decay rates; Bm, Cm (B,L,H,N) per head (group-expanded).
    Returns (y (B,L,H,hd) fp32, final state (B,H,hd,N) fp32). The
    inter-chunk ``lax.scan`` is a loop over chunks."""
    Bsz, L, H, hd = xh.shape
    N = Bm.shape[-1]
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"length {L} is not a multiple of chunk {chunk}")
    f32 = torch.float32
    dt = dt.float()
    xb = (xh.float() * dt[..., None]).reshape(Bsz, nc, chunk, H, hd)
    la = (dt * A.float()[None, None, :]).reshape(Bsz, nc, chunk, H)
    Bc = Bm.float().reshape(Bsz, nc, chunk, H, N)
    Cc = Cm.float().reshape(Bsz, nc, chunk, H, N)
    cs = torch.cumsum(la, dim=2)                           # (B,nc,Q,H)
    seg_total = cs[:, :, -1, :]                            # (B,nc,H)

    # intra-chunk (quadratic within the chunk): y_ij = C_i.B_j exp(cs_i-cs_j)
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=xh.device).tril()[None, None, :, :, None]
    # mask BEFORE exp: exp of the masked (positive) entries overflows and
    # poisons the backward pass with 0 * inf NaNs
    Lmat = torch.exp(torch.where(tri, decay, float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * Lmat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xb)

    # chunk states: S_c = sum_j exp(seg_total - cs_j) B_j (x_j)^T
    w_state = torch.exp(seg_total[:, :, None, :] - cs)     # (B,nc,Q,H)
    S = torch.einsum("bcjhn,bcjhp->bchpn", Bc * w_state[..., None], xb)

    # inter-chunk recurrence over nc; each chunk sees the state before it
    gamma = torch.exp(seg_total)                           # (B,nc,H)
    h = (torch.zeros(Bsz, H, hd, N, dtype=f32, device=xh.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * gamma[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,hd,N)

    # inter-chunk contribution: y_i += exp(cs_i) * C_i . h_prev
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Cc * torch.exp(cs)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(Bsz, L, H, hd)
    return y, h


def ssm_apply(p, x: torch.Tensor, cfg,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """The Mamba-2 mixer on x (B, L, D). Given states seed the recurrence
    (decode, or a prefill continued). With ``return_state`` also returns
    (conv state (B, C, K-1) in x's type, SSM state (B, H, hd, N) fp32)."""
    dims = ssm_dims(cfg)
    H, hd, N, G = (dims["n_heads"], cfg.ssm_head_dim, cfg.ssm_state,
                   cfg.ssm_groups)
    B, L, _ = x.shape
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    d_in = dims["d_in"]
    xs = xBC[..., :d_in].reshape(B, L, H, hd)
    Bm = xBC[..., d_in: d_in + G * N].reshape(B, L, G, N)
    Cm = xBC[..., d_in + G * N:].reshape(B, L, G, N)
    rep = H // G
    Bm = torch.repeat_interleave(Bm, rep, dim=2)
    Cm = torch.repeat_interleave(Cm, rep, dim=2)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    chunk = min(cfg.ssm_chunk, L)
    xp = xs
    if L % chunk != 0:
        # pad to a chunk multiple with dt = 0: the padded steps neither
        # decay nor feed the state (repro/models/ssm.py:150-156)
        pad = chunk - L % chunk
        xp = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, h_final = _ssd_chunked(xp, dt, A, Bm, Cm, chunk, ssm_state)
    y = y[:, :L]
    y = y + p["D_skip"].float()[None, None, :, None] * xs.float()
    y = y.reshape(B, L, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, (new_conv, h_final)
    return out


def ssm_decode_step(p, x: torch.Tensor, cfg, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor):
    """One-token recurrent update: :func:`ssm_apply` at L = 1 (chunk 1).
    x (B, 1, D); returns (out, new conv state, new SSM state)."""
    out, (new_conv, new_h) = ssm_apply(p, x, cfg, conv_state=conv_state,
                                       ssm_state=ssm_state,
                                       return_state=True)
    return out, new_conv, new_h


def ssm_state_shapes(cfg, batch: int) -> Dict[str, Tuple[int, ...]]:
    dims = ssm_dims(cfg)
    return {
        "conv": (batch, dims["conv_dim"], cfg.ssm_conv - 1),
        "h": (batch, dims["n_heads"], cfg.ssm_head_dim, cfg.ssm_state),
    }
