"""Mixture-of-Experts FFN in plain PyTorch: token-choice top-k routing, a
per-expert capacity, a grouped expert FFN and a weighted combine (the port
of ``repro/models/moe.py``'s single-device path and its ``dense_tp``
path).

``moe_impl="ep_shardmap"`` without a mesh is the reference's local path,
and one card has no mesh, so that is what it runs; an expert-parallel path
across cards is not ported. ``"dense_tp"`` computes every expert for every
token and mask-combines.

The reference's routing and capacity are reproduced exactly:

* top-k by a stable descending sort of the softmax, so equal probabilities
  rank the lower expert first (``jax.lax.top_k``; ``torch.topk`` does not
  promise that);
* hits sorted stably by expert (``jnp.argsort``), capacity
  ``ceil(T * K / E * capacity_factor)`` over all T tokens of the call
  (padding and meta tokens included), the overflow of each expert dropped
  in token order.

Dispatch and combine are gathers, not scatters: expert e's slot c holds the
c-th of its hits in sorted order, and each token sums its K weighted hit
outputs in fp32 in hit order. No atomics, so the same batch gives the same
bits every time on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import Spec


def moe_schema(cfg) -> Dict[str, Spec]:
    D = cfg.d_model
    E = cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    s = {
        "router": Spec((D, E), ("embed", None), "small"),
        "w_gate": Spec((E, D, fe), ("experts", "embed_fsdp", "expert_mlp")),
        "w_up": Spec((E, D, fe), ("experts", "embed_fsdp", "expert_mlp")),
        "w_down": Spec((E, fe, D), ("experts", "expert_mlp", "embed_fsdp")),
    }
    if cfg.n_shared_experts > 0:
        fs = cfg.n_shared_experts * fe
        s["shared"] = {
            "w_gate": Spec((D, fs), ("embed_fsdp", "mlp")),
            "w_up": Spec((D, fs), ("embed_fsdp", "mlp")),
            "w_down": Spec((fs, D), ("mlp", "embed_fsdp")),
        }
    return s


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _route(xf: torch.Tensor, router: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) -> renormalised top-k weights (T, K) fp32 and expert indices
    (T, K) int64, ties to the lower expert index."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx


def capacity_plan(idx: torch.Tensor, n_experts: int, capacity: int):
    """The reference's dispatch bookkeeping for hits ``idx`` (T, K):
    ``order`` (T*K,) sorts the hits stably by expert, ``keep`` (T*K,) says
    which sorted hits fit their expert's capacity, and ``src`` (E, C) is the
    sorted hit in each expert slot (clamped; ``filled`` (E, C) says which
    slots hold one)."""
    TK = idx.numel()
    E, C = n_experts, capacity
    fe = idx.reshape(-1)
    order = torch.sort(fe, stable=True).indices
    se = fe[order]
    counts = torch.bincount(fe, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(TK, device=idx.device) - starts[se]
    keep = pos < C
    slot_c = torch.arange(C, device=idx.device)
    filled = slot_c[None, :] < counts[:, None]
    src = (starts[:, None] + slot_c[None, :]).clamp_max(max(TK - 1, 0))
    return order, se, pos, keep, src, filled


def _local_expert_ffn(xf, weights, idx, w1, w2, w3, capacity: int,
                      act: str) -> torch.Tensor:
    """Grouped FFN over all E experts (``repro/models/moe.py:62``).
    xf (T, D); weights / idx (T, K); w1 / w2 (E, D, F); w3 (E, F, D).
    Returns (T, D) in xf's type."""
    T, D = xf.shape
    K = idx.shape[1]
    E = w1.shape[0]
    C = capacity
    order, se, pos, keep, src, filled = capacity_plan(idx, E, C)
    st = order // K                                       # source token
    # dispatch: slot (e, c) <- the token of expert e's c-th sorted hit
    xe = xf[st[src]] * filled[..., None].to(xf.dtype)     # (E, C, D)
    h1 = torch.bmm(xe, w1)
    if act == "swiglu":
        h = F.silu(h1) * torch.bmm(xe, w2)
    else:
        h = _gelu(h1)
    ye = torch.bmm(h, w3)                                 # (E, C, D)
    # combine: sorted hit j reads its slot; hits return to (T, K) order
    # and each token sums its K weighted outputs in fp32
    slot = se * C + pos.clamp_max(C - 1)
    picked = ye.reshape(E * C, D)[slot].float() * (
        keep.float() * weights.reshape(-1)[order])[:, None]
    unsorted = picked[torch.argsort(order)]
    return unsorted.reshape(T, K, D).sum(dim=1).to(xf.dtype)


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): routed experts plus the shared experts."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    act = cfg.act
    xf = x.reshape(B * S, D)
    weights, idx = _route(xf, p["router"], K)
    if cfg.moe_impl == "dense_tp":
        h1 = torch.einsum("td,edf->tef", xf, p["w_gate"])
        if act == "swiglu":
            h = F.silu(h1) * torch.einsum("td,edf->tef", xf, p["w_up"])
        else:
            h = _gelu(h1)
        ye = torch.einsum("tef,efd->ted", h, p["w_down"])
        comb = torch.zeros(xf.shape[0], E, dtype=ye.dtype, device=x.device)
        comb = comb.scatter(1, idx, weights.to(ye.dtype))
        y = torch.einsum("ted,te->td", ye, comb)
    elif cfg.moe_impl == "ep_shardmap":
        capacity = int(math.ceil(xf.shape[0] * K / E * cfg.capacity_factor))
        y = _local_expert_ffn(xf, weights, idx, p["w_gate"], p["w_up"],
                              p["w_down"], capacity, act)
    else:
        raise ValueError(f"moe_impl {cfg.moe_impl!r}: ep_shardmap | dense_tp")
    if cfg.n_shared_experts > 0:
        sp = p["shared"]
        if act == "swiglu":
            ys = (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
        else:
            ys = _gelu(xf @ sp["w_up"]) @ sp["w_down"]
        y = y + ys
    return y.reshape(B, S, D)
