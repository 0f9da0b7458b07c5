"""The dense decoder LM (the port of ``repro/models/transformer.py``'s dense
GQA path) as ``nn.Module``s, with the reference's entry points:

* ``forward``     — full-sequence forward (hidden states, optionally caches)
* ``prefill``     — forward that also fills KV caches sized ``cache_seq`` and
                    returns the last position's logits
* ``decode_step`` — one token against the caches, attention through kernel
                    10 (``kernels.ops.flash_decode``)
* ``loss_fn``     — the training forward (:func:`forward_train`) and the
                    mean cross entropy, optionally in ``cfg.loss_chunk``
                    chunks of the sequence

Parameters keep the reference's shapes (``wq`` (D, H, hd), ``wo``
(H, hd, D), ...), one :class:`DecoderLayer` per layer instead of stacked
``(L, ...)`` leaves; layers run as a Python loop (no scan). The KV cache
keeps the reference's ``(L, B, KV, S, hd)`` layout, so each layer's slice is
already the kernel's ``(b, kv_h, s, d)``.

Serving (``forward``, ``prefill``, ``decode_step``) runs without autograd
and with the prefill attention. Training (:func:`forward_train`,
:func:`loss_fn`) runs with autograd, the attention of ``cfg.attn_impl``
(``attention.flash_attention`` or ``naive_attention``) and ``cfg.remat``
per layer (:func:`_remat`); a model is trainable once its parameters
require grad (``Transformer(..., trainable=True)`` or
``model.requires_grad_()``).

The MoE, SSM, hybrid, encoder-decoder, meta-token and patch-embedding
families and ``layer_group > 1`` bands are not ported yet (ROADMAP queue 1):
building them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from . import attention as A
from .common import ArchConfig
from .layers import (Spec, cross_entropy, mlp_apply, mlp_schema, rms_norm,
                     stack_schema)

# ------------------------------------------------------------------- schemas


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a family this port does not run yet."""
    reasons = [why for bad, why in (
        (cfg.n_experts > 0, "MoE (n_experts > 0)"),
        (cfg.attn_free or cfg.hybrid or cfg.family in ("ssm", "hybrid"),
         "SSM / hybrid mixers"),
        (cfg.is_encdec, "encoder-decoder"),
        (cfg.meta_tokens > 0, "meta tokens"),
        (cfg.num_patches > 0, "patch embeddings"),
        (cfg.layer_group > 1, "layer_group > 1 static bands")) if bad]
    if reasons:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(reasons)} not ported to repro_torch yet "
            "(ROADMAP queue 1)")


def layer_schema(cfg: ArchConfig) -> Dict[str, Any]:
    check_supported(cfg)
    D = cfg.d_model
    s: Dict[str, Any] = {"ln1": Spec((D,), (None,), "ones"),
                         "attn": A.attn_schema(cfg)}
    if cfg.d_ff > 0:
        s["mlp"] = mlp_schema(D, cfg.d_ff, cfg.act)
        s["ln2"] = Spec((D,), (None,), "ones")
    return s


def model_schema(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's parameter schema, layer leaves stacked ``(L, ...)``."""
    D, V = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {
        "embed": Spec((V, D), ("vocab", "embed"), "embed"),
        "layers": stack_schema(layer_schema(cfg), cfg.n_layers),
        "final_norm": Spec((D,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((D, V), ("embed_fsdp", "vocab"))
    return s


def cache_schema(cfg: ArchConfig, batch: int, cache_seq: int
                 ) -> Dict[str, Spec]:
    """Allocation-free cache description (shapes + logical axes)."""
    check_supported(cfg)
    L, KV, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    kv_shape = (L, batch, KV, cache_seq, hd)
    axes = ("layers", "cache_batch", "kv_heads", "cache_seq", "head_dim")
    return {"len": Spec((batch,), ("cache_batch",), "zeros"),
            "k": Spec(kv_shape, axes, "zeros"),
            "v": Spec(kv_shape, axes, "zeros")}


# ------------------------------------------------------------------- modules


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: ``ln1``, ``attn`` (``wq``, ``wk``,
    ``wv``, ``wo`` and the optional biases / qk norms), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, p: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(p["ln1"])
        self.attn = nn.ParameterDict(
            {key: _frozen(t) for key, t in p["attn"].items()})
        if "mlp" in p:
            self.ln2 = _frozen(p["ln2"])
            self.mlp = nn.ParameterDict(
                {key: _frozen(t) for key, t in p["mlp"].items()})
        else:
            self.mlp = None

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        if self.mlp is None:
            return h
        return h + mlp_apply(self.mlp, rms_norm(h, self.ln2,
                                                self.cfg.norm_eps),
                             self.cfg.act)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int,
                kv_out=None, train: bool = False) -> torch.Tensor:
        """Full-sequence layer (x (B, S, D)). ``kv_out`` = (k, v) cache
        slices (B, KV, >= S, hd) that receive this layer's keys/values.
        ``train`` selects the differentiable attention of
        ``cfg.attn_impl`` instead of the prefill attention."""
        cfg = self.cfg
        q, k, v = A.qkv_project(self.attn, rms_norm(x, self.ln1,
                                                    cfg.norm_eps),
                                cfg, positions)
        local = dict(window=window if cfg.sliding_window else 0,
                     chunk=window if cfg.attn_chunk else 0)
        if not train:
            attend = A.attention
        elif cfg.attn_impl == "naive":
            attend = A.naive_attention
        else:
            attend = A.flash_attention
        attn = attend(q, k, v, causal=True, **local)
        if kv_out is not None:
            S = x.shape[1]
            kv_out[0][:, :, :S].copy_(k.transpose(1, 2))
            kv_out[1][:, :, :S].copy_(v.transpose(1, 2))
        return self._ffn(x + A.out_project(attn, self.attn["wo"]))

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, new_len: torch.Tensor,
               window: int) -> torch.Tensor:
        """One-token layer: x (B, 1, D); k/v_cache (B, KV, S, hd) are
        written IN PLACE at ``new_len - 1`` (the reference returns updated
        copies); new_len (B,) counts the new token."""
        cfg = self.cfg
        B = x.shape[0]
        pos = (new_len - 1)[:, None]                          # (B, 1)
        q, k, v = A.qkv_project(self.attn, rms_norm(x, self.ln1,
                                                    cfg.norm_eps), cfg, pos)
        rows = torch.arange(B, device=x.device)
        at = (new_len - 1).long()
        k_cache[rows, :, at] = k[:, 0]
        v_cache[rows, :, at] = v[:, 0]
        attn = A.decode_attention(q[:, 0], k_cache, v_cache, new_len,
                                  window=window, chunk=cfg.attn_chunk)
        h = x + A.out_project(attn, self.attn["wo"])[:, None]
        return self._ffn(h)


class Transformer(nn.Module):
    """The LM: ``embed`` (V, D), ``layers``, ``final_norm`` and, unless
    embeddings are tied, ``lm_head`` (D, V).

    ``params`` is the reference's nested parameter dict (layer leaves
    stacked ``(L, ...)``, tensors), as :func:`~.layers.init_params` or
    ``models.convert`` give it; every leaf is cast to
    ``cfg.param_dtype()`` and placed on ``device`` (``None`` = ``"cuda"``,
    which raises without a card). The layers hold views of the stacked
    leaves. ``trainable`` makes every parameter require grad (the
    optimizer's leaves are then ``dict(model.named_parameters())``); a
    trainable model copies ``params``, since training updates its leaves
    in place (a serving model may share the caller's tensors)."""

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any],
                 device=None, trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = cfg.param_dtype()

        def put(tree):
            if isinstance(tree, dict):
                return {key: put(sub) for key, sub in tree.items()}
            return tree.to(device=dev, dtype=dtype, copy=trainable)

        params = put(params)
        self.embed = _frozen(params["embed"])
        self.final_norm = _frozen(params["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _frozen(params["lm_head"]))
        stacked = params["layers"]

        def layer(i: int, tree):
            return {key: layer(i, sub) if isinstance(sub, dict) else sub[i]
                    for key, sub in tree.items()}

        self.layers = nn.ModuleList(
            DecoderLayer(cfg, layer(i, stacked))
            for i in range(cfg.n_layers))
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ------------------------------------------------------------------ forwards


def _tokens(params: Transformer, tokens) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=params.device, dtype=torch.long)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, layer: DecoderLayer):
    """The reference's ``_remat`` (``repro/models/transformer.py:209``) for
    one layer: ``"none"`` keeps every activation; ``"full"`` (its
    ``nothing_saveable``) keeps only the layer's input and recomputes the
    layer in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` (its ``checkpoint_dots``) is a selective checkpoint that
    keeps the outputs of the matrix products (``aten.mm`` / ``bmm`` /
    ``addmm``, the projections, the MLP and the attention tiles) and
    recomputes the elementwise work around them."""
    if cfg.remat == "none":
        return layer
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: none | dots | full")
    kw = {} if cfg.remat == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(
            _save_dots)}

    def run(*args):
        return checkpoint(layer, *args, use_reentrant=False, **kw)
    return run


def _run(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
         kv_out=None, train: bool = False) -> torch.Tensor:
    x = F.embedding(tokens, params.embed)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    windows = cfg.layer_windows()
    for i, lay in enumerate(params.layers):
        if train:
            x = _remat(cfg, lay)(x, positions, int(windows[i]), None, True)
        else:
            x = lay(x, positions, int(windows[i]),
                    None if kv_out is None else (kv_out[0][i], kv_out[1][i]))
    return rms_norm(x, params.final_norm, cfg.norm_eps)


@torch.no_grad()
def forward(params: Transformer, tokens, cfg: ArchConfig,
            extra: Optional[Dict[str, Any]] = None,
            collect_cache: bool = False):
    """Full-sequence forward. Returns hidden states (B, S, D) and, with
    ``collect_cache``, ``((k, v), None, None)`` with k, v
    (L, B, KV, S, hd) — the reference's ``(kv, ssm_state, xkv)``."""
    tokens = _tokens(params, tokens)
    if not collect_cache:
        return _run(params, tokens, cfg), None
    B, S = tokens.shape
    shape = (cfg.n_layers, B, cfg.kv_heads, S, cfg.hd)
    k = torch.empty(shape, dtype=params.embed.dtype, device=params.device)
    v = torch.empty_like(k)
    h = _run(params, tokens, cfg, (k, v))
    return h, ((k, v), None, None)


def forward_train(params: Transformer, tokens, cfg: ArchConfig
                  ) -> torch.Tensor:
    """The training forward: hidden states (B, S, D) with autograd, the
    attention of ``cfg.attn_impl`` and ``cfg.remat`` per layer."""
    return _run(params, _tokens(params, tokens), cfg, train=True)


def logits_from_hidden(params: Transformer, h: torch.Tensor,
                       cfg: ArchConfig) -> torch.Tensor:
    """(..., D) -> (..., V) fp32 logits (the product in the params' type)."""
    head = params.embed.t() if cfg.tie_embeddings else params.lm_head
    return (h @ head.to(h.dtype)).float()


def loss_fn(params: Transformer, batch: Dict[str, Any],
            cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored), a 0-dim fp32 tensor with autograd
    (``repro/models/transformer.py:351-376``). With ``cfg.loss_chunk`` below
    the sequence length the logits are formed ``loss_chunk`` positions at a
    time and the chunks' losses weighted by their valid counts; positions
    past the last whole chunk are left out, as in the reference."""
    h = forward_train(params, batch["tokens"], cfg)
    labels = _tokens(params, batch["labels"])
    S = h.shape[1]
    if cfg.loss_chunk and cfg.loss_chunk < S:
        C = cfg.loss_chunk
        losses, counts = [], []
        for c0 in range(0, S // C * C, C):
            ll = labels[:, c0:c0 + C]
            logits = logits_from_hidden(params, h[:, c0:c0 + C], cfg)
            losses.append(cross_entropy(logits, ll))
            counts.append((ll != -1).sum())
        w = torch.stack(counts).float()
        return (torch.stack(losses) * w).sum() / w.sum().clamp_min(1.0)
    return cross_entropy(logits_from_hidden(params, h, cfg), labels)


@torch.no_grad()
def prefill(params: Transformer, batch: Dict[str, Any], cfg: ArchConfig,
            cache_seq: int):
    """Run the prompt ``batch["tokens"]`` (B, S), fill caches sized
    ``cache_seq`` (zeros past S) and return (last logits (B, 1, V),
    cache ``{"len", "k", "v"}``)."""
    tokens = _tokens(params, batch["tokens"])
    B, S = tokens.shape
    if cache_seq < S:
        raise ValueError(f"cache_seq {cache_seq} < prompt length {S}")
    sch = cache_schema(cfg, B, cache_seq)
    k = torch.zeros(sch["k"].shape, dtype=params.embed.dtype,
                    device=params.device)
    v = torch.zeros_like(k)
    h = _run(params, tokens, cfg, (k, v))
    logits = logits_from_hidden(params, h[:, -1:], cfg)
    length = torch.full((B,), S, dtype=torch.int32, device=params.device)
    return logits, {"len": length, "k": k, "v": v}


@torch.no_grad()
def decode_step(params: Transformer, cache: Dict[str, torch.Tensor], tokens,
                cfg: ArchConfig, extra: Optional[Dict[str, Any]] = None):
    """One greedy decode step: tokens (B, 1) -> (logits (B, 1, V), cache).
    The new token's K/V rows are written into ``cache["k"]`` /
    ``cache["v"]`` in place (the reference returns new arrays); the
    returned cache holds the same tensors and ``len + 1``."""
    tokens = _tokens(params, tokens)
    x = params.embed[tokens]
    new_len = cache["len"] + 1
    windows = cfg.layer_windows()
    for i, lay in enumerate(params.layers):
        x = lay.decode(x, cache["k"][i], cache["v"][i], new_len,
                       int(windows[i]))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(params, x, cfg)
    return logits, {"len": new_len, "k": cache["k"], "v": cache["v"]}
