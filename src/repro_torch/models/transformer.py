"""The LM stack (the port of ``repro/models/transformer.py``) as
``nn.Module``s, for all ten configs: dense GQA, MoE, SSM, the hybrid
attention + SSM mixer, the encoder-decoder and the patch-embedding VLM.
The reference's entry points:

* ``forward``     — full-sequence forward (hidden states, optionally caches)
* ``prefill``     — forward that also fills the caches (K/V sized
                    ``cache_seq``, SSM states, cross-attention K/V) and
                    returns the last position's logits
* ``decode_step`` — one token against the caches, every attention through
                    kernel 10 (``kernels.ops.flash_decode``)
* ``loss_fn``     — the training forward (:func:`forward_train`) and the
                    mean cross entropy, optionally in ``cfg.loss_chunk``
                    chunks of the sequence

Parameters keep the reference's shapes (``wq`` (D, H, hd), ``wo``
(H, hd, D), ``w_gate`` (E, D, F), ...), one :class:`DecoderLayer` per layer
instead of stacked ``(L, ...)`` leaves; layers run as a Python loop (no
scan). Each layer holds what its config gives it: ``attn``, ``ssm``,
``moe`` or ``mlp``, ``xattn`` (whisper's decoder). Caches keep the
reference's layouts: ``k`` / ``v`` (L, B, KV, S, hd), so each layer's slice
is already the kernel's (b, kv_h, s, d); ``conv`` (L, B, C, K-1) and ``h``
(L, B, H, hd, N) fp32; ``xk`` / ``xv`` (L, B, KV, S_enc, hd). Hymba's meta
tokens stand in front of the prompt: its caches and ``len`` count them.

Serving (``forward``, ``prefill``, ``decode_step``) runs without autograd
and with the prefill attention. Training (:func:`forward_train`,
:func:`loss_fn`) runs with autograd, the attention of ``cfg.attn_impl``
(``attention.flash_attention`` or ``naive_attention``) and ``cfg.remat``
per layer (:func:`_remat`); a model is trainable once its parameters
require grad (``Transformer(..., trainable=True)`` or
``model.requires_grad_()``). With ``cfg.layer_group > 1`` local layers run
the static-band attention (``attention.local_attention`` /
``chunked_attention``), as the reference's grouped scan does.
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
from . import moe as MOE
from . import ssm as SSM
from .common import ArchConfig
from .layers import (Spec, cross_entropy, mlp_apply, mlp_schema, rms_norm,
                     stack_schema)

# ------------------------------------------------------------------- schemas


def layer_schema(cfg: ArchConfig) -> Dict[str, Any]:
    D = cfg.d_model
    s: Dict[str, Any] = {"ln1": Spec((D,), (None,), "ones")}
    if not cfg.attn_free:
        s["attn"] = A.attn_schema(cfg)
    if cfg.attn_free or cfg.hybrid:
        s["ssm"] = SSM.ssm_schema(cfg)
    if cfg.n_experts > 0:
        s["moe"] = MOE.moe_schema(cfg)
        s["ln2"] = Spec((D,), (None,), "ones")
    elif cfg.d_ff > 0:
        s["mlp"] = mlp_schema(D, cfg.d_ff, cfg.act)
        s["ln2"] = Spec((D,), (None,), "ones")
    if cfg.is_encdec:                       # decoder cross-attention
        s["xattn"] = A.attn_schema(cfg)
        s["lnx"] = Spec((D,), (None,), "ones")
    return s


def encoder_layer_schema(cfg: ArchConfig) -> Dict[str, Any]:
    D = cfg.d_model
    return {
        "ln1": Spec((D,), (None,), "ones"),
        "attn": A.attn_schema(cfg),
        "ln2": Spec((D,), (None,), "ones"),
        "mlp": mlp_schema(D, cfg.d_ff, cfg.act),
    }


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
    if cfg.meta_tokens > 0:
        s["meta"] = Spec((cfg.meta_tokens, D), (None, "embed"), "embed")
    if cfg.is_encdec:
        s["encoder"] = {
            "layers": stack_schema(encoder_layer_schema(cfg),
                                   cfg.encoder_layers),
            "final_norm": Spec((D,), (None,), "ones"),
        }
    return s


def cache_schema(cfg: ArchConfig, batch: int, cache_seq: int
                 ) -> Dict[str, Spec]:
    """Allocation-free cache description (shapes + logical axes)."""
    L, KV, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    s: Dict[str, Spec] = {"len": Spec((batch,), ("cache_batch",), "zeros")}
    if not cfg.attn_free:
        kv_shape = (L, batch, KV, cache_seq, hd)
        axes = ("layers", "cache_batch", "kv_heads", "cache_seq", "head_dim")
        s["k"] = Spec(kv_shape, axes, "zeros")
        s["v"] = Spec(kv_shape, axes, "zeros")
    if cfg.attn_free or cfg.hybrid:
        shapes = SSM.ssm_state_shapes(cfg, batch)
        s["conv"] = Spec((L,) + shapes["conv"],
                         ("layers", "cache_batch", "mlp", None), "zeros")
        s["h"] = Spec((L,) + shapes["h"],
                      ("layers", "cache_batch", None, None, "state"), "zeros")
    if cfg.is_encdec:
        xkv = (L, batch, KV, cfg.encoder_seq, hd)
        axes = ("layers", "cache_batch", "kv_heads", None, "head_dim")
        s["xk"] = Spec(xkv, axes, "zeros")
        s["xv"] = Spec(xkv, axes, "zeros")
    return s


#: cache keys a layer reads and writes, in the reference's order
LAYER_KEYS = ("k", "v", "conv", "h", "xk", "xv")

# ------------------------------------------------------------------- modules


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A nested parameter dict as a module: leaves are parameters named by
    their keys, sub-dicts are sub-trees (``moe.shared.w_gate``), and
    ``tree[key]`` reads either."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, sub in tree.items():
            if isinstance(sub, dict):
                self.add_module(key, ParamTree(sub))
            else:
                self.register_parameter(key, _frozen(sub))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _opt_tree(p: Dict[str, Any], key: str) -> Optional[ParamTree]:
    return ParamTree(p[key]) if key in p else None


def _opt_param(p: Dict[str, Any], key: str) -> Optional[nn.Parameter]:
    return _frozen(p[key]) if key in p else None


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: ``ln1`` and the sequence mixer
    (``attn``, ``ssm``, or both averaged for the hybrid), then ``lnx`` and
    ``xattn`` (encoder-decoder), then ``ln2`` and ``moe`` or ``mlp``."""

    def __init__(self, cfg: ArchConfig, p: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(p["ln1"])
        self.attn = _opt_tree(p, "attn")
        self.ssm = _opt_tree(p, "ssm")
        self.moe = _opt_tree(p, "moe")
        self.mlp = _opt_tree(p, "mlp")
        self.ln2 = _opt_param(p, "ln2")
        self.xattn = _opt_tree(p, "xattn")
        self.lnx = _opt_param(p, "lnx")

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.moe is not None:
            return h + MOE.moe_apply(self.moe, rms_norm(h, self.ln2,
                                                        cfg.norm_eps), cfg)
        if self.mlp is not None:
            return h + mlp_apply(self.mlp, rms_norm(h, self.ln2,
                                                    cfg.norm_eps), cfg.act)
        return h

    def _attention(self, q, k, v, window: int, impl: str) -> torch.Tensor:
        """The layer's causal self-attention: static bands with
        ``layer_group > 1`` (``repro/models/transformer.py:95-107``), else
        masks (window for sliding-window configs, chunk for chunked ones;
        0 = global)."""
        cfg = self.cfg
        if cfg.layer_group > 1 and window > 0:
            if cfg.attn_chunk:
                return A.chunked_attention(q, k, v, chunk=window, impl=impl)
            return A.local_attention(q, k, v, window=window, impl=impl)
        if cfg.layer_group > 1:
            window = 0
        return A.attend(impl, q, k, v, causal=True,
                        window=window if cfg.sliding_window else 0,
                        chunk=window if cfg.attn_chunk else 0)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int,
                cache=None, enc_out=None, train: bool = False
                ) -> torch.Tensor:
        """Full-sequence layer (x (B, S, D)). ``cache`` = this layer's
        slices of the stacked caches (``k`` / ``v`` (B, KV, >= S, hd),
        ``conv``, ``h``, ``xk``, ``xv``), which receive its keys, values
        and states. ``train`` selects the differentiable attention of
        ``cfg.attn_impl`` instead of the prefill attention."""
        cfg = self.cfg
        impl = cfg.attn_impl if train else "prefill"
        hn = rms_norm(x, self.ln1, cfg.norm_eps)
        outs = []
        if self.attn is not None:
            q, k, v = A.qkv_project(self.attn, hn, cfg, positions)
            attn = self._attention(q, k, v, window, impl)
            outs.append(A.out_project(attn, self.attn["wo"]))
            if cache is not None:
                S = x.shape[1]
                cache["k"][:, :, :S].copy_(k.transpose(1, 2))
                cache["v"][:, :, :S].copy_(v.transpose(1, 2))
        if self.ssm is not None:
            if cache is not None:
                y, (conv, hs) = SSM.ssm_apply(self.ssm, hn, cfg,
                                              return_state=True)
                cache["conv"].copy_(conv)
                cache["h"].copy_(hs)
            else:
                y = SSM.ssm_apply(self.ssm, hn, cfg)
            outs.append(y)
        h = x + (outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1]))
        if self.xattn is not None and enc_out is not None:
            # no bias, RoPE or qk norm (repro/models/transformer.py:150-153)
            q = A._project(rms_norm(h, self.lnx, cfg.norm_eps),
                           self.xattn["wq"])
            k = A._project(enc_out, self.xattn["wk"])
            v = A._project(enc_out, self.xattn["wv"])
            xa = A.attend(impl, q, k, v, causal=False, window=0, chunk=0)
            h = h + A.out_project(xa, self.xattn["wo"])
            if cache is not None:
                cache["xk"].copy_(k.transpose(1, 2))
                cache["xv"].copy_(v.transpose(1, 2))
        return self._ffn(h)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               new_len: torch.Tensor, window: int) -> torch.Tensor:
        """One-token layer: x (B, 1, D); ``cache`` holds this layer's
        slices, updated IN PLACE (the reference returns updated copies):
        the new token's K/V rows at ``new_len - 1``, the SSM ``conv`` and
        ``h`` states; ``xk`` / ``xv`` are read only. new_len (B,) counts
        the new token. Every attention (self and cross) is kernel 10."""
        cfg = self.cfg
        B = x.shape[0]
        hn = rms_norm(x, self.ln1, cfg.norm_eps)
        outs = []
        if self.attn is not None:
            pos = (new_len - 1)[:, None]                      # (B, 1)
            q, k, v = A.qkv_project(self.attn, hn, cfg, pos)
            rows = torch.arange(B, device=x.device)
            at = (new_len - 1).long()
            cache["k"][rows, :, at] = k[:, 0]
            cache["v"][rows, :, at] = v[:, 0]
            # the reference passes the config's chunk to every layer,
            # global ones included (repro/models/transformer.py:182-184)
            attn = A.decode_attention(q[:, 0], cache["k"], cache["v"],
                                      new_len, window=window,
                                      chunk=cfg.attn_chunk)
            outs.append(A.out_project(attn, self.attn["wo"])[:, None])
        if self.ssm is not None:
            y, conv, hs = SSM.ssm_decode_step(self.ssm, hn, cfg,
                                              cache["conv"], cache["h"])
            cache["conv"].copy_(conv)
            cache["h"].copy_(hs)
            outs.append(y)
        h = x + (outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1]))
        if self.xattn is not None:
            q = A._project(rms_norm(h, self.lnx, cfg.norm_eps),
                           self.xattn["wq"])
            enc_len = torch.full((B,), cache["xk"].shape[2],
                                 dtype=new_len.dtype, device=x.device)
            xa = A.decode_attention(q[:, 0], cache["xk"], cache["xv"],
                                    enc_len)
            h = h + A.out_project(xa, self.xattn["wo"])[:, None]
        return self._ffn(h)


class EncoderLayer(nn.Module):
    """One pre-norm encoder layer (whisper): bidirectional ``attn`` and an
    ``mlp``."""

    def __init__(self, cfg: ArchConfig, p: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(p["ln1"])
        self.attn = ParamTree(p["attn"])
        self.ln2 = _frozen(p["ln2"])
        self.mlp = ParamTree(p["mlp"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        impl = cfg.attn_impl if train else "prefill"
        q, k, v = A.qkv_project(self.attn, rms_norm(x, self.ln1,
                                                    cfg.norm_eps),
                                cfg, positions)
        attn = A.attend(impl, q, k, v, causal=False, window=0, chunk=0)
        h = x + A.out_project(attn, self.attn["wo"])
        return h + mlp_apply(self.mlp, rms_norm(h, self.ln2, cfg.norm_eps),
                             cfg.act)


def _unstack(i: int, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Layer i's views of a stacked ``(L, ...)`` tree."""
    return {key: _unstack(i, sub) if isinstance(sub, dict) else sub[i]
            for key, sub in tree.items()}


class Encoder(nn.Module):
    """Whisper's encoder: ``layers`` and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, p: Dict[str, Any]):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, _unstack(i, p["layers"]))
            for i in range(cfg.encoder_layers))
        self.final_norm = _frozen(p["final_norm"])


class Transformer(nn.Module):
    """The LM: ``embed`` (V, D), ``layers``, ``final_norm`` and, as the
    config has them, ``lm_head`` (D, V), ``meta`` (meta tokens, D) and
    ``encoder``.

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
        self.lm_head = _opt_param(params, "lm_head")
        self.meta = _opt_param(params, "meta")
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, _unstack(i, params["layers"]))
            for i in range(cfg.n_layers))
        self.encoder = (Encoder(cfg, params["encoder"]) if cfg.is_encdec
                        else None)
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ------------------------------------------------------------------ forwards


def _tokens(params: Transformer, tokens) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=params.device, dtype=torch.long)


def _extra(params: Transformer, extra: Optional[Dict[str, Any]], key: str
           ) -> Optional[torch.Tensor]:
    """``extra[key]`` on the model's device in its type, or None."""
    x = (extra or {}).get(key)
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=params.device, dtype=params.embed.dtype)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, layer: nn.Module):
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


def _embed(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
           extra) -> torch.Tensor:
    """Token embeddings; the first ``num_patches`` replaced by
    ``extra["patch_embeds"]`` when given; the meta tokens in front
    (``repro/models/transformer.py:217-228``)."""
    x = F.embedding(tokens, params.embed)
    pe = _extra(params, extra, "patch_embeds")
    if cfg.num_patches > 0 and pe is not None:
        x = torch.cat([pe, x[:, cfg.num_patches:]], dim=1)
    if cfg.meta_tokens > 0:
        meta = params.meta[None].expand(x.shape[0], -1, -1)
        x = torch.cat([meta.to(x.dtype), x], dim=1)
    return x


def _encode(params: Transformer, cfg: ArchConfig, extra,
            train: bool = False) -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings ``extra["frames"]``
    (B, S_enc, D) (``repro/models/transformer.py:231``)."""
    x = _extra(params, extra, "frames")
    if x is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder needs "
                         "extra['frames'] (B, S_enc, d_model)")
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for lay in params.encoder.layers:
        if train:
            x = _remat(cfg, lay)(x, positions, True)
        else:
            x = lay(x, positions)
    return rms_norm(x, params.encoder.final_norm, cfg.norm_eps)


def _run(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
         extra=None, cache=None, train: bool = False) -> torch.Tensor:
    x = _embed(params, tokens, cfg, extra)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    enc_out = _encode(params, cfg, extra, train) if cfg.is_encdec else None
    windows = cfg.layer_windows()
    for i, lay in enumerate(params.layers):
        if train:
            x = _remat(cfg, lay)(x, positions, int(windows[i]), None,
                                 enc_out, True)
        else:
            x = lay(x, positions, int(windows[i]),
                    None if cache is None else
                    {key: t[i] for key, t in cache.items()}, enc_out)
    if cfg.meta_tokens > 0:
        x = x[:, cfg.meta_tokens:]
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def _alloc_cache(params: Transformer, cfg: ArchConfig, batch: int,
                 seq: int, enc_seq: int) -> Dict[str, torch.Tensor]:
    """Zeroed stacked caches: k / v with ``seq`` positions and xk / xv with
    ``enc_seq`` in the params' type, conv in the params' type, h in fp32
    (the types prefill's states have)."""
    sch = cache_schema(cfg.replace(encoder_seq=enc_seq), batch, seq)
    dt = params.embed.dtype
    return {key: torch.zeros(sch[key].shape,
                             dtype=torch.float32 if key == "h" else dt,
                             device=params.device)
            for key in LAYER_KEYS if key in sch}


def _enc_seq(cfg: ArchConfig, extra) -> int:
    frames = (extra or {}).get("frames")
    return 0 if frames is None or not cfg.is_encdec else frames.shape[1]


@torch.no_grad()
def forward(params: Transformer, tokens, cfg: ArchConfig,
            extra: Optional[Dict[str, Any]] = None,
            collect_cache: bool = False):
    """Full-sequence forward. Returns hidden states (B, S, D) (meta
    positions dropped) and, with ``collect_cache``, the reference's
    ``(kv, ssm_state, xkv)``: ``(k, v)`` (L, B, KV, S + meta, hd),
    ``(conv, h)`` and ``(xk, xv)``, each None where the config has none."""
    tokens = _tokens(params, tokens)
    if not collect_cache:
        return _run(params, tokens, cfg, extra), None
    B, S = tokens.shape
    cache = _alloc_cache(params, cfg, B, S + cfg.meta_tokens,
                         _enc_seq(cfg, extra))
    h = _run(params, tokens, cfg, extra, cache)

    def pair(a, b):
        return (cache[a], cache[b]) if a in cache else None
    return h, (pair("k", "v"), pair("conv", "h"), pair("xk", "xv"))


def forward_train(params: Transformer, tokens, cfg: ArchConfig,
                  extra: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """The training forward: hidden states (B, S, D) with autograd, the
    attention of ``cfg.attn_impl`` and ``cfg.remat`` per layer; ``extra``
    carries ``frames`` / ``patch_embeds``."""
    return _run(params, _tokens(params, tokens), cfg, extra, train=True)


def logits_from_hidden(params: Transformer, h: torch.Tensor,
                       cfg: ArchConfig) -> torch.Tensor:
    """(..., D) -> (..., V) fp32 logits (the product in the params' type)."""
    head = params.embed.t() if cfg.tie_embeddings else params.lm_head
    return (h @ head.to(h.dtype)).float()


def loss_fn(params: Transformer, batch: Dict[str, Any],
            cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored), a 0-dim fp32 tensor with autograd
    (``repro/models/transformer.py:351-376``); the batch's other keys
    (``frames``, ``patch_embeds``) go to the forward. With
    ``cfg.loss_chunk`` below the sequence length the logits are formed
    ``loss_chunk`` positions at a time and the chunks' losses weighted by
    their valid counts; positions past the last whole chunk are left out,
    as in the reference."""
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    h = forward_train(params, batch["tokens"], cfg, extra)
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
    """Run the prompt ``batch["tokens"]`` (B, S) (with ``frames`` /
    ``patch_embeds`` as the config needs), fill the caches (K/V sized
    ``cache_seq``, zeros past S + meta tokens) and return (last logits
    (B, 1, V), cache ``{"len", "k", "v", "conv", "h", "xk", "xv"}`` as the
    config has them). ``len`` = S + ``cfg.meta_tokens``."""
    tokens = _tokens(params, batch["tokens"])
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    B, S = tokens.shape
    S_tot = S + cfg.meta_tokens
    if cache_seq < S_tot:
        raise ValueError(f"cache_seq {cache_seq} < prompt length {S_tot}")
    cache = _alloc_cache(params, cfg, B, cache_seq, _enc_seq(cfg, extra))
    h = _run(params, tokens, cfg, extra, cache)
    logits = logits_from_hidden(params, h[:, -1:], cfg)
    cache["len"] = torch.full((B,), S_tot, dtype=torch.int32,
                              device=params.device)
    return logits, cache


@torch.no_grad()
def decode_step(params: Transformer, cache: Dict[str, torch.Tensor], tokens,
                cfg: ArchConfig, extra: Optional[Dict[str, Any]] = None):
    """One greedy decode step: tokens (B, 1) -> (logits (B, 1, V), cache).
    The caches are updated in place (the new token's K/V rows, the SSM
    states; the reference returns new arrays); the returned cache holds the
    same tensors and ``len + 1``. ``extra`` is accepted and unused, as in
    the reference (the cross-attention reads ``xk`` / ``xv``)."""
    tokens = _tokens(params, tokens)
    x = params.embed[tokens]
    new_len = cache["len"] + 1
    windows = cfg.layer_windows()
    keys = [key for key in LAYER_KEYS if key in cache]
    for i, lay in enumerate(params.layers):
        x = lay.decode(x, {key: cache[key][i] for key in keys}, new_len,
                       int(windows[i]))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(params, x, cfg)
    return logits, {**{key: cache[key] for key in keys}, "len": new_len}
