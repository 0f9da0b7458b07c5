"""Shared NN building blocks and the parameter schema (the port of
``repro/models/layers.py``).

A model is described by a *schema*: a nested dict whose leaves are
:class:`Spec` (shape, logical axis names, init kind). :func:`init_params`
draws parameters from it; the shapes are the reference's, so its parameter
pytrees load into the port unchanged (``models.convert``).
:func:`cross_entropy` is the training loss.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed | small
    scale: float = 1.0


def map_schema(fn, schema):
    """Apply ``fn`` to every leaf of a nested dict, keys in sorted order
    (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(schema, dict):
        return {key: map_schema(fn, schema[key]) for key in sorted(schema)}
    return fn(schema)


def schema_leaves(schema):
    """The leaves of a nested dict in :func:`map_schema`'s order."""
    if isinstance(schema, dict):
        return [leaf for key in sorted(schema)
                for leaf in schema_leaves(schema[key])]
    return [schema]


def init_params(schema, generator: torch.Generator, dtype: torch.dtype,
                device=None) -> Dict[str, Any]:
    """Parameters for ``schema`` by the reference's rule: zeros, ones,
    ``embed`` normal with std 0.02, otherwise normal with std
    1/sqrt(fan_in) (fan_in = the leading dim). Drawn in fp32 from
    ``generator`` on its own device, then cast; torch's numbers, not the
    reference's bits (tests hand the reference's parameters over instead).
    ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)

    def one(spec: Spec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[0] if spec.shape else 1
        std = spec.scale * (0.02 if spec.init == "embed"
                            else 1.0 / math.sqrt(max(fan_in, 1)))
        x = torch.randn(spec.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        # scaled in place: one fp32 copy of the leaf at a time (deepseek's
        # expert stack is 20.7 GB in fp32)
        return x.mul_(std).to(device=dev, dtype=dtype)

    return map_schema(one, schema)


def stack_schema(schema, n: int):
    """Prepend a layer axis to every leaf (the reference's stacked layout)."""
    return map_schema(
        lambda s: Spec((n,) + s.shape, ("layers",) + s.logical, s.init,
                       s.scale), schema)


# ------------------------------------------------------------------- numerics


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, rounded to ``x.dtype`` BEFORE the scale multiply
    (``repro/models/layers.py:65-68``)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up, w_down) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def relu2_mlp(x: torch.Tensor, w_up, w_down) -> torch.Tensor:
    h = torch.clamp_min(x @ w_up, 0)
    return (h * h) @ w_down


def mlp_schema(d: int, f: int, act: str) -> Dict[str, Spec]:
    if act == "swiglu":
        return {
            "w_gate": Spec((d, f), ("embed_fsdp", "mlp")),
            "w_up": Spec((d, f), ("embed_fsdp", "mlp")),
            "w_down": Spec((f, d), ("mlp", "embed_fsdp")),
        }
    return {
        "w_up": Spec((d, f), ("embed_fsdp", "mlp")),
        "w_down": Spec((f, d), ("mlp", "embed_fsdp")),
    }


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    if act == "relu2":
        return relu2_mlp(x, p["w_up"], p["w_down"])
    return gelu_mlp(x, p["w_up"], p["w_down"])


# ----------------------------------------------------------------------- RoPE


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    """The reference's numpy fp32 expression, so both packages rotate by
    the same frequencies."""
    return np.asarray(theta, np.float32) ** (
        -np.arange(0, hd // 2, dtype=np.float32) / (hd // 2))


@functools.lru_cache(maxsize=None)
def _device_freqs(hd: int, theta: float, device: torch.device
                  ) -> torch.Tensor:
    """:func:`rope_freqs` uploaded once per device: a host-to-device copy
    in every decode layer would stall the host on the card."""
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _device_freqs(hd, float(theta), x.device)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean CE over valid positions; logits (..., V) any float dtype
    (``repro/models/layers.py:125-143``): computed in fp32 against the row
    max, which carries no gradient. The gold logit is gathered (the
    reference's iota mask sums the same single term); an ignored label
    gathers column 0 and is weighted 0."""
    logits = logits.float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    labels = labels.long()
    valid = labels != ignore_id
    gold = shifted.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    weight = valid.float()
    return ((lse - gold) * weight).sum() / weight.sum().clamp_min(1.0)
