"""Allocation-free input specs for every (arch x shape) cell (the port of
``repro/launch/specs.py``).

Every function returns a dict of tensors on ``torch.device("meta")``:
shape and dtype with no storage, PyTorch's counterpart of
``jax.ShapeDtypeStruct``. Parameters carry the port's flat names (those
``Transformer.named_parameters()`` gives, one entry per layer), and the
optimizer state is :func:`~repro_torch.training.optimizer.init_opt_state`
of them, so both are what the trainer allocates. The batch and the cache
follow the reference's trees key for key.

The reference also derives a sharding tree per cell from logical-axis
rules (``cell_rules``, the ``NamedSharding`` half of each return) and a
jit-ready step (``make_step_fn``). The port runs a model on one card, with
no logical-axis sharding (``models/common.py``), and compiles nothing
ahead of time, so neither has a counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs import ShapeSpec
from ..models import cache_schema, model_schema
from ..models.common import ArchConfig
from ..models.layers import map_schema, schema_leaves
from ..training.optimizer import init_opt_state

META = torch.device("meta")


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _flatten(schema: Dict[str, Any], prefix: str, dtype: torch.dtype,
             out: Dict[str, torch.Tensor]) -> None:
    """Leaves before sub-trees, each in key order; a ``layers`` sub-tree is
    stacked ``(L, ...)`` and unstacks into ``layers.<i>.`` names."""
    for key in sorted(schema):
        if not isinstance(schema[key], dict):
            out[prefix + key] = _meta(schema[key].shape, dtype)
    for key in sorted(schema):
        sub = schema[key]
        if not isinstance(sub, dict):
            continue
        if key == "layers":
            layer = map_schema(lambda s: s._replace(shape=s.shape[1:]), sub)
            for i in range(schema_leaves(sub)[0].shape[0]):
                _flatten(layer, f"{prefix}layers.{i}.", dtype, out)
        else:
            _flatten(sub, f"{prefix}{key}.", dtype, out)


def params_specs(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """``{name: meta tensor}`` in ``cfg.param_dtype()``, one entry per
    parameter of ``Transformer(cfg, ...)``. Their bytes are the model's,
    not ``cfg.param_count()``'s closed form, which the roofline keeps as
    the reference has it: it counts the final norm twice (for qwen3-0.6b
    in bf16 the specs hold 1,024 x 2 bytes less) and approximates the SSM
    leaves."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(model_schema(cfg), "", cfg.param_dtype(), out)
    return out


def opt_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The optimizer state the trainer allocates for ``cfg``: fp32 ``mu`` /
    ``nu`` per parameter and a 0-dim int32 ``step``, on the meta device."""
    return init_opt_state(params_specs(cfg))


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``tokens`` (B, 1) for decode, else (B, S), with ``labels`` for
    train, and ``patch_embeds`` / ``frames`` (bf16) where the family reads
    them."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    out = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.num_patches > 0:
        out["patch_embeds"] = _meta((B, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
    if cfg.is_encdec:
        out["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The decode cache of ``shape.global_batch`` sequences of
    ``shape.seq_len`` positions: ``len`` int32, the SSM state ``h`` fp32,
    the rest in the param dtype."""
    schema = cache_schema(cfg, shape.global_batch, shape.seq_len)
    dtypes = {"len": torch.int32, "h": torch.float32}
    return {key: _meta(spec.shape, dtypes.get(key, cfg.param_dtype()))
            for key, spec in schema.items()}


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict (meta or real)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(sub) for sub in tree.values())
    return tree.numel() * tree.element_size()


__all__ = ["params_specs", "opt_specs", "batch_specs", "cache_specs",
           "tree_bytes"]
