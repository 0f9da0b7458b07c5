"""Hand the reference's LM parameters to the port, and back.

The reference keeps parameters as a pytree of arrays whose layer leaves are
stacked ``(L, ...)`` (``repro.models.layers.init_params``); given as numpy
arrays (bf16 ones as ``ml_dtypes.bfloat16``), :func:`from_reference` checks
every shape against the port's schema (every leaf of every family:
``router`` and the (E, ., .) expert stacks, ``shared``, the ``ssm``
leaves, ``meta``, ``encoder.*``, ``xattn.*``) and builds the port's
:class:`~.transformer.Transformer` on a device. :func:`to_reference` is the
inverse: the stacked numpy tree of a port model, in the same layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .common import ArchConfig
from .layers import map_schema
from .transformer import Transformer, model_schema


def check_tree(tree: Dict[str, Any], cfg: ArchConfig) -> None:
    """Raise unless ``tree`` has exactly the schema's keys and shapes."""
    def walk(node, spec, path):
        if isinstance(spec, dict):
            got = sorted(node) if isinstance(node, dict) else type(node)
            if got != sorted(spec):
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(spec)}")
            for key in spec:
                walk(node[key], spec[key], f"{path}/{key}")
        elif tuple(node.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(node.shape)} != "
                             f"{tuple(spec.shape)}")
    walk(tree, model_schema(cfg), "")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: same bits, no numpy kind
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))       # a writable copy


def from_reference(tree: Dict[str, Any], cfg: ArchConfig,
                   device=None) -> Transformer:
    """The reference's stacked parameter tree (numpy leaves) as the port's
    model on ``device`` (``None`` = ``"cuda"``), in ``cfg.param_dtype()``."""
    check_tree(tree, cfg)
    return Transformer(cfg, map_schema(_tensor, tree), device=device)


def to_reference(model: Transformer) -> Dict[str, Any]:
    """The port model's parameters as the reference's stacked numpy tree
    (fp32 leaves; bf16 widens exactly): the layer leaves stacked over
    ``model.layers`` (and ``model.encoder.layers``), every other leaf read
    from the module at its path."""
    cfg = model.cfg

    def numpy(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def walk(spec, path, get):
        if isinstance(spec, dict):
            return {key: walk(spec[key], path + (key,), get) for key in spec}
        return get(path)

    def attr(obj, path):
        for key in path:
            obj = getattr(obj, key)
        return obj

    def stacked(layers):
        return lambda path: np.stack([numpy(attr(lay, path))
                                      for lay in layers])

    schema = model_schema(cfg)
    tree = {key: walk(spec, (key,), lambda path: numpy(attr(model, path)))
            for key, spec in schema.items()
            if key not in ("layers", "encoder")}
    tree["layers"] = walk(schema["layers"], (), stacked(model.layers))
    if "encoder" in schema:
        tree["encoder"] = {
            "layers": walk(schema["encoder"]["layers"], (),
                           stacked(model.encoder.layers)),
            "final_norm": numpy(model.encoder.final_norm)}
    check_tree(tree, cfg)
    return tree
