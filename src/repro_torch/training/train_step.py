"""The training step on one card: loss -> grads -> AdamW, with optional
microbatch gradient accumulation (the port of
``repro/training/train_step.py``).

The reference's cross-pod variant reduces gradients in int8 over a ``pod``
mesh axis; one card has no such axis, so ``cross_pod_int8=True`` raises as
the reference does without one. :func:`int8_compress` is that variant's
per-leaf quantise / dequantise without the collective.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.common import ArchConfig
from ..models.transformer import Transformer, loss_fn
from .optimizer import OptConfig, adamw_update


def int8_compress(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf through ``int8_psum``'s symmetric per-leaf int8 code and
    back (``repro/training/train_step.py:25-37`` on one participant): scale
    = max|g| / 127 + 1e-12, round half to even, clip to [-127, 127]."""
    def one(g: torch.Tensor) -> torch.Tensor:
        g32 = g.float()
        scale = g32.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return (q.float() * scale).to(g.dtype)
    return {name: one(g) for name, g in tree.items()}


def _as_tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    accum_steps: int = 1, cross_pod_int8: bool = False):
    """Returns ``step(model, opt_state, batch) -> (opt_state, metrics)``.
    The model's parameters are replaced in place by the AdamW update;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-dim tensors.

    ``accum_steps`` > 1 runs the batch as that many microbatches (the batch
    dim must divide): losses and grads summed in fp32, then divided by
    ``accum_steps``, as the reference's scan does."""
    if cross_pod_int8:
        raise ValueError("cross_pod_int8 requires a mesh with a 'pod' axis; "
                         "one card has none")

    def grads_of(model: Transformer, batch: Dict[str, Any]):
        names, leaves = zip(*model.named_parameters())
        if accum_steps == 1:
            loss = loss_fn(model, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(names, grads))
        dev = model.device
        batch = {key: _as_tensor(x, dev) for key, x in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} not divisible by accum_steps "
                             f"{accum_steps}")
        mb = n // accum_steps
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for p in leaves]
        for i in range(accum_steps):
            part = {key: x[i * mb:(i + 1) * mb] for key, x in batch.items()}
            loss = loss_fn(model, part, cfg)
            grads = torch.autograd.grad(loss, leaves)
            loss_acc = loss_acc + loss.detach()
            g_acc = torch._foreach_add(g_acc, [g.float() for g in grads])
        inv = 1.0 / accum_steps
        return loss_acc * inv, dict(zip(names, torch._foreach_mul(g_acc,
                                                                  inv)))

    def step(model: Transformer, opt_state: Dict[str, Any],
             batch: Dict[str, Any]):
        loss, grads = grads_of(model, batch)
        params = {name: p.detach() for name, p in model.named_parameters()}
        new, opt_state, metrics = adamw_update(params, grads, opt_state,
                                               opt_cfg)
        with torch.no_grad():
            torch._foreach_copy_(list(params.values()),
                                 [new[name] for name in params])
        metrics["loss"] = loss
        return opt_state, metrics

    return step
