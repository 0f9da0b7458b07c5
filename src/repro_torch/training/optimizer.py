"""AdamW + cosine schedule + global-norm clipping on tensors (the port of
``repro/training/optimizer.py:17-84``, formula for formula).

Moments are kept in float32 whatever the parameter dtype, and the state
mirrors the parameter dict (``{name: tensor}``, as
``dict(model.named_parameters())`` gives it). The update is computed in fp32
and cast to each parameter's dtype; weight decay applies to every leaf,
norms included. ``torch.optim.AdamW`` is not used: its decoupled decay and
its in-place bf16 arithmetic round differently from the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine down to
    ``cfg.lr * cfg.min_lr_ratio`` at ``total_steps`` (fp32, on ``step``'s
    device)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """fp32 zero moments ``mu`` / ``nu`` per parameter and ``step`` (a
    0-dim int32 tensor on the parameters' device)."""
    device = next(iter(params.values())).device

    def zeros() -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in params.items()}
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of the fp32 sum of squares."""
    return _norm([x.float() for x in tree.values()])


def _norm(xs: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack([(x * x).sum() for x in xs]).sum())


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: Dict[str, Any],
                 cfg: OptConfig) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, Any], Dict[str, Any]]:
    """Returns (new_params, new_state, metrics) without touching its
    arguments; ``metrics`` holds ``grad_norm`` and ``lr`` (0-dim tensors
    on the device, so the step never waits for the host)."""
    names = list(params)
    p = [params[n] for n in names]
    step = state["step"] + 1
    g32 = [grads[n].float() for n in names]
    gnorm = _norm(g32)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    g = mul(g32, scale)
    mu = add(mul([state["mu"][n] for n in names], cfg.b1),
             mul(g, 1 - cfg.b1))
    nu = add(mul([state["nu"][n] for n in names], cfg.b2),
             mul(mul(g, 1 - cfg.b2), g))
    mhat = div(mu, b1c)
    vhat = div(nu, b2c)
    p32 = [x.float() for x in p]
    delta = add(div(mhat, add(torch._foreach_sqrt(vhat), cfg.eps)),
                mul(p32, cfg.weight_decay))
    new = torch._foreach_sub(p32, mul(delta, lr))
    new_p = {n: x.to(old.dtype) for n, x, old in zip(names, new, p)}
    new_state = {"mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)),
                 "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
