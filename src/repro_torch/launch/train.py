"""Training launcher on one card: checkpoint-restart, deterministic data
replay, async saves (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 50 --ckpt-dir build/ckpt --device cpu

Restart semantics: on start the launcher restores the newest manifested
checkpoint and resumes at step+1 with bitwise the same batches (data is a
pure function of the step). Steps are timed on the host after the loss is
read back (which waits for the device); a step slower than three times the
rolling p95 of the last 20 is flagged as a straggler. ``--model-parallel``
other than 1 raises: one card has no mesh to split the model over.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_arch, smoke_config
from ..device import resolve_device
from ..models import Transformer, init_params, model_schema
from ..training.checkpoint import CheckpointManager
from ..training.data import DataConfig, SyntheticLMData
from ..training.optimizer import OptConfig, init_opt_state
from ..training.train_step import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build(cfg, device, seed: int = 0):
    """A trainable model drawn from ``torch.Generator`` seed ``seed`` on
    ``device``, its parameter dict (``{name: tensor}``, the tensors the
    model trains in place) and a fresh optimizer state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, init_params(model_schema(cfg), gen,
                                         cfg.param_dtype(), device),
                        device=device, trainable=True)
    params = {name: p.detach() for name, p in model.named_parameters()}
    return model, params, init_opt_state(params)


def restore(ckpt: CheckpointManager, params, opt_state, device,
            step: Optional[int] = None):
    """Load checkpoint ``step`` (the newest manifested one when None) into
    ``params`` in place; returns (its optimizer state, its step)."""
    state, step, _ = ckpt.restore({"params": params, "opt": opt_state},
                                  step=step, device=device)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["params"][name])
    return state["opt"], step


def train(model, opt_state, step_fn, data: SyntheticLMData, steps: range,
          device, params=None, ckpt: Optional[CheckpointManager] = None,
          ckpt_every: int = 25, log_every: int = 10,
          last: Optional[int] = None, log=print):
    """Run ``step_fn`` on ``data.batch(step)`` for every step of ``steps``.
    Each step's host time runs from the call to the loss read back (which
    waits for the device); a step slower than 3x the rolling p95 of the
    last 20 is flagged. With ``ckpt`` (and ``params``), the state is saved
    asynchronously every ``ckpt_every`` steps and at step ``last``.
    Returns (opt_state, one record per step: step, loss, grad_norm, lr,
    s)."""
    last = steps[-1] if last is None and len(steps) else last
    times, records = [], []
    for step in steps:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        records.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "s": dt})
        times.append(dt)
        if len(times) > 20:
            times.pop(0)
        p95 = float(np.percentile(times, 95))
        if dt > 3 * p95 and len(times) >= 10:
            log(f"[straggler-warning] step {step}: {dt:.2f}s vs p95 "
                f"{p95:.2f}s — drain candidate")
        if step % log_every == 0 or step == last:
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {records[-1]['grad_norm']:.3f} "
                f"lr {records[-1]['lr']:.2e} {dt*1e3:.0f}ms")
        if ckpt and (step % ckpt_every == 0 or step == last):
            ckpt.save_async(step, {"params": params, "opt": opt_state})
    return opt_state, records


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.model_parallel != 1:
        raise ValueError(f"--model-parallel {args.model_parallel}: one card "
                         "runs the whole model (1 only)")
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count():,} device={dev}")

    model, params, opt_state = build(cfg, dev, seed=0)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 10))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, args.seq, args.batch))
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=args.accum)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            opt_state, start = restore(ckpt, params, opt_state, dev)
            start += 1
            print(f"restored checkpoint, resuming at step {start}")

    train(model, opt_state, step_fn, data, range(start, args.steps), dev,
          params=params, ckpt=ckpt, ckpt_every=args.ckpt_every,
          log_every=args.log_every, last=args.steps - 1,
          log=lambda line: print(line, flush=True))
    if ckpt:
        ckpt.wait()
    print("done")


if __name__ == "__main__":
    main()
