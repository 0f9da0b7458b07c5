"""Serving launcher: open-loop directory-scoped RAG under continuous batching
(the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 --qps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Requests arrive on a seeded Poisson process at ``--qps`` and are submitted
asynchronously to the :class:`~repro_torch.serving.RAGServer` scheduler,
which coalesces them into device batches under the latency SLO (flush at
``--batch`` requests or when the oldest request has waited ``--slo-ms``).
Each request carries its own prompt tokens. Latency is measured from the
*scheduled* arrival time, so a slow service cannot suppress the arrivals
that would have exposed it (coordinated-omission-safe).

``--smoke`` serves the reference's set-up: the smoke config with a
256-token vocabulary over WIKI-Dir at d = 64. Without it the model is the
full-width config (bf16) over WIKI-Dir at d = 128, its parameters drawn
from ``torch.Generator`` seed 0. Either way the dataset is WIKI-Dir at
scale 0.003 with ``--contexts`` entries ingested, unless the caller of
:func:`build` hands in a context database. ``--device cuda`` (the default)
raises without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import get_arch, smoke_config
from ..device import resolve_device
from ..models import Transformer, init_params, model_schema
from ..serving import AdmissionError, SchedulerConfig, open_loop_arrivals
from ..serving.rag import TIERS, ContextDatabase, RAGConfig, RAGServer

SCALE = 0.003              # WIKI-Dir scale of the launcher's own dataset
PAYLOAD_VOCAB = 250        # payload and prompt tokens lie below this


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--qps", type=float, default=4.0,
                    help="target offered load (Poisson arrival rate)")
    ap.add_argument("--batch", type=int, default=4,
                    help="scheduler max batch size")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="max wait before a partial batch is flushed")
    ap.add_argument("--queue-capacity", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--contexts", type=int, default=600)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--scope-strategy", default="triehi",
                    choices=["triehi", "pe_online", "pe_offline"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's reduced model and d = 64 dataset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def model_config(args):
    """The served config: the smoke config with a 256-token vocabulary, or
    the full-width one (bf16, as every registered config is)."""
    if args.smoke:
        return smoke_config(args.arch).replace(vocab_size=256)
    return get_arch(args.arch)


def build(args, ctx: Optional[ContextDatabase] = None, params=None,
          ds=None) -> SimpleNamespace:
    """Everything :func:`serve` needs, warmed up: the context database
    (``ctx``, with the dataset ``ds`` whose queries and anchors the
    requests use; built here from WIKI-Dir when None), the model
    (``params``, a :class:`~repro_torch.models.Transformer`; drawn from
    ``torch.Generator`` seed 0 when None), the server, and each request's
    query, scope and prompt. One synchronous answer of the first two
    requests runs before anything is timed, so the kernel build and first
    launches land outside the serving window. Returns a namespace with
    ``server``, ``ds``, ``queries``, ``scopes``, ``prompts``, ``cfg``,
    ``device`` and the set-up times."""
    dev = resolve_device(args.device)
    cfg = model_config(args)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if ctx is None:
        from ..datasets import make_wiki_dir
        dim = 64 if args.smoke else 128
        ds = make_wiki_dir(scale=SCALE, dim=dim, n_queries=args.requests,
                           seed=args.seed)
        ctx = ContextDatabase(dim=dim, scope_strategy=args.scope_strategy,
                              device=dev)
        for i in range(min(args.contexts, ds.n_entries)):
            ctx.add_context(ds.vectors[i], ds.entry_paths[i], TIERS[i % 3],
                            rng.integers(0, PAYLOAD_VOCAB,
                                         size=16 + 16 * (i % 3)))
        ctx.build("flat")
    elif ds is None:
        raise ValueError("a context database handed in needs its dataset "
                         "(ds=) for the requests' queries and scopes")
    if args.requests > len(ds.queries):
        raise ValueError(f"{args.requests} requests for the dataset's "
                         f"{len(ds.queries)} queries")
    ctx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = Transformer(cfg, init_params(model_schema(cfg), gen,
                                              cfg.param_dtype(), dev),
                             device=dev)
    model_s = time.perf_counter() - t0
    server = RAGServer(ctx, params, cfg,
                       RAGConfig(k=6, token_budget=96, escalate_top=2))
    n = args.requests
    queries = np.asarray(ds.queries[:n])
    scopes = [a or "/" for a in ds.query_anchors[:n]]
    # each simulated request gets its own prompt (varying length and
    # content), so per-request prompt handling is exercised end to end
    prompts = [rng.integers(0, PAYLOAD_VOCAB, size=int(rng.integers(2, 12)))
               for _ in range(n)]
    t0 = time.perf_counter()
    n_warm = min(2, n)
    server.answer(queries[:n_warm], scopes[:n_warm],
                  prompts=prompts[:n_warm], max_new_tokens=args.new_tokens)
    warm_s = time.perf_counter() - t0
    return SimpleNamespace(server=server, ds=ds, queries=queries,
                           scopes=scopes, prompts=prompts, cfg=cfg,
                           device=dev, ctx_s=ctx_s, model_s=model_s,
                           warm_s=warm_s)


def card(device) -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` gives them (None
    for a CPU run, or where ``nvidia-smi`` cannot be read)."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, _, power = line.rpartition(", ")
        return {"name": name, "power_limit": power}
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"name": torch.cuda.get_device_name(0), "power_limit": None}


def serve(server: RAGServer, queries: np.ndarray, scopes: Sequence[str],
          prompts: Sequence[np.ndarray], *, qps: float, max_batch: int,
          slo_ms: float, queue_capacity: int, new_tokens: int, seed: int,
          timeout_s: float = 120.0) -> Dict[str, object]:
    """Offer the requests open-loop at ``qps`` and wait for every answer.
    Request i is submitted at ``t0 + offsets[i]`` and its latency runs
    from that scheduled arrival. Returns the serving numbers and, per
    request, ``served`` (``index``, ``tokens``, ``hits``, ``scope_size``,
    ``batch_size``, ``latency_ms``), plus ``shed`` and ``failed`` (index,
    error)."""
    n = len(scopes)
    server.start(SchedulerConfig(max_batch=max_batch, max_wait_ms=slo_ms,
                                 queue_capacity=queue_capacity),
                 max_new_tokens=new_tokens)
    tickets, shed, failed, served = [], [], [], []
    try:
        offsets = open_loop_arrivals(qps, n, seed=seed)
        t0 = time.perf_counter()
        for i in range(n):
            now = time.perf_counter() - t0
            if offsets[i] > now:
                time.sleep(offsets[i] - now)
            try:
                tickets.append((i, server.submit(
                    queries[i], scopes[i], prompt=prompts[i],
                    t_arrival=t0 + offsets[i])))
            except AdmissionError:
                shed.append(i)
        for i, t in tickets:
            try:
                r = t.result(timeout=timeout_s)
            except Exception as e:          # noqa: BLE001 - counted, shown
                failed.append((i, f"{type(e).__name__}: {e}"))
                continue
            served.append({"index": i, "tokens": np.asarray(r["tokens"]),
                           "hits": [h.entry_id for h in r["hits"]],
                           "scope_size": r["retrieval_stats"]["scope_size"],
                           "batch_size": t.batch_size,
                           "latency_ms": t.latency_s * 1e3})
        wall = time.perf_counter() - t0
        stats = server.serving_stats()
    finally:
        server.stop()
    lat = [s["latency_ms"] for s in served]
    return {"requests": n, "served": len(served), "shed": len(shed),
            "failed": len(failed), "errors": failed[:5],
            "offered_qps": qps, "achieved_qps": stats["qps"], "wall_s": wall,
            "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
            "p99_ms": stats["p99_ms"],
            "max_ms": max(lat) if lat else float("nan"),
            "batches": stats["batches"], "mean_batch": stats["mean_batch"],
            "occupancy": stats["occupancy"],
            "queue_mean_ms": stats["queue_mean_ms"],
            "mean_scope": (float(np.mean([s["scope_size"] for s in served]))
                           if served else float("nan")),
            "results": served}


def main(argv=None, ctx: Optional[ContextDatabase] = None, params=None,
         ds=None) -> Dict[str, object]:
    """Build, serve and print the reference's three summary lines; returns
    :func:`serve`'s numbers with the card and the set-up times."""
    args = parse_args(argv)
    b = build(args, ctx=ctx, params=params, ds=ds)
    out = serve(b.server, b.queries, b.scopes, b.prompts, qps=args.qps,
                max_batch=args.batch, slo_ms=args.slo_ms,
                queue_capacity=args.queue_capacity,
                new_tokens=args.new_tokens, seed=args.seed)
    out.update(card=card(b.device), arch=b.cfg.name, dtype=b.cfg.dtype,
               smoke=args.smoke, ctx_s=b.ctx_s, model_s=b.model_s,
               warm_s=b.warm_s)
    print(f"served {out['served']}/{args.requests} requests "
          f"(shed {out['shed']}, failed {out['failed']}) at offered "
          f"{args.qps:.1f} qps, achieved {out['achieved_qps']:.1f} qps")
    print(f"latency from scheduled arrival: "
          f"p50 {out['p50_ms']:.0f} ms  p95 {out['p95_ms']:.0f} ms  "
          f"p99 {out['p99_ms']:.0f} ms  max {out['max_ms']:.0f} ms")
    print(f"batches {out['batches']} "
          f"(mean occupancy {out['occupancy']:.2f}, "
          f"mean queue wait {out['queue_mean_ms']:.0f} ms), "
          f"mean scope={out['mean_scope']:.0f}; card {out['card']['name']} "
          f"{out['card']['power_limit'] or ''}".rstrip())
    return out


__all__ = ["parse_args", "model_config", "build", "serve", "card", "main"]


if __name__ == "__main__":
    main()
