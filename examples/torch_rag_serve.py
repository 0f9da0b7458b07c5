"""End-to-end driver of the PyTorch port: batched directory-scoped RAG
serving against a small LM.

    PYTHONPATH=src python examples/torch_rag_serve.py --requests 8 \
        --new-tokens 8                                   # on the card
    PYTHONPATH=src python examples/torch_rag_serve.py --device cpu

Pipeline per batch: TrieHI scope resolution -> scoped vector top-k -> tiered
context assembly (L0/L1/L2) -> batched prefill + greedy decode (kernel 10 in
every decode layer on a card). Also applies a DSM consolidation between
batches (agent memory reorganization) and shows retrieval following the new
namespace.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.datasets import make_wiki_dir
from repro_torch.models import Transformer, init_params, model_schema
from repro_torch.serving.rag import ContextDatabase, RAGConfig, RAGServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--contexts", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()

    dim = 64
    ds = make_wiki_dir(scale=0.002, dim=dim, n_queries=args.requests, seed=2)
    ctx = ContextDatabase(dim=dim, scope_strategy="triehi",
                          device=args.device)
    rng = np.random.default_rng(0)
    for i in range(min(args.contexts, ds.n_entries)):
        tier = ("L0", "L1", "L2")[i % 3]
        payload = rng.integers(0, 250, size=16 + 16 * (i % 3))
        ctx.add_context(ds.vectors[i], ds.entry_paths[i], tier, payload)
    ctx.build("flat")
    print(f"context DB: {args.contexts} tiered entries, "
          f"{len(ctx.db.namespaces['fs'].list_dirs())} directories")

    cfg = smoke_config("qwen3-0.6b").replace(vocab_size=256, n_layers=2)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = Transformer(cfg, init_params(model_schema(cfg), gen,
                                          cfg.param_dtype(), args.device),
                         device=args.device)
    server = RAGServer(ctx, params, cfg,
                       RAGConfig(k=6, token_budget=96, escalate_top=2))

    scopes = [ds.query_anchors[i % len(ds.query_anchors)] or "/"
              for i in range(args.requests)]
    t0 = time.time()
    out = server.answer(ds.queries[:args.requests], scopes,
                        prompts=[np.arange(4, dtype=np.int32)],
                        max_new_tokens=args.new_tokens)
    dt = time.time() - t0
    print(f"served {args.requests} requests x {args.new_tokens} tokens "
          f"in {dt:.2f}s (retrieve {out['retrieve_s']*1e3:.0f}ms, "
          f"decode {out['decode_s']*1e3:.0f}ms)")
    mean_dir = np.mean([s["directory_us"] for s in out["retrieval_stats"]])
    print(f"mean directory-only latency: {mean_dir:.0f}us; "
          f"first tokens: {out['tokens'][:, :4].tolist()}")

    # agent-memory consolidation between batches = DSM on the live store
    dirs = [d for d in ctx.db.namespaces["fs"].list_dirs() if len(d) == 1][:2]
    if len(dirs) == 2:
        src, dst = ("/" + dirs[0][0] + "/"), ("/" + dirs[1][0] + "/")
        ctx.reorganize("merge", src, dst)
        print(f"consolidated {src} into {dst}; re-serving against {dst}")
        out = server.answer(ds.queries[:2], [dst, dst],
                            prompts=[np.arange(4, dtype=np.int32)],
                            max_new_tokens=4)
        print("post-DSM scope sizes:",
              [s["scope_size"] for s in out["retrieval_stats"]])
    ctx.db.check_invariants()
    print("OK")


if __name__ == "__main__":
    main()
