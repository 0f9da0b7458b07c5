"""OpenViking-style agent context database (§IV-C) on the PyTorch port:
viking:// filesystem organization over memories / resources / skills,
tiered L0/L1/L2 loading, directory-recursive retrieval, and namespace
maintenance.

    PYTHONPATH=src python examples/torch_openviking_context.py   # on the card
    PYTHONPATH=src python examples/torch_openviking_context.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.serving.rag import ContextDatabase, RAGConfig

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without a card) or cpu")
DEVICE = ap.parse_args().device

rng = np.random.default_rng(0)
DIM = 48

ctx = ContextDatabase(dim=DIM, scope_strategy="triehi", device=DEVICE)

# viking://user/{memories,resources,skills}/... namespace
corpus = []
for kind, n in (("memories", 40), ("resources", 30), ("skills", 10)):
    for i in range(n):
        proj = f"proj{i % 3}"
        path = f"/user/{kind}/{proj}/"
        for tier, length in (("L0", 8), ("L1", 24), ("L2", 96)):
            v = rng.normal(size=DIM).astype(np.float32)
            v /= np.linalg.norm(v)
            eid = ctx.add_context(v, path, tier,
                                  rng.integers(0, 250, size=length))
            corpus.append((eid, path, tier))
ctx.build("flat")
print(f"viking:// store: {len(corpus)} tiered entries")

cfg = RAGConfig(k=8, token_budget=128, escalate_top=2)
q = rng.normal(size=DIM).astype(np.float32)

# directory-recursive retrieval: project scope, then skill scope
for scope in ("/user/memories/proj0/", "/user/skills/", "/user/"):
    hits, stats = ctx.retrieve(q, scope, cfg)
    tiers = [h.tier for h in hits]
    toks = ctx.assemble(hits, cfg)
    print(f"scope {scope:26s} scope_size={stats['scope_size']:4.0f} "
          f"dir={stats['directory_us']:6.1f}us tiers={tiers[:6]} "
          f"context_tokens={len(toks)}")

# lifecycle: archive proj2 memories, then consolidate proj1 into proj0
ctx.db.mkdir("/user/archive/")
ctx.reorganize("move", "/user/memories/proj2/", "/user/archive/")
ctx.reorganize("merge", "/user/memories/proj1/", "/user/memories/proj0/")
hits, stats = ctx.retrieve(q, "/user/memories/proj0/", cfg)
print(f"after MOVE+MERGE: proj0 scope={stats['scope_size']:.0f}")
hits, stats = ctx.retrieve(q, "/user/archive/", cfg)
print(f"archive scope={stats['scope_size']:.0f}")
# exclusion: everything except archive
ex = ctx.db.dsq(q, "/user/", k=5, exclude=["/user/archive/"])
print(f"/user/ minus archive scope={ex.scope_size}")
ctx.db.check_invariants()
print("OK")
