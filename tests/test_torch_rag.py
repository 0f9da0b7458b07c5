"""The port's RAG serving path (``repro_torch.serving``) against the JAX
package, on tests/test_system.py's setups: the tiered context store with a
DSM ``merge`` (``test_openviking_rag_pipeline``) and per-request prompts
(``test_each_request_gets_its_own_prompt``).

Both packages get the same WIKI-Dir twin, payload tokens and (through
``models.convert``) the reference's own LM parameters, fp32 at smoke width.
Hit ids, scope sizes and assembled contexts must be equal, and the greedy
tokens of ``RAGServer.answer`` equal. Here on the CPU retrieval runs the
port's plain scan versions and decode attention kernel 10's plain version.
"""
from collections import Counter

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.datasets import make_wiki_dir  # noqa: E402
from repro.models import model_schema as jschema  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro.serving import rag as jrag  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import from_reference  # noqa: E402
from repro_torch.serving import rag  # noqa: E402


@pytest.fixture(scope="module")
def wiki():
    return make_wiki_dir(scale=0.001, dim=32, n_queries=10, seed=11)


def _lm(seed=0):
    jcfg = jsmoke("qwen3-0.6b").replace(vocab_size=256)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(seed), jcfg.param_dtype())
    cfg = smoke_config("qwen3-0.6b").replace(vocab_size=256)
    return jcfg, jp, cfg, from_reference(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")


def _stores(wiki, n, tiered, seed):
    """The same context entries in both packages' ContextDatabase."""
    jctx = jrag.ContextDatabase(dim=32)
    ctx = rag.ContextDatabase(dim=32, device="cpu")
    rng = np.random.default_rng(seed)
    for i in range(min(wiki.n_entries, n)):
        tier = ("L0", "L1", "L2")[i % 3] if tiered else "L0"
        toks = rng.integers(0, 200, size=8 + (i % 3) * 8 if tiered else 8)
        a = jctx.add_context(wiki.vectors[i], wiki.entry_paths[i], tier, toks)
        b = ctx.add_context(wiki.vectors[i], wiki.entry_paths[i], tier, toks)
        assert a == b
    jctx.build("flat")
    ctx.build("flat")
    return jctx, ctx


def _same_retrieval(jret, ret):
    for (jh, js), (h, s) in zip(jret, ret, strict=True):
        assert [e.entry_id for e in h] == [e.entry_id for e in jh]
        assert s["scope_size"] == js["scope_size"] and s["plan"] == js["plan"]


def test_rag_pipeline_matches_reference(wiki):
    """test_system.py:70's pipeline, including the DSM merge, through both
    packages: equal hits, scope sizes, contexts and answer tokens."""
    jctx, ctx = _stores(wiki, 300, tiered=True, seed=0)
    # this twin has one top-level directory (test_system.py then skips its
    # merge), so merge the second-fullest entry directory into the fullest
    (dst, n_dst), (src, n_src) = Counter(
        wiki.entry_paths[:300]).most_common(2)
    assert not (dst.startswith(src) or src.startswith(dst))
    for c in (jctx, ctx):
        c.reorganize("merge", src, dst)
        c.db.check_invariants()
    _, stats = ctx.retrieve(wiki.queries[0], dst, rag.RAGConfig(),
                            recursive=False)
    assert stats["scope_size"] == n_dst + n_src
    jcfg, jp, cfg, model = _lm()
    rcfg = jrag.RAGConfig(k=5, token_budget=48)
    jserver = jrag.RAGServer(jctx, jp, jcfg, rcfg)
    server = rag.RAGServer(ctx, model, cfg, rag.RAGConfig(k=5,
                                                          token_budget=48))
    scopes = ["/", "/", dst, dst.rsplit("/", 2)[0] + "/"]
    queries = wiki.queries[:4]
    _same_retrieval(jctx.retrieve_batch(queries, scopes, rcfg),
                    ctx.retrieve_batch(queries, scopes, server.cfg))
    for (jh, _), (h, _) in zip(jctx.retrieve_batch(queries, scopes, rcfg),
                               ctx.retrieve_batch(queries, scopes,
                                                  server.cfg)):
        np.testing.assert_array_equal(ctx.assemble(h, server.cfg),
                                      jctx.assemble(jh, rcfg))
    prompts = [np.arange(4, dtype=np.int32)]
    jout = jserver.answer(query_vecs=queries, scopes=scopes, prompts=prompts,
                          max_new_tokens=3)
    out = server.answer(query_vecs=queries, scopes=scopes, prompts=prompts,
                        max_new_tokens=3)
    assert out["tokens"].shape == (4, 3) and out["tokens"].dtype == np.int32
    np.testing.assert_array_equal(out["tokens"], jout["tokens"])
    for s, js in zip(out["retrieval_stats"], jout["retrieval_stats"]):
        assert s["scope_size"] == js["scope_size"] > 0
        assert set(s) == set(js)


def test_each_request_gets_its_own_prompt_matches_reference(wiki):
    """test_system.py:101's setup: each request ends with its own prompt,
    broadcast and empty prompts work, a prompt count that fits neither
    raises, and the answers equal the reference's."""
    jctx, ctx = _stores(wiki, 50, tiered=False, seed=2)
    jcfg, jp, cfg, model = _lm()
    jserver = jrag.RAGServer(jctx, jp, jcfg,
                             jrag.RAGConfig(k=3, token_budget=32))
    server = rag.RAGServer(ctx, model, cfg,
                           rag.RAGConfig(k=3, token_budget=32))
    prompts = [np.full(4, 7, np.int32), np.full(6, 9, np.int32)]
    retrieved = ctx.retrieve_batch(wiki.queries[:2], ["/", "/"], server.cfg)
    for i, (hits, _) in enumerate(retrieved):
        assembled = server.assemble_with_prompt(
            hits, server._prompt_for(prompts, i))
        np.testing.assert_array_equal(assembled[-len(prompts[i]):],
                                      prompts[i])
    assert len(server._prompt_for(prompts, 1)) == 6
    np.testing.assert_array_equal(server._prompt_for([prompts[0]], 1),
                                  prompts[0])
    assert server._prompt_for([], 1).size == 0
    out = server.answer(query_vecs=wiki.queries[:2], scopes=["/", "/"],
                        prompts=prompts, max_new_tokens=2)
    jout = jserver.answer(query_vecs=wiki.queries[:2], scopes=["/", "/"],
                          prompts=prompts, max_new_tokens=2)
    np.testing.assert_array_equal(out["tokens"], jout["tokens"])
    with pytest.raises(ValueError):
        server.answer(query_vecs=wiki.queries[:3], scopes=["/", "/", "/"],
                      prompts=prompts, max_new_tokens=1)


def test_ragged_batch_pads_as_content(wiki):
    """Contexts of different lengths: both packages right-pad with token 0
    and count the pad as content (prefill's length is the padded width), so
    the short row decodes exactly as its zero-padded context alone — and
    the port gives the reference's tokens."""
    _, ctx = _stores(wiki, 50, tiered=False, seed=4)
    jctx = jrag.ContextDatabase(dim=32)
    jcfg, jp, cfg, model = _lm(seed=5)
    jserver = jrag.RAGServer(jctx, jp, jcfg, jrag.RAGConfig())
    server = rag.RAGServer(ctx, model, cfg, rag.RAGConfig())
    rng = np.random.default_rng(9)
    short = rng.integers(1, 256, size=5).astype(np.int32)
    long = rng.integers(1, 256, size=13).astype(np.int32)
    got = server._decode_batch([short, long], 4)
    np.testing.assert_array_equal(got, jserver._decode_batch([short, long],
                                                             4))
    padded = np.concatenate([short, np.zeros(8, np.int32)])
    np.testing.assert_array_equal(got[0], server._decode_batch([padded],
                                                               4)[0])
    np.testing.assert_array_equal(got[1], server._decode_batch([long], 4)[0])


@pytest.mark.parametrize("name", ["deepseek-moe-16b",
                                  "llama4-scout-17b-a16e", "mamba2-130m",
                                  "hymba-1.5b", "phi-3-vision-4.2b"])
def test_decode_batch_every_token_only_family_matches_reference(wiki, name):
    """``RAGServer._decode_batch`` for each family whose prefill needs only
    tokens (MoE, SSM, hybrid with meta tokens, VLM without patches), at
    smoke width from the reference's parameters: the same greedy tokens as
    the reference's server on ragged contexts."""
    _, ctx = _stores(wiki, 20, tiered=False, seed=6)
    jcfg = jsmoke(name)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(1), jcfg.param_dtype())
    cfg = smoke_config(name)
    model = from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jserver = jrag.RAGServer(jrag.ContextDatabase(dim=32), jp, jcfg,
                             jrag.RAGConfig())
    server = rag.RAGServer(ctx, model, cfg, rag.RAGConfig())
    rng = np.random.default_rng(3)
    contexts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
                for n in (7, 12, 9)]
    np.testing.assert_array_equal(server._decode_batch(contexts, 4),
                                  jserver._decode_batch(contexts, 4))


def test_decode_batch_of_the_encoder_decoder_needs_frames(wiki):
    """Whisper's prefill needs ``frames``, which neither package's RAG
    server passes (the reference fails on the missing key): the port
    raises a ValueError that names them."""
    _, ctx = _stores(wiki, 20, tiered=False, seed=6)
    cfg = smoke_config("whisper-large-v3")
    from repro_torch.models import Transformer, init_params, model_schema
    model = Transformer(cfg, init_params(
        model_schema(cfg), torch.Generator().manual_seed(0),
        cfg.param_dtype(), "cpu"), device="cpu")
    server = rag.RAGServer(ctx, model, cfg, rag.RAGConfig())
    with pytest.raises(ValueError, match="frames"):
        server._decode_batch([np.arange(1, 6, dtype=np.int32)], 2)


def test_context_database_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        rag.ContextDatabase(dim=8)
    ctx = rag.ContextDatabase(dim=8, device="cpu")
    with pytest.raises(ValueError, match="tier"):
        ctx.add_context(np.zeros(8, np.float32), "/a/", "L9",
                        np.zeros(4, np.int32))
