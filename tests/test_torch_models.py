"""The port's LM stack (``repro_torch.models``) against the JAX package.

The reference's own parameters (``init_params(..., PRNGKey)``, as numpy)
go through ``repro_torch.models.convert.from_reference`` into the port, and
the same numpy-seeded tokens through both packages' ``prefill`` and
``decode_step``. Here on the CPU decode attention runs kernel 10's plain
version. Tolerances, with their reasons:

* fp32 logits rtol = atol = 1e-4: XLA:CPU and torch sum the matmuls in
  other orders (observed <= 1.5e-5 over 2 layers);
* fp32 caches rtol = atol = 1e-4 (keys/values of magnitude up to ~5,
  observed <= 7e-5);
* bf16 logits atol = 3e-2 and caches within 2e-2 of their largest
  magnitude: each package rounds every layer's activations to bf16 on its
  own (2^-8 relative), and a layer's keys and values inherit the earlier
  layers' roundings; observed <= 7.5e-3 on logits below 1 and <= 0.9% of
  the largest value (0.19 of values up to ~22) in layer 1's cache.

Greedy tokens are compared tie-aware: where the two argmaxes differ, the
reference's top-2 logits must lie within the logit tolerance (a near tie
that rounding may flip); the position is reported and both go on
teacher-forced with the reference's token.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import model_schema as jschema  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.models import (Transformer, decode_step, forward,  # noqa: E402
                                from_reference, init_params,
                                logits_from_hidden, model_schema, prefill,
                                to_reference)
from repro_torch.models.layers import schema_leaves  # noqa: E402

DENSE = ["qwen3-0.6b", "qwen2.5-3b", "granite-8b", "minitron-4b"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}  # logits, caches


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _pair(name, dtype="float32", seed=0):
    """(reference cfg, params) and the port's cfg and model from the same
    reference parameters."""
    jcfg = jsmoke(name).replace(dtype=dtype)
    cfg = smoke_config(name).replace(dtype=dtype)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(seed), jcfg.param_dtype())
    model = from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, model


def _same_token(jl, pl, tol, label, step, ties):
    """Tie-aware greedy agreement; returns the reference's token."""
    jl, pl = _f32(jl)[:, -1], _f32(pl)[:, -1]
    jt, pt = jl.argmax(-1), pl.argmax(-1)
    for row in np.flatnonzero(jt != pt):
        top2 = np.sort(jl[row])[-2:]
        assert top2[1] - top2[0] <= tol, (
            f"{label} step {step} row {row}: tokens {pt[row]} vs {jt[row]}, "
            f"reference top-2 gap {top2[1] - top2[0]:.3g} > {tol}")
        ties.append((step, int(row)))
    return jt[:, None].astype(np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_match_reference(name):
    """Prefill logits and caches, three teacher-forced decode steps, then
    greedy tokens, against the reference at smoke width, fp32."""
    jcfg, jp, cfg, model = _pair(name)
    ltol, ctol = TOL["float32"]
    rng = np.random.default_rng(7)
    B, S, steps = 3, 10, 3
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    cache_seq = S + 2 * steps + 1
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, cache_seq)
    pl, pc = prefill(model, {"tokens": toks}, cfg, cache_seq)
    np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=ltol, atol=ltol)
    np.testing.assert_array_equal(pc["len"].numpy(), np.asarray(jc["len"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(pc[key]), _f32(jc[key]), rtol=ctol,
                                   atol=ctol, err_msg=key)
    for step in range(steps):                        # teacher-forced
        nxt = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt), jcfg)
        pl, pc = decode_step(model, pc, nxt, cfg)
        np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=ltol, atol=ltol,
                                   err_msg=f"decode step {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(_f32(pc[key]), _f32(jc[key]),
                                       rtol=ctol, atol=ctol, err_msg=key)
    ties = []                                        # greedy
    cur = _same_token(jl, pl, ltol, name, 0, ties)
    for step in range(1, steps + 1):
        jl, jc = jdecode(jp, jc, jnp.asarray(cur), jcfg)
        pl, pc = decode_step(model, pc, cur, cfg)
        cur = _same_token(jl, pl, ltol, name, step, ties)
    if ties:
        warnings.warn(f"{name}: near-tie argmax flips at {ties}")


def test_prefill_decode_bf16_matches_reference():
    """qwen3-0.6b at bf16 (the card's type), looser tolerances."""
    jcfg, jp, cfg, model = _pair("qwen3-0.6b", "bfloat16", seed=3)
    ltol, ctol = TOL["bfloat16"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24)
    pl, pc = prefill(model, {"tokens": toks}, cfg, 24)
    assert pc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=0, atol=ltol)
    for key in ("k", "v"):
        want = _f32(jc[key])
        np.testing.assert_allclose(_f32(pc[key]), want, rtol=0,
                                   atol=ctol * np.abs(want).max(),
                                   err_msg=key)
    ties = []
    cur = _same_token(jl, pl, ltol, "bf16", 0, ties)
    for step in range(1, 4):
        jl, jc = jdecode(jp, jc, jnp.asarray(cur), jcfg)
        pl, pc = decode_step(model, pc, cur, cfg)
        np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=0, atol=ltol)
        cur = _same_token(jl, pl, ltol, "bf16", step, ties)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen2.5-3b"])
def test_prefill_decode_matches_full_forward(name):
    """Within the port: greedy decode from a prefix equals the full
    forward's logits (tests/test_models.py:57's check), so the kernel path
    and the prefill path are the same function."""
    cfg = smoke_config(name)
    g = torch.Generator().manual_seed(1)
    model = Transformer(cfg, init_params(model_schema(cfg), g,
                                         cfg.param_dtype(), "cpu"),
                        device="cpu")
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    h, _ = forward(model, toks, cfg)
    full = logits_from_hidden(model, h, cfg)
    lp, cache = prefill(model, {"tokens": toks[:, :-1]}, cfg, S + 2)
    torch.testing.assert_close(lp[:, 0], full[:, S - 2], rtol=1e-5,
                               atol=1e-5)
    ld, cache = decode_step(model, cache, toks[:, -1:], cfg)
    torch.testing.assert_close(ld[:, 0], full[:, S - 1], rtol=1e-5,
                               atol=1e-5)
    assert cache["len"].tolist() == [S, S]
    _, (kv, _, _) = forward(model, toks, cfg, collect_cache=True)
    torch.testing.assert_close(cache["k"][:, :, :, :S], kv[0], rtol=1e-5,
                               atol=1e-5)


def test_convert_round_trip_and_shape_check():
    jcfg, jp, cfg, model = _pair("qwen2.5-3b")
    tree = jax.tree.map(np.asarray, jp)
    back = to_reference(model)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        from_reference(bad, cfg, device="cpu")


def test_full_width_qwen3_parameter_count():
    """The full-width qwen3-0.6b, counted from the schema the port builds
    its model from (no allocation), equals the reference schema's count.
    ``ArchConfig.param_count()`` (a copy of the reference's accounting)
    counts the final norm twice, so it is d_model more than the model
    holds (ROADMAP queue 3)."""
    cfg = get_arch("qwen3-0.6b")
    count = sum(int(np.prod(s.shape))
                for s in schema_leaves(model_schema(cfg)))
    jcount = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jschema(cfg), is_leaf=lambda x: hasattr(x, "init")))
    assert count == jcount == 596_049_920
    assert cfg.param_count() == count + cfg.d_model == 596_050_944
    small = smoke_config("qwen3-0.6b")
    model = Transformer(small, init_params(
        model_schema(small), torch.Generator().manual_seed(0),
        small.param_dtype(), "cpu"), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in schema_leaves(model_schema(small)))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-130m",
                                  "whisper-large-v3"])
def test_unported_families_raise(name):
    cfg = smoke_config(name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_schema(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(cfg, {}, device="cpu")


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = smoke_config("qwen3-0.6b")
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(model_schema(cfg), g, cfg.param_dtype())
    params = init_params(model_schema(cfg), g, cfg.param_dtype(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(cfg, params)
