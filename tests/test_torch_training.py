"""Training on the port (``repro_torch.training``, ``models.loss_fn``,
``models.attention.flash_attention``) against the JAX package, on the CPU.

The reference's own parameters (``init_params(..., PRNGKey)``, as numpy)
go through ``models.convert.from_reference`` into the port; batches come
from ``SyntheticLMData`` (numpy, seeded). Configs: ``smoke_config(
"qwen3-0.6b")`` fp32 (2 layers, d 64) and ``tests/test_training.py``'s
1-layer, d = 32 one. Tolerances, with their reasons (XLA:CPU and torch sum
the same products in other orders; nothing else differs):

* loss: rtol 1e-5 (observed <= 3e-7);
* gradients, and parameters after AdamW steps: per leaf, the largest
  difference within 1e-4 of the leaf's largest magnitude (observed
  <= 2.3e-6 for gradients, <= 6e-6 for parameters after 3 steps);
* ``schedule``, ``lr``: rtol 1e-6 (one fp32 rounding of pow / cos);
  ``grad_norm``: rtol 1e-5;
* attention outputs and gradients (``flash_attention`` against the
  reference's ``flash_attention`` and the port's ``naive_attention``): the
  sum of squares rtol 1e-5, gradients within 1e-4 of their largest
  magnitude (observed <= 2.6e-6).

Bitwise: ``SyntheticLMData.batch``, checkpoint round trips (fp32, bf16 and
int32 leaves), a run resumed from a checkpoint against the uninterrupted
run, and ``remat`` ``"full"`` / ``"dots"`` against ``"none"`` (the same
operations recomputed on the CPU).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import model_schema as jschema  # noqa: E402
from repro.models.attention import flash_attention as jflash  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import SyntheticLMData as JData  # noqa: E402
from repro.training.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.training.optimizer import adamw_update as jadamw  # noqa: E402
from repro.training.optimizer import init_opt_state as jinit_opt  # noqa: E402
from repro.training.optimizer import schedule as jschedule  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import (DSM, DSMExecutor, DSMJournal,  # noqa: E402
                              make_scope_index)
from repro_torch.models import (Transformer, forward_train,  # noqa: E402
                                from_reference, init_params, loss_fn,
                                model_schema, to_reference)
from repro_torch.models.attention import (flash_attention,  # noqa: E402
                                          naive_attention)
from repro_torch.training import (CheckpointManager, DataConfig,  # noqa: E402
                                  OptConfig, SyntheticLMData, adamw_update,
                                  init_opt_state, int8_compress,
                                  make_train_step, schedule)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_layers=1, d_model=32, d_ff=64, vocab_size=64, head_dim=8,
            n_kv_heads=2)
CONFIGS = {"smoke": {}, "tiny": TINY}
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4


def _configs(which, **kw):
    return (jsmoke("qwen3-0.6b").replace(**CONFIGS[which], **kw),
            smoke_config("qwen3-0.6b").replace(**CONFIGS[which], **kw))


def _pair(which, seed=0, **kw):
    """(reference cfg, reference params, port cfg, trainable port model)
    from the same reference parameters."""
    jcfg, cfg = _configs(which, **kw)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(seed), jcfg.param_dtype())
    model = from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, model.requires_grad_(True)


def _params(model):
    return {name: p.detach() for name, p in model.named_parameters()}


def _tree(named):
    """A port ``{name: tensor}`` dict (``layers.<i>.attn.wq``, ...) as the
    reference's stacked tree of fp32 numpy arrays."""
    tree, layers = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        a = t.detach().float().numpy()
        if parts[0] == "layers":
            layers.setdefault(tuple(parts[2:]), {})[int(parts[1])] = a
        else:
            tree[parts[0]] = a
    stacked = {}
    for path, per in layers.items():
        node = stacked
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([per[i] for i in sorted(per)])
    tree["layers"] = stacked
    return tree


def _close_leaves(got, want, label, tol=LEAF_TOL):
    """Every leaf within ``tol`` of the reference leaf's largest value."""
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl], label
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float32)
        err = np.abs(np.asarray(g, np.float32) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (
            label, jax.tree_util.keystr(path), err, np.abs(w).max())


def _batch(cfg, step=0, B=8, S=16, ignore=True):
    b = JData(JDataConfig(cfg.vocab_size, S, B)).batch(step)
    if ignore:
        b["labels"][0, :3] = -1               # ignored positions
    return b


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_loss_matches_reference(which, chunk):
    jcfg, jp, cfg, model = _pair(which, loss_chunk=chunk)
    b = _batch(cfg)
    want = float(jloss(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg))
    got = loss_fn(model, b, cfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_grads_match_reference(which, chunk):
    jcfg, jp, cfg, model = _pair(which, loss_chunk=chunk)
    b = _batch(cfg)
    jg = jax.grad(jloss)(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    loss_fn(model, b, cfg).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    _close_leaves(_tree(grads), jax.tree.map(np.asarray, jg), which)


def test_loss_chunking_matches():
    """Twin of ``tests/test_models.py::test_loss_chunking_matches``."""
    cfg = smoke_config("qwen2.5-3b")
    model = Transformer(cfg, init_params(
        model_schema(cfg), torch.Generator().manual_seed(4),
        cfg.param_dtype(), "cpu"), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tokens, "labels": tokens}
    l1 = loss_fn(model, batch, cfg)
    l2 = loss_fn(model, batch, cfg.replace(loss_chunk=4))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


def test_naive_attn_matches_flash_loss():
    """Twin of ``tests/test_models.py::test_naive_attn_matches_flash_loss``."""
    cfg = smoke_config("granite-8b")
    model = Transformer(cfg, init_params(
        model_schema(cfg), torch.Generator().manual_seed(3),
        cfg.param_dtype(), "cpu"), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tokens, "labels": tokens}
    l1 = loss_fn(model, batch, cfg)
    l2 = loss_fn(model, batch, cfg.replace(attn_impl="naive"))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_no_remat(remat):
    """``cfg.remat`` changes what is kept for the backward, never a bit of
    the loss or the gradients."""
    _, _, cfg, model = _pair("smoke")
    b = _batch(cfg)
    out = {}
    for mode in ("none", remat):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, b, cfg.replace(remat=mode))
        loss.backward()
        out[mode] = (loss.detach().clone(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    assert torch.equal(out["none"][0], out[remat][0])
    for name, g in out["none"][1].items():
        assert torch.equal(g, out[remat][1][name]), name


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("B,S,H,KV,hd,w,c", [
    (2, 130, 8, 2, 32, 0, 0),
    (1, 257, 4, 4, 16, 0, 0),
    (2, 100, 6, 2, 16, 17, 0),
    (1, 200, 4, 2, 32, 0, 64),
])
def test_flash_attention_fwd_bwd_matches_reference(B, S, H, KV, hd, w, c):
    """``tests/test_attention_variants.py::test_flash_fwd_bwd_matches_naive``'s
    grid: the port's flash forward and backward against the reference's
    ``flash_attention`` and against the port's ``naive_attention``."""
    rng = np.random.default_rng(B * 1000 + S)
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))

    def jlf(q, k, v):
        return jnp.sum(jflash(q, k, v, causal=True, window=w, chunk=c,
                              block_q=64, block_k=32) ** 2)

    want = float(jlf(q, k, v))
    jg = [np.asarray(g) for g in jax.grad(jlf, argnums=(0, 1, 2))(q, k, v)]
    for fn, kw in ((flash_attention, dict(block_q=64, block_k=32)),
                   (naive_attention, {})):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        loss = (fn(tq, tk, tv, causal=True, window=w, chunk=c, **kw) ** 2
                ).sum()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
        for t, g in zip((tq, tk, tv), jg):
            err = np.abs(t.grad.numpy() - g).max()
            assert err <= LEAF_TOL * np.abs(g).max(), (fn.__name__, err)


def test_flash_attention_blocks_do_not_change_the_function():
    """One block, ragged blocks and a long q_offset: the same outputs and
    gradients as the naive attention (bf16 inputs, fp32 scores)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(2, 70, n, 16)),
                            dtype=torch.bfloat16) for n in (4, 2, 2))
    outs = []
    for fn, kw in ((naive_attention, {}),
                   (flash_attention, dict(block_q=1024, block_k=1024)),
                   (flash_attention, dict(block_q=24, block_k=16))):
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*args, causal=True, window=0, chunk=0, **kw)
        assert out.dtype == torch.bfloat16
        out.float().square().sum().backward()
        outs.append([out.float()] + [a.grad.float() for a in args])
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert (a - b).abs().max() <= 2e-2 * b.abs().max()


# ------------------------------------------------------------------ AdamW
def test_schedule_matches_reference():
    for kw in (dict(), dict(warmup_steps=5, total_steps=60),
               dict(lr=1e-3, warmup_steps=1, total_steps=10,
                    min_lr_ratio=0.0)):
        jc, c = JOptConfig(**kw), OptConfig(**kw)
        steps = np.arange(0, c.total_steps + 3, max(1, c.total_steps // 97))
        want = np.asarray([float(jschedule(jc, jnp.asarray(s, jnp.int32)))
                           for s in steps])
        got = np.asarray([float(schedule(c, torch.tensor(int(s))))
                          for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """Three updates of fp32 and bf16 leaves (norm-like and matrices), the
    clip engaged (1.0) or not (100.0): parameters, moments, grad norm and
    lr against the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 3, 5)}
    dtypes = {"a": torch.float32, "b": torch.bfloat16, "c": torch.bfloat16}
    params = {n: torch.tensor(rng.normal(size=s), dtype=dtypes[n])
              for n, s in shapes.items()}
    jparams = {n: jnp.asarray(p.float().numpy()).astype(
        jnp.bfloat16 if p.dtype == torch.bfloat16 else jnp.float32)
        for n, p in params.items()}
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    state, jstate = init_opt_state(params), jinit_opt(jparams)
    for _ in range(3):
        grads = {n: torch.tensor(rng.normal(size=s) * 3, dtype=dtypes[n])
                 for n, s in shapes.items()}
        jgrads = {n: jnp.asarray(g.float().numpy()).astype(jparams[n].dtype)
                  for n, g in grads.items()}
        params, state, m = adamw_update(params, grads, state, cfg)
        jparams, jstate, jm = jadamw(jparams, jgrads, jstate, jcfg)
        assert int(state["step"]) == int(jstate["step"])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for n in shapes:
            assert params[n].dtype == dtypes[n]
            assert state["mu"][n].dtype == torch.float32
        _close_leaves({n: p.float().numpy() for n, p in params.items()},
                      jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   jparams), "params")
        for key in ("mu", "nu"):
            _close_leaves({n: t.numpy() for n, t in state[key].items()},
                          jax.tree.map(np.asarray, jstate[key]), key)


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_train_trajectory_matches_reference(which, accum):
    """Three steps of ``make_train_step`` against the reference's jitted
    one, from the same parameters on the same batches."""
    jcfg, jp, cfg, model = _pair(which)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, OptConfig(**opt), accum_steps=accum)
    jstep = jax.jit(jmake(jcfg, JOptConfig(**opt), accum_steps=accum))
    state, jstate = init_opt_state(_params(model)), jinit_opt(jp)
    for i in range(3):
        b = _batch(cfg, step=i, ignore=False)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(model, state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    _close_leaves(_tree(_params(model)), jax.tree.map(np.asarray, jp),
                  f"{which}/accum {accum}")


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-130m"])
def test_family_train_trajectory_matches_reference(name):
    """Three ``make_train_step`` steps of the MoE and SSM smoke configs
    (fp32) against the reference's jitted step, from the same parameters
    on the same batches: the routing, the capacity drops and the SSD scan
    differentiate as the reference's do. AdamW's ``eps`` is 1e-3, not
    1e-8: with 1e-8 its first update is ~lr * sign(g), so a gradient
    element within rounding of zero (|g| ~ 1e-6, the packages' difference)
    moves its parameter by +-lr in either package (observed: 2e-3 of the
    embedding's largest value after one step of mamba2); with eps above
    the rounding the update is smooth in g and the comparison holds the
    gradients, not their signs. deepseek's tolerances are wider (grad norm
    rtol 5e-4, leaves 1e-3 of their largest after 3 steps; observed
    3.2e-5, 1.1e-4, 1.1e-4 and 3.3e-4): without qk norm, on ``init_params``' std-0.71 stacked
    leaves, the attention's sharp softmax amplifies the packages'
    roundings in the gradients (the dense granite-8b smoke shows the same
    8.6e-5 of the largest gradient), while ``moe_apply``'s own gradients
    agree within 4e-7 (``tests/test_torch_ssm_moe.py``)."""
    grad_rtol, leaf_tol = {"deepseek-moe-16b": (5e-4, 1e-3)}.get(
        name, (1e-5, LEAF_TOL))
    jcfg, cfg = jsmoke(name), smoke_config(name)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(0), jcfg.param_dtype())
    model = from_reference(jax.tree.map(np.asarray, jp), cfg,
                           device="cpu").requires_grad_(True)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    step = make_train_step(cfg, OptConfig(**opt))
    jstep = jax.jit(jmake(jcfg, JOptConfig(**opt)))
    state, jstate = init_opt_state(_params(model)), jinit_opt(jp)
    for i in range(3):
        b = _batch(cfg, step=i, ignore=False)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(model, state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=grad_rtol)
    _close_leaves(to_reference(model), jax.tree.map(np.asarray, jp), name,
                  tol=leaf_tol)


def test_cross_pod_int8_needs_a_pod_axis():
    cfg = smoke_config("qwen3-0.6b")
    with pytest.raises(ValueError, match="pod"):
        make_train_step(cfg, OptConfig(), cross_pod_int8=True)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,vocab,seq,batch", [
    (1234, 0, 256, 16, 8), (1234, 37, 64, 32, 4), (7, 5, 128, 32, 4),
    (0, 1000, 151936, 8, 2)])
def test_data_batches_bitwise(seed, step, vocab, seq, batch):
    got = SyntheticLMData(DataConfig(vocab, seq, batch, seed=seed)).batch(step)
    want = JData(JDataConfig(vocab, seq, batch, seed=seed)).batch(step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------- twins of test_training
def _tiny():
    return smoke_config("qwen3-0.6b").replace(**TINY)


def _tiny_model(cfg, seed=0):
    return Transformer(cfg, init_params(
        model_schema(cfg), torch.Generator().manual_seed(seed),
        cfg.param_dtype(), "cpu"), device="cpu", trainable=True)


def test_loss_decreases_on_tiny_model():
    cfg = _tiny()
    model = _tiny_model(cfg)
    state = init_opt_state(_params(model))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, 32, 8))
    step = make_train_step(cfg, OptConfig(lr=3e-3, total_steps=60,
                                          warmup_steps=5))
    losses = []
    for i in range(60):
        state, m = step(model, state, data.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1, (
        losses[:5], losses[-5:])


def test_grad_accum_matches_big_batch():
    cfg = _tiny()
    data = SyntheticLMData(DataConfig(cfg.vocab_size, 16, 8))
    batch = data.batch(0)
    opt = OptConfig(lr=1e-3)
    out = {}
    for accum in (1, 4):
        model = _tiny_model(cfg)
        _, m = make_train_step(cfg, opt, accum_steps=accum)(
            model, init_opt_state(_params(model)), batch)
        out[accum] = (float(m["loss"]), _params(model))
    np.testing.assert_allclose(out[1][0], out[4][0], rtol=1e-3)
    for name, p in out[1][1].items():
        np.testing.assert_allclose(p.float().numpy(),
                                   out[4][1][name].float().numpy(),
                                   rtol=3e-2, atol=3e-4)


def test_data_determinism_and_structure():
    data = SyntheticLMData(DataConfig(vocab_size=128, seq_len=32,
                                      global_batch=4, seed=7))
    b1, b2 = data.batch(5), data.batch(5)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert np.array_equal(b1["labels"], b2["labels"])
    assert not np.array_equal(data.batch(6)["tokens"], b1["tokens"])
    # labels are next-token-shifted
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_checkpoint_atomicity_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"w": torch.arange(8, dtype=torch.float32),
             "nested": {"b": torch.ones((2, 3))}}
    for s in (1, 2, 3):
        mgr.save(s, state, extra={"loss": 0.5 * s})
    assert mgr.all_steps() == [2, 3]            # keep=2 GC'd step 1
    # a crashed save (tmp dir, no manifest) must be invisible
    (tmp_path / "step_0000000009.tmp").mkdir()
    (tmp_path / "step_0000000010").mkdir()      # no MANIFEST
    assert mgr.latest_step() == 3
    restored, step, extra = mgr.restore(state, device="cpu")
    assert step == 3 and extra["loss"] == 1.5
    assert torch.equal(restored["w"], state["w"])


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = {"w": torch.zeros(128)}
    mgr.save_async(7, state)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_dsm_journal_recovery(tmp_path):
    jpath = str(tmp_path / "dsm.journal")
    idx = make_scope_index("triehi")
    idx.insert(1, "/a/b/")
    idx.insert(2, "/c/")
    ex = DSMExecutor(idx, DSMJournal(jpath))
    ex.apply(DSM("move", "/a/b/", "/c/"))
    # simulate a crash: write a BEGIN with no COMMIT
    with open(jpath, "a") as f:
        f.write(json.dumps({"event": "begin", "seq": 99, "kind": "merge",
                            "src": "/a/", "dst": "/c/", "ts": 0}) + "\n")
    suspects = DSMJournal.recover(jpath)
    assert len(suspects) == 1
    assert suspects[0].kind == "merge" and suspects[0].src == "/a/"


def test_region_locks_serialize_overlaps():
    from repro_torch.core import paths as P
    from repro_torch.core.ops import RegionLockManager, regions_overlap
    assert regions_overlap([P.parse("/a/")], [P.parse("/a/b/")])
    assert not regions_overlap([P.parse("/a/")], [P.parse("/b/")])
    mgr = RegionLockManager()
    t1 = mgr.acquire([P.parse("/a/")])
    t2 = mgr.acquire([P.parse("/b/")])     # disjoint: no block
    mgr.release(t1)
    mgr.release(t2)


def test_int8_compression_roundtrip_accuracy():
    """The port's ``int8_compress`` on the reference test's vector: the
    error bound of its own math, and its bits equal that math in numpy."""
    g = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    scale = np.abs(g).max() / 127.0
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    rt = q.astype(np.float32) * scale
    assert np.abs(rt - g).max() <= scale * 0.5 + 1e-6
    got = int8_compress({"g": torch.from_numpy(g)})["g"].numpy()
    scale32 = np.float32(np.abs(g).max() / np.float32(127.0)
                         + np.float32(1e-12))
    want = np.clip(np.round(g / scale32), -127, 127).astype(
        np.float32) * scale32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - g).max() <= scale32 * 0.5 + 1e-6
    bf = int8_compress({"g": torch.from_numpy(g).bfloat16()})["g"]
    assert bf.dtype == torch.bfloat16


# ---------------------------------------------------- checkpoint and resume
def _state_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _state_equal(a[key], b[key])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_from_checkpoint_is_bitwise(tmp_path, dtype):
    """Train 6 steps, saving asynchronously at step 2 while training goes
    on; a fresh model and optimizer restore step 2 bit for bit, and steps
    3-5 give the uninterrupted run's losses bit for bit."""
    cfg = _tiny().replace(dtype=dtype)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, 16, 4))
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    step = make_train_step(cfg, opt)
    model = _tiny_model(cfg)
    state = init_opt_state(_params(model))
    mgr = CheckpointManager(tmp_path / "ckpt")
    losses, saved = [], None
    for i in range(6):
        state, m = step(model, state, data.batch(i))
        losses.append(m["loss"])
        if i == 2:
            snap = {"params": _params(model), "opt": state}
            saved = jax.tree.map(lambda t: t.clone(), snap)
            mgr.save_async(i, snap)
    mgr.wait()
    fresh = _tiny_model(cfg, seed=1)
    params = _params(fresh)
    restored, at, _ = mgr.restore({"params": params,
                                   "opt": init_opt_state(params)},
                                  device="cpu")
    assert at == 2
    _state_equal(restored, saved)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(restored["params"][name])
    state = restored["opt"]
    for i in range(3, 6):
        state, m = step(fresh, state, data.batch(i))
        assert torch.equal(m["loss"], losses[i]), i


def test_trainable_model_roundtrips_convert():
    """A trained model goes to the reference's stacked tree and back
    unchanged, and the reference's loss on that tree equals the port's."""
    jcfg, jp, cfg, model = _pair("smoke")
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1))
    step(model, init_opt_state(_params(model)), _batch(cfg, ignore=False))
    tree = to_reference(model)
    back = from_reference(tree, cfg, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a.detach(), b), n
    b = _batch(cfg, step=1)
    want = float(jloss(jax.tree.map(jnp.asarray, tree),
                       {k: jnp.asarray(v) for k, v in b.items()}, jcfg))
    np.testing.assert_allclose(float(loss_fn(back, b, cfg)), want,
                               rtol=LOSS_RTOL)
    assert not any(p.requires_grad for p in back.parameters())
    assert forward_train(model, b["tokens"], cfg).requires_grad


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(ValueError, match="model-parallel"):
        train.main(["--smoke", "--steps", "1", "--device", "cpu",
                    "--model-parallel", "2"])
    mgr = CheckpointManager(Path(os.environ.get("TMPDIR", "/tmp"))
                            / f"repro_torch_ckpt_{os.getpid()}")
    try:
        mgr.save(0, {"w": torch.zeros(2)})
        with pytest.raises(RuntimeError, match="CUDA"):
            mgr.restore({"w": torch.zeros(2)})
    finally:
        import shutil
        shutil.rmtree(mgr.dir, ignore_errors=True)


def _losses(text):
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) > 3 and parts[0] == "step" and parts[2] == "loss":
            out[int(parts[1])] = parts[3]
    return out


def test_launcher_resumes_after_kill(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` killed
    after a checkpoint, then run again: it resumes at the newest manifested
    step + 1 and logs the killed run's losses for the steps both ran."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--device", "cpu", "--steps", "40", "--batch", "4", "--seq",
           "32", "--ckpt-dir", str(ckpt), "--ckpt-every", "3",
           "--log-every", "1"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    mgr = CheckpointManager(ckpt)
    deadline = time.monotonic() + 120
    try:
        while (mgr.latest_step() or 0) < 3:
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "no checkpoint in 120 s"
            time.sleep(0.02)
    finally:
        proc.kill()
        first, err = proc.communicate(timeout=60)
    saved = mgr.latest_step()
    assert "done" not in first.split(), "the run ended before the kill"
    second = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stderr
    assert f"restored checkpoint, resuming at step {saved + 1}" \
        in second.stdout
    before, after = _losses(first), _losses(second.stdout)
    assert min(after) == saved + 1 and max(after) == 39
    shared = sorted(set(before) & set(after))
    for s in shared:
        assert before[s] == after[s], (s, before[s], after[s])


def test_launcher_trains_mamba2_smoke():
    """``python -m repro_torch.launch.train --arch mamba2-130m --smoke
    --device cpu`` runs to its end: the SSM config trains through the
    launcher, every logged loss finite."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "6",
         "--batch", "4", "--seq", "32", "--log-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=mamba2-130m" in out.stdout and "done" in out.stdout.split()
    losses = _losses(out.stdout)
    assert sorted(losses) == list(range(6))
    assert all(np.isfinite(float(v)) for v in losses.values())
