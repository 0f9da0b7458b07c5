"""The port's Mamba-2 SSD mixer and MoE FFN (``repro_torch.models.ssm`` /
``moe``): twins of tests/test_ssm_moe.py's checks on the port alone, then
the same numpy-seeded inputs (and the reference's own parameters) through
both packages.

Tolerances, with their reasons:

* the twins keep tests/test_ssm_moe.py's (2e-4 for the chunked scan
  against a sequential recurrence and across chunk sizes, 2e-3 for the
  mixer against its incremental decode);
* cross-package fp32: within 1e-4 of the largest magnitude of the
  reference's output (XLA:CPU and torch sum the einsums and products in
  other orders; observed <= 2e-6 relative);
* routing is exact: the top-k expert indices, the stable hit order and
  the capacity keep-mask equal the reference's element for element,
  including rows whose routing probabilities tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.common import ArchConfig as JArchConfig  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.common import ArchConfig  # noqa: E402
from repro_torch.models.layers import init_params  # noqa: E402

RNG = np.random.default_rng(0)
REL = 1e-4


def _ssm_kw(**kw):
    base = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
                d_ff=0, vocab_size=100, ssm_state=16, ssm_expand=2,
                ssm_head_dim=8, ssm_groups=2, ssm_chunk=8, dtype="float32")
    base.update(kw)
    return base


def _ssm_cfg(**kw):
    return ArchConfig(**_ssm_kw(**kw))


def _moe_kw(**kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                d_ff=64, vocab_size=100, n_experts=8, moe_top_k=2,
                n_shared_experts=1, moe_d_ff=16, capacity_factor=8.0,
                dtype="float32")
    base.update(kw)
    return base


def _moe_cfg(**kw):
    return ArchConfig(**_moe_kw(**kw))


def _params(schema, seed=0):
    return init_params(schema, torch.Generator().manual_seed(seed),
                       torch.float32, "cpu")


def _ref_params(jschema, seed=0):
    """The reference's parameters and the same values as torch tensors."""
    jp = jinit(jschema, jax.random.PRNGKey(seed), jnp.float32)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, label, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (
        label, err, np.abs(want).max())


def _ssd_inputs(B=2, L=24, cfg=None):
    cfg = cfg or _ssm_cfg()
    dims = SSM.ssm_dims(cfg)
    H, hd, N = dims["n_heads"], cfg.ssm_head_dim, cfg.ssm_state
    xh = RNG.normal(size=(B, L, H, hd)).astype(np.float32)
    dt = np.abs(RNG.normal(size=(B, L, H))).astype(np.float32) * 0.5
    A = -np.abs(RNG.normal(size=(H,))).astype(np.float32)
    Bm = RNG.normal(size=(B, L, H, N)).astype(np.float32)
    Cm = RNG.normal(size=(B, L, H, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


# ------------------------------------------- twins of tests/test_ssm_moe.py
def test_ssd_chunked_equals_sequential_recurrence():
    xh, dt, A, Bm, Cm = _ssd_inputs()
    B, L, H, hd = xh.shape
    N = Bm.shape[-1]
    y, hf = SSM._ssd_chunked(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=8)
    h = np.zeros((B, H, hd, N), np.float32)
    yref = np.zeros((B, L, H, hd), np.float32)
    for t in range(L):
        a = np.exp(dt[:, t] * A[None, :])
        xb = xh[:, t] * dt[:, t][..., None]
        h = h * a[..., None, None] + np.einsum("bhp,bhn->bhpn", xb, Bm[:, t])
        yref[:, t] = np.einsum("bhpn,bhn->bhp", h, Cm[:, t])
    np.testing.assert_allclose(y.numpy(), yref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hf.numpy(), h, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunk_size_invariance(chunk):
    """ssm_chunk is a performance knob: outputs must not change."""
    cfg = _ssm_cfg(ssm_chunk=chunk)
    params = _params(SSM.ssm_schema(cfg))
    x = _t(RNG.normal(size=(2, 16, 32)))
    y = SSM.ssm_apply(params, x, cfg)
    yr = SSM.ssm_apply(params, x, _ssm_cfg(ssm_chunk=16))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=2e-4, atol=2e-4)


def test_ssm_train_equals_incremental_decode():
    cfg = _ssm_cfg()
    dims = SSM.ssm_dims(cfg)
    params = _params(SSM.ssm_schema(cfg))
    B, L = 2, 12
    x = _t(RNG.normal(size=(B, L, cfg.d_model)))
    y_train, (conv_f, h_f) = SSM.ssm_apply(params, x, cfg, return_state=True)
    conv = torch.zeros(B, dims["conv_dim"], cfg.ssm_conv - 1)
    h = torch.zeros(B, dims["n_heads"], cfg.ssm_head_dim, cfg.ssm_state)
    outs = []
    for t in range(L):
        o, conv, h = SSM.ssm_decode_step(params, x[:, t:t + 1], cfg, conv, h)
        outs.append(o)
    np.testing.assert_allclose(y_train.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h_f.numpy(), h.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(conv_f.numpy(), conv.numpy(), rtol=1e-5,
                               atol=1e-5)   # in_proj over 12 rows vs 1


def test_moe_grouped_equals_dense_reference():
    cfg = _moe_cfg()
    params = _params(MOE.moe_schema(cfg))
    x = _t(RNG.normal(size=(2, 12, 32)))
    y1 = MOE.moe_apply(params, x, cfg)
    y2 = MOE.moe_apply(params, x, cfg.replace(moe_impl="dense_tp"))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_overflow():
    """With capacity_factor << 1 some tokens must be dropped: the output
    differs from the dropless dense path."""
    cfg = _moe_cfg(capacity_factor=0.01, n_shared_experts=0)
    params = _params(MOE.moe_schema(cfg))
    x = _t(RNG.normal(size=(4, 64, 32)))
    y1 = MOE.moe_apply(params, x, cfg)
    y2 = MOE.moe_apply(params, x, cfg.replace(moe_impl="dense_tp"))
    assert not np.allclose(y1.numpy(), y2.numpy(), atol=1e-3)


def test_moe_grads_finite():
    cfg = _moe_cfg()
    params = _params(MOE.moe_schema(cfg))
    leaves = [params[k] for k in ("router", "w_gate", "w_up", "w_down")] + [
        params["shared"][k] for k in ("w_gate", "w_up", "w_down")]
    for p in leaves:
        p.requires_grad_(True)
    x = _t(RNG.normal(size=(2, 8, 32)))
    loss = (MOE.moe_apply(params, x, cfg) ** 2).sum()
    for g in torch.autograd.grad(loss, leaves, allow_unused=True):
        assert g is None or torch.isfinite(g).all()


# --------------------------------------------------------- cross-package
@pytest.mark.parametrize("L,chunk,h0", [(24, 8, False), (20, 20, True),
                                        (16, 4, True)])
def test_ssd_chunked_matches_reference(L, chunk, h0):
    xh, dt, A, Bm, Cm = _ssd_inputs(L=L)
    B, _, H, hd = xh.shape
    init = (RNG.normal(size=(B, H, hd, Bm.shape[-1])).astype(np.float32)
            if h0 else None)
    jy, jh = JSSM._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                               chunk=chunk,
                               h0=None if init is None else jnp.asarray(init))
    y, h = SSM._ssd_chunked(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                            None if init is None else _t(init))
    _close(y, jy, "y")
    _close(h, jh, "state")


@pytest.mark.parametrize("L,chunk", [(16, 8), (13, 8), (5, 16)])
def test_ssm_apply_matches_reference(L, chunk):
    """The whole mixer on the reference's parameters, from zero state and
    continued from a given one; L not a multiple of the chunk pads with
    dt = 0."""
    kw = _ssm_kw(ssm_chunk=chunk)
    cfg, jcfg = ArchConfig(**kw), JArchConfig(**kw)
    jp, p = _ref_params(JSSM.ssm_schema(jcfg))
    dims = SSM.ssm_dims(cfg)
    B = 2
    x = RNG.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    conv0 = RNG.normal(size=(B, dims["conv_dim"], cfg.ssm_conv - 1)
                       ).astype(np.float32)
    h0 = RNG.normal(size=(B, dims["n_heads"], cfg.ssm_head_dim,
                          cfg.ssm_state)).astype(np.float32)
    for states in ((None, None), (conv0, h0)):
        jout, (jconv, jh) = JSSM.ssm_apply(
            jp, jnp.asarray(x), jcfg,
            *[None if s is None else jnp.asarray(s) for s in states],
            return_state=True)
        out, (conv, h) = SSM.ssm_apply(
            p, _t(x), cfg, *[None if s is None else _t(s) for s in states],
            return_state=True)
        _close(out, jout, "out")
        np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
        _close(h, jh, "state")


def test_ssm_decode_step_states_match_reference():
    cfg, jcfg = ArchConfig(**_ssm_kw()), JArchConfig(**_ssm_kw())
    jp, p = _ref_params(JSSM.ssm_schema(jcfg), seed=3)
    shapes = SSM.ssm_state_shapes(cfg, 3)
    assert shapes == JSSM.ssm_state_shapes(jcfg, 3)
    jconv = jnp.zeros(shapes["conv"], jnp.float32)
    jh = jnp.zeros(shapes["h"], jnp.float32)
    conv, h = torch.zeros(shapes["conv"]), torch.zeros(shapes["h"])
    x = RNG.normal(size=(3, 6, cfg.d_model)).astype(np.float32)
    for t in range(6):
        jo, jconv, jh = JSSM.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                             jcfg, jconv, jh)
        o, conv, h = SSM.ssm_decode_step(p, _t(x[:, t:t + 1]), cfg, conv, h)
        _close(o, jo, f"out {t}")
        np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
        _close(h, jh, f"state {t}")


def _ref_keep(idx, n_experts: int, capacity: int):
    """The reference's dispatch bookkeeping, its own lines
    (``repro/models/moe.py:72-84`` with e_base 0, all experts owned):
    the stable hit order and which sorted hits it keeps."""
    fe = idx.reshape(-1)
    order = jnp.argsort(fe.astype(jnp.int32))
    se = fe[order]
    counts = jnp.bincount(se, length=n_experts + 1)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                              jnp.cumsum(counts)])[:-1]
    pos = jnp.arange(fe.shape[0]) - starts[se]
    return np.asarray(order), np.asarray((se < n_experts) & (pos < capacity))


@pytest.mark.parametrize("T,E,K,cf,tie", [
    (24, 8, 2, 1.0, False),
    (64, 4, 2, 0.5, False),      # drops
    (40, 8, 3, 0.75, True),      # tied probabilities, drops
    (16, 16, 1, 1.25, True),     # top-1 with ties
])
def test_route_and_capacity_equal_reference(T, E, K, cf, tie):
    """Expert indices, hit order and the capacity keep-mask are exactly the
    reference's. With ``tie`` the router has duplicated columns, so some
    probabilities tie bit for bit and the lower expert must come first."""
    D = 16
    x = RNG.normal(size=(T, D)).astype(np.float32)
    router = RNG.normal(size=(D, E)).astype(np.float32)
    if tie:
        router[:, 1] = router[:, 0]
        router[:, E - 1] = router[:, 2]
        x[::3] = 0.0                          # every expert ties on these
    jw, jidx = JMOE._route(jnp.asarray(x), jnp.asarray(router), K)
    w, idx = MOE._route(_t(x), _t(router), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, "weights")
    cap = int(np.ceil(T * K / E * cf))
    jorder, jkeep = _ref_keep(jidx, E, cap)
    order, se, pos, keep, src, filled = MOE.capacity_plan(idx, E, cap)
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert int(filled.sum()) == int(keep.sum())
    if cf < 1.0:
        assert not keep.all()


@pytest.mark.parametrize("impl,cf,act,shared", [
    ("ep_shardmap", 8.0, "swiglu", 1),
    ("ep_shardmap", 0.5, "swiglu", 1),       # drops
    ("ep_shardmap", 0.75, "gelu", 0),
    ("dense_tp", 1.25, "swiglu", 1),
    ("dense_tp", 1.25, "gelu", 2),
])
def test_moe_apply_matches_reference(impl, cf, act, shared):
    kw = _moe_kw(moe_impl=impl, capacity_factor=cf, act=act,
                 n_shared_experts=shared)
    cfg, jcfg = ArchConfig(**kw), JArchConfig(**kw)
    jp, p = _ref_params(JMOE.moe_schema(jcfg), seed=5)
    x = RNG.normal(size=(3, 10, cfg.d_model)).astype(np.float32)
    _close(MOE.moe_apply(p, _t(x), cfg),
           JMOE.moe_apply(jp, jnp.asarray(x), jcfg, mesh=None), impl)


def test_moe_apply_is_deterministic():
    """The same batch twice gives the same bits (gathers, no atomics)."""
    cfg = _moe_cfg(capacity_factor=0.5)
    params = _params(MOE.moe_schema(cfg), seed=2)
    x = _t(RNG.normal(size=(4, 16, 32)))
    assert torch.equal(MOE.moe_apply(params, x, cfg),
                       MOE.moe_apply(params, x, cfg))
