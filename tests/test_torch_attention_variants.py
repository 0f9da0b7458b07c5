"""Attention equivalences in the port (``repro_torch.models.attention``):
twins of tests/test_attention_variants.py (flash custom backward against
naive autograd; the static band / chunk variants against the masked
global oracle; the grouped layers against the masked ones), plus the band
variants against the reference's on the same numpy inputs.

Tolerances are the reference tests' (3e-4 on outputs and losses, 3e-3 on
gradients, 1e-5 / 2e-3 on the grouped forward); cross-package outputs
within 1e-5 of their largest magnitude (fp32, the same products summed in
other orders). The reference counts FLOPs with XLA's cost analysis; the
port has none, so its twin counts the score elements each attention call
of the band path is given.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model_schema as jschema  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import (from_reference, loss_fn,  # noqa: E402
                                prefill)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.attention import (chunked_attention,  # noqa: E402
                                          flash_attention, local_attention,
                                          naive_attention)

RNG = np.random.default_rng(0)


def _qkv(B, S, H, KV, hd):
    return tuple(RNG.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _t(*arrays, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


@pytest.mark.parametrize("B,S,H,KV,hd,w,c", [
    (2, 130, 8, 2, 32, 0, 0),
    (1, 257, 4, 4, 16, 0, 0),
    (2, 100, 6, 2, 16, 17, 0),
    (1, 200, 4, 2, 32, 0, 64),
])
def test_flash_fwd_bwd_matches_naive(B, S, H, KV, hd, w, c):
    arrays = _qkv(B, S, H, KV, hd)
    qf, kf, vf = _t(*arrays, grad=True)
    qn, kn, vn = _t(*arrays, grad=True)
    lf = (flash_attention(qf, kf, vf, causal=True, window=w, chunk=c,
                          block_q=64, block_k=32) ** 2).sum()
    ln = (naive_attention(qn, kn, vn, causal=True, window=w, chunk=c)
          ** 2).sum()
    np.testing.assert_allclose(float(lf.detach()), float(ln.detach()),
                               rtol=3e-4)
    gf = torch.autograd.grad(lf, (qf, kf, vf))
    gn = torch.autograd.grad(ln, (qn, kn, vn))
    for a, b in zip(gf, gn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3,
                                   atol=3e-3)


@pytest.mark.parametrize("B,S,H,KV,hd,w", [
    (2, 200, 4, 2, 16, 32),
    (1, 129, 4, 4, 8, 64),     # ragged tail
    (2, 96, 2, 2, 8, 32),
    (1, 64, 2, 2, 8, 64),      # S == w degenerate
])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_banded_local_equals_masked_global(B, S, H, KV, hd, w, impl):
    q, k, v = _t(*_qkv(B, S, H, KV, hd))
    kw = {"block_q": 32, "block_k": 32} if impl == "flash" else {}
    got = local_attention(q, k, v, window=w, impl=impl, **kw)
    want = naive_attention(q, k, v, causal=True, window=w, chunk=0)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("B,S,H,KV,hd,c", [
    (2, 200, 4, 2, 16, 32),
    (1, 100, 4, 4, 8, 64),
])
def test_chunked_equals_masked_global(B, S, H, KV, hd, c):
    q, k, v = _t(*_qkv(B, S, H, KV, hd))
    got = chunked_attention(q, k, v, chunk=c, impl="naive")
    want = naive_attention(q, k, v, causal=True, window=0, chunk=c)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=3e-4, atol=3e-4)


def test_banded_issues_fewer_flops(monkeypatch):
    """The static-local variant must not issue out-of-window work: the
    score elements (batch x heads x queries x keys) of the band path's
    attention calls, counted without computing them, stay under a third
    of the full causal call's."""
    B, S, H, KV, hd, w = 2, 4096, 8, 4, 64, 512
    counted = []

    def count(q, k, v, **kw):
        counted.append(q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1])
        return torch.zeros_like(q)

    monkeypatch.setattr(A, "naive_attention", count)
    q = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    kv = torch.zeros(B, S, KV, hd, dtype=torch.bfloat16)
    A.attend("naive", q, kv, kv, causal=True)
    full = counted.pop()
    local_attention(q, kv, kv, window=w, impl="naive")
    band = sum(counted)
    assert len(counted) == 2 and band < full / 3, (band, full)


@pytest.mark.parametrize("name,group", [("hymba-1.5b", 2),
                                        ("llama4-scout-17b-a16e", 2)])
def test_grouped_scan_matches_baseline(name, group):
    """``layer_group > 1`` (the static bands) gives the masked layers'
    loss, prefill logits and caches (the reference's own parameters at
    smoke width, 4 layers)."""
    jcfg = jsmoke(name).replace(n_layers=4)
    cfg = smoke_config(name).replace(n_layers=4)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(0), jcfg.param_dtype())
    model = from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = RNG.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    grouped = cfg.replace(layer_group=group)
    l1 = loss_fn(model, batch, cfg)
    l2 = loss_fn(model, batch, grouped)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    p1, c1 = prefill(model, {"tokens": toks}, cfg, cache_seq=24)
    p2, c2 = prefill(model, {"tokens": toks}, grouped, cache_seq=24)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=2e-3, atol=2e-3)
    assert sorted(c1) == sorted(c2)
    for key in c1:
        np.testing.assert_allclose(c1[key].float().numpy(),
                                   c2[key].float().numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=key)


@pytest.mark.parametrize("B,S,H,KV,hd,w,kind", [
    (2, 200, 4, 2, 16, 32, "local"),
    (1, 129, 4, 4, 8, 64, "local"),
    (2, 200, 4, 2, 16, 32, "chunked"),
    (1, 100, 4, 4, 8, 64, "chunked"),
])
@pytest.mark.parametrize("impl", ["naive", "flash", "prefill"])
def test_band_variants_match_reference(B, S, H, KV, hd, w, kind, impl):
    """The port's band variants, through each of its attentions, against
    the reference's (naive) on the same inputs."""
    arrays = _qkv(B, S, H, KV, hd)
    jfn = JA.local_attention if kind == "local" else JA.chunked_attention
    fn = local_attention if kind == "local" else chunked_attention
    key = "window" if kind == "local" else "chunk"
    want = np.asarray(jfn(*map(jnp.asarray, arrays), impl="naive",
                          **{key: w}))
    kw = {"block_q": 32, "block_k": 32} if impl == "flash" else {}
    got = fn(*_t(*arrays), impl=impl, **{key: w}, **kw).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
