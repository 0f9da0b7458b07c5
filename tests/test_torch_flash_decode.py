"""Kernel 10 (GQA flash decode) of the port against the JAX package.

Here on the CPU ``repro_torch.kernels.ops.flash_decode`` runs its plain
PyTorch version (CPU tensors); it is held against the JAX wrapper
``repro.kernels.ops.flash_decode`` (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and against the jnp oracle
``repro.kernels.ref.flash_decode_ref``, on the same numpy inputs (bf16
inputs are rounded once, by JAX, and handed over bit for bit).
Tolerances are tests/test_kernels.py's: rtol = atol = 3e-4 at fp32 (the
Pallas kernel's online softmax sums in 512-position blocks, the plain
version in one pass) and 3e-2 at bf16 (the Pallas kernel rounds p to bf16
before the PV product). ``test_torch_gpu.py`` holds the CUDA kernel against
the same plain version on a card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import decode_attention as jdecode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

# the launch-wrapper module (the package attribute of that name is the
# dispatching ops.flash_decode)
fd = importlib.import_module("repro_torch.kernels.flash_decode")

TOLS = {np.float32: 3e-4, jnp.bfloat16: 3e-2}


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _inputs(b, h, kv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(b, h, d)), dtype=dtype)
    k = jnp.asarray(rng.normal(size=(b, kv, s, d)), dtype=dtype)
    v = jnp.asarray(rng.normal(size=(b, kv, s, d)), dtype=dtype)
    lens = rng.integers(1, s + 1, size=b)
    mask = np.arange(s)[None, :] < lens[:, None]
    return q, k, v, mask


def _check(q, k, v, mask, dtype, label):
    tol = TOLS[dtype]
    got = ops.flash_decode(_t(q), _t(k), _t(v),
                           torch.from_numpy(mask.astype(np.int8)))
    assert got.dtype == _t(q).dtype, label
    got = got.float().numpy()
    assert np.isfinite(got).all(), label
    pallas = np.asarray(jops.flash_decode(q, k, v, mask), np.float32)
    oracle = np.asarray(jref.flash_decode_ref(q, k, v, jnp.asarray(mask)),
                        np.float32)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol,
                               err_msg=f"{label} vs Pallas")
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol,
                               err_msg=f"{label} vs jnp oracle")
    return got


# the reference sweep (tests/test_kernels.py::test_flash_decode_sweep)
@pytest.mark.parametrize("b,h,kv,s,d,dtype", [
    (2, 8, 2, 1000, 64, np.float32),
    (1, 4, 4, 512, 128, np.float32),
    (3, 16, 8, 700, 32, np.float32),
    (2, 8, 8, 256, 64, np.float32),
    (2, 8, 2, 512, 64, jnp.bfloat16),
])
def test_flash_decode_sweep_matches_jax(b, h, kv, s, d, dtype):
    q, k, v, mask = _inputs(b, h, kv, s, d, dtype, seed=b * 100 + s)
    _check(q, k, v, mask, dtype, f"sweep {b, h, kv, s, d}")


@pytest.mark.parametrize("case", [
    "empty_row", "s1", "s532", "group1", "group3", "group8", "bf16_s532"])
def test_flash_decode_edge_cases_match_jax(case):
    # (b, h, kv, s, d, dtype)
    shape = {"empty_row": (3, 8, 2, 300, 64, np.float32),
             "s1": (2, 4, 2, 1, 32, np.float32),
             "s532": (2, 16, 8, 532, 128, np.float32),
             "group1": (2, 4, 4, 200, 64, np.float32),
             "group3": (2, 6, 2, 257, 48, np.float32),
             "group8": (2, 16, 2, 130, 64, np.float32),
             "bf16_s532": (2, 16, 8, 532, 128, jnp.bfloat16)}[case]
    q, k, v, mask = _inputs(*shape, seed=len(case))
    if case == "empty_row":
        mask[1] = False                       # a row that admits nothing
    got = _check(q, k, v, mask, shape[-1], case)
    if case == "empty_row":
        assert np.all(got[1] == 0.0)
        assert np.all(np.abs(got[0]) > 0)


@pytest.mark.parametrize("window,chunk", [(0, 0), (7, 0), (0, 16), (5, 16)])
def test_decode_attention_holes_match_reference(window, chunk):
    """A mask with holes: the port's ``decode_attention`` (the (B, S) mask
    it builds, through ``ops.flash_decode``) against the reference's
    einsum ``decode_attention`` with the same window / chunk."""
    rng = np.random.default_rng(window * 31 + chunk)
    b, h, kv, s, d = 4, 8, 2, 96, 32
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    lens = np.array([1, 17, 50, 96], np.int32)
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), window=window, chunk=chunk))
    got = decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(lens),
                           window=window, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_flash_decode_cpu_runs_plain_version_and_cuda_wrapper_refuses_cpu():
    """CPU tensors take the plain version (no launch is counted); the
    launch wrapper itself takes CUDA tensors only, and no device but CUDA
    and the CPU is served."""
    q, k, v, mask = _inputs(2, 4, 2, 64, 32, np.float32, seed=1)
    ops.reset_launch_counts()
    got = ops.flash_decode(_t(q), _t(k), _t(v))          # mask omitted
    want = ref.flash_decode_ref(_t(q), _t(k), _t(v),
                                torch.ones(2, 64, dtype=torch.int8))
    assert torch.equal(got, want)
    assert ops.launch_counts()["flash_decode"] == 0
    with pytest.raises(ValueError, match="cuda"):
        fd.flash_decode(_t(q), _t(k), _t(v),
                        torch.ones(2, 64, dtype=torch.int8))
    meta = torch.empty(2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_decode(meta, meta.new_empty(2, 2, 64, 32),
                         meta.new_empty(2, 2, 64, 32))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_decode_wrapper_refuses_other_types(dtype):
    """The launch wrapper takes fp32 or bf16 only, and says so before it
    looks at the device."""
    q = torch.zeros(2, 4, 32, dtype=dtype)
    kv = torch.zeros(2, 2, 64, 32, dtype=dtype)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fd.flash_decode(q, kv, kv, torch.ones(2, 64, dtype=torch.int8))


# ------------------------------------------------- the split kernel's plan
@pytest.mark.parametrize("s,n_split", [
    (1, 1), (64, 1), (65, 2), (532, 1), (532, 2), (532, 7), (532, 9),
    (661, 11), (1500, 24), (2193, 14), (32_768, 33), (130, 5)])
def test_split_ranges_cover_the_cache_in_whole_tiles(s, n_split):
    """Each split starts on a 64-position tile; the splits follow one
    another without gap or overlap from 0 to s; empty splits (more splits
    than tiles) are empty ranges."""
    spans = fd.split_ranges(s, n_split)
    assert len(spans) == n_split
    assert spans[0][0] == 0 and spans[-1][1] == s
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    for start, stop in spans:
        assert start % fd.SPLIT_TILE == 0 and start <= stop
        assert stop == s or stop % fd.SPLIT_TILE == 0
    tiles = -(-s // fd.SPLIT_TILE)
    if n_split <= tiles:
        assert all(stop > start for start, stop in spans)


@pytest.mark.parametrize("shape,want", [
    # (b, kv, s, group, dtype) at 132 SMs -> splits
    ((64, 8, 532, 2, torch.bfloat16), 1),     # the RAG main shape
    ((1, 8, 32_768, 2, torch.bfloat16), 33),  # the long cache
    ((64, 5, 661, 5, torch.bfloat16), 1),     # hymba, b = 64
    ((4, 5, 2_193, 5, torch.bfloat16), 13),   # hymba, b = 4
    ((4, 32, 224, 1, torch.bfloat16), 2),     # phi-3, b = 4, group 1
    ((16, 20, 1_500, 1, torch.bfloat16), 1),  # whisper's cross-attention
    ((1, 1, 100, 40, torch.bfloat16), 2),     # a group of 3 mma slices
    ((1, 1, 100, 40, torch.float32), 2),      # fp32 keeps the group whole
    ((1, 1, 64, 1, torch.float32), 1),        # never above the tiles
])
def test_split_plan(shape, want):
    """One split where b * kv blocks already fill more than half a wave of
    two on every SM, else as many as fit in that wave, at most one per
    tile; the plan is a pure function."""
    b, kv, s, group, dtype = shape
    got = fd.split_plan(b, kv, s, group, dtype, 132)
    assert got == want
    assert got == fd.split_plan(b, kv, s, group, dtype, 132)
    assert 1 <= got <= -(-s // fd.SPLIT_TILE)


def _split_inputs(b, h, kv, s, d, dtype, seed, masking):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(b, h, d)), dtype=dtype)
    k = jnp.asarray(rng.normal(size=(b, kv, s, d)), dtype=dtype)
    v = jnp.asarray(rng.normal(size=(b, kv, s, d)), dtype=dtype)
    pos = np.arange(s)[None, :]
    lens = rng.integers(1, s + 1, size=b)[:, None]
    mask = pos < lens
    if masking == "band":                      # a sliding window
        mask &= pos >= lens - 100
    elif masking == "holes":
        mask[0] &= pos[0] % 7 < 5
        mask[-1] = False                       # a row that admits nothing
    elif masking == "short":                   # later splits admit nothing
        mask = pos < rng.integers(1, 100, size=b)[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("b,h,kv,s,d,dtype,n_split,masking", [
    (2, 8, 2, 200, 128, np.float32, 1, "ragged"),
    (2, 4, 4, 300, 64, np.float32, 2, "ragged"),       # group 1
    (2, 8, 4, 532, 128, jnp.bfloat16, 7, "ragged"),    # group 2
    (2, 8, 4, 532, 128, np.float32, 9, "holes"),       # s / 64 splits
    (2, 10, 2, 700, 64, jnp.bfloat16, 11, "band"),     # group 5
    (2, 16, 2, 257, 96, np.float32, 5, "holes"),       # group 8, d = 96
    (3, 16, 2, 257, 96, jnp.bfloat16, 2, "holes"),
    (3, 4, 2, 99, 13, jnp.bfloat16, 2, "holes"),       # odd d
    (3, 4, 2, 99, 13, np.float32, 7, "band"),          # splits > tiles
    (2, 4, 2, 640, 64, jnp.bfloat16, 10, "short"),     # empty splits
    (2, 8, 8, 640, 128, np.float32, 10, "short"),
    (2, 10, 2, 130, 64, jnp.bfloat16, 1, "band"),
])
def test_split_model_matches_pallas_and_oracle(b, h, kv, s, d, dtype,
                                               n_split, masking):
    """``ref.flash_decode_split_ref`` (the split kernel's arithmetic: p
    rounded against each split's running max, splits merged in order)
    against the Pallas ``flash_decode`` in interpret mode and the jnp
    oracle, at ``chip_smoke.py``'s tolerances: 3e-4 (1 + |want|) at fp32,
    2^-7 (|want| + A) at bf16 with A = sum p |v| / l."""
    q, k, v, mask = _split_inputs(b, h, kv, s, d, dtype,
                                  seed=s * 13 + n_split, masking=masking)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tmask = torch.from_numpy(mask.astype(np.int8))
    got = ref.flash_decode_split_ref(tq, tk, tv, tmask, n_split)
    assert got.dtype == tq.dtype
    got = got.float().numpy()
    assert np.isfinite(got).all()
    pallas = np.asarray(jops.flash_decode(q, k, v, mask), np.float32)
    oracle = np.asarray(jref.flash_decode_ref(q, k, v, jnp.asarray(mask)),
                        np.float32)
    if dtype == np.float32:
        limit = 3e-4 * (1 + np.abs(oracle))
    else:
        spread = ref.flash_decode_ref(tq.float(), tk.float(),
                                      tv.float().abs(), tmask).numpy()
        limit = 2.0 ** -7 * (np.abs(oracle) + spread)
    for label, want in (("Pallas", pallas), ("jnp oracle", oracle)):
        err = np.abs(got - want)
        assert (err <= limit).all(), (label, float(err.max()))
    empty = ~mask.any(axis=1)
    assert np.all(got[empty] == 0.0)
