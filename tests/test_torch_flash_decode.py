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
