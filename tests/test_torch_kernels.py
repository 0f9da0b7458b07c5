"""The port's kernels against the JAX package, kernel by kernel.

Here on the CPU the port's wrappers run the plain PyTorch versions (CPU
tensors); each is held against the JAX wrapper ``repro.kernels.ops.<kernel>``
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it) and
against the jnp oracle in ``repro.kernels.ref``, on the same numpy inputs.
Ids must be equal; values agree to rtol = atol = 1e-5 (fp32 sums are taken in
another order by XLA:CPU and torch); empty lanes are exactly
``finfo(float32).min`` / -1; the bitmap kernels are bit-exact.
(``test_torch_gpu.py`` holds each CUDA kernel against its plain version on
a card.)
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

NEG_INF = float(np.finfo(np.float32).min)
TOL = 1e-5


def _pack(dense: np.ndarray) -> np.ndarray:
    """(S, n) bool -> (S, ceil(n/32)) little-endian uint32 words."""
    pad = (-dense.shape[1]) % 32
    return np.stack([np.packbits(np.pad(m, (0, pad)), bitorder="little")
                     .view(np.uint32) for m in dense])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(port, jax_out, label):
    """Empty lanes are the JAX side's ``finfo.min`` lanes: there the port
    must hold exactly (finfo.min, -1). The Pallas merge leaves a repeated
    real id in such lanes (ROADMAP queue 3), so ids are compared on the
    filled lanes, which must coincide."""
    pv, pi = (np.asarray(a) for a in port)
    jv, ji = (np.asarray(a) for a in jax_out)
    empty = jv <= NEG_INF
    assert np.all(pv[empty] == NEG_INF) and np.all(pi[empty] == -1), label
    np.testing.assert_array_equal(pi[~empty], ji[~empty], err_msg=label)
    np.testing.assert_allclose(pv[~empty], jv[~empty], rtol=TOL, atol=TOL,
                               err_msg=label)


def _case(q, n, d, k, seed, density=0.4, n_scopes=3):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    dense = rng.random((n_scopes, n)) < density
    sid = rng.integers(0, n_scopes, size=q).astype(np.int32)
    return Q, X, dense, sid


# every value of q, n, k and both metrics appear (an L9 orthogonal array
# over q x n x k, metric alternating), at d = 16 and, for n = 1024, d = 128
SWEEP = [(q, n, k, "l2" if (i + j) % 2 else "ip")
         for i, q in enumerate((1, 5, 8))
         for j, n in enumerate((137, 1024, 2081))
         for k in [(1, 10, 40)[(i + j) % 3]]]


@pytest.mark.parametrize("q,n,k,metric", SWEEP)
def test_scoped_topk_matches_jax(q, n, k, metric):
    d = 128 if n == 1024 else 16
    Q, X, dense, _ = _case(q, n, d, k, seed=q * 1000 + n + k)
    mask = dense[0]
    port = ops.scoped_topk(_t(Q), _t(X), _t(mask.astype(np.int8)), k, metric)
    label = f"q{q} n{n} k{k} {metric}"
    _assert_same(port, jops.scoped_topk(Q, X, mask, k=k, metric=metric),
                 label + " pallas")
    _assert_same(port, jref.scoped_topk_ref(jnp.asarray(Q), jnp.asarray(X),
                                            jnp.asarray(mask), k=k,
                                            metric=metric), label + " jnp")


@pytest.mark.parametrize("q,n,k,metric", SWEEP)
def test_multi_scope_topk_matches_jax(q, n, k, metric):
    d = 128 if n == 1024 else 16
    Q, X, dense, sid = _case(q, n, d, k, seed=q * 1000 + n + k + 1)
    words = _pack(dense)
    port = ops.multi_scope_topk(_t(Q), _t(X), _t(words.view(np.int32)),
                                _t(sid), k, metric)
    label = f"q{q} n{n} k{k} {metric}"
    _assert_same(port, jops.multi_scope_topk(Q, X, words, sid, k=k,
                                             metric=metric),
                 label + " pallas")
    _assert_same(port, jref.multi_scope_topk_ref(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(words),
        jnp.asarray(sid), k=k, metric=metric), label + " jnp")


def _integer_case(q, n, d, seed):
    """Small-integer data: every dot product is exact in any summation order,
    so duplicated rows tie exactly in both packages."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    X[n // 2:n // 2 + 7] = X[3]                      # duplicated rows: ties
    X[n - 9:] = X[11]
    return Q, X


@pytest.mark.parametrize("case", ["empty_scope", "k_over_scope",
                                  "all_masked_tiles", "ties"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_topk_edge_cases_match_jax(case, metric):
    q, n, d, k = 5, 2081, 16, 40
    Q, X = _integer_case(q, n, d, seed=3)
    rng = np.random.default_rng(4)
    dense = np.zeros((3, n), bool)
    if case == "k_over_scope":
        dense[0, rng.choice(n, 13, replace=False)] = True   # 13 < k
    elif case == "all_masked_tiles":
        dense[0, n - 20:] = True          # only the ragged last tile admits
    elif case == "ties":
        dense[0] = rng.random(n) < 0.5
        dense[0, [3, 11, n // 2, n // 2 + 3, n - 1]] = True
    dense[1] = rng.random(n) < 0.3        # the other scopes of the batch
    dense[2] = True
    sid = np.array([0, 0, 1, 2, 0], np.int32)
    mask = dense[0]
    port = ops.scoped_topk(_t(Q), _t(X), _t(mask.astype(np.int8)), k, metric)
    _assert_same(port, jops.scoped_topk(Q, X, mask, k=k, metric=metric),
                 f"{case} scoped pallas")
    _assert_same(port, jref.scoped_topk_ref(jnp.asarray(Q), jnp.asarray(X),
                                            jnp.asarray(mask), k=k,
                                            metric=metric),
                 f"{case} scoped jnp")
    words = _pack(dense)
    port = ops.multi_scope_topk(_t(Q), _t(X), _t(words.view(np.int32)),
                                _t(sid), k, metric)
    _assert_same(port, jops.multi_scope_topk(Q, X, words, sid, k=k,
                                             metric=metric),
                 f"{case} multi pallas")
    if case == "empty_scope":
        assert np.all(np.asarray(port[1])[[0, 1, 4]] == -1)


def test_stable_topk_keeps_lower_ids_first_on_ties():
    scores = torch.zeros(1, 35)
    scores[0, [0, 7, 14, 21, 28]] = 1.0
    vals, ids = ref.stable_topk(scores, 5)
    assert ids.tolist() == [[0, 7, 14, 21, 28]]
    vals, ids = ref.stable_topk(torch.full((1, 3), NEG_INF), 5)
    assert ids.tolist() == [[-1] * 5] and torch.all(vals == NEG_INF)


@pytest.mark.parametrize("rows,n_words", [(1, 1), (3, 77), (16, 2049)])
def test_bitmap_patch_matches_jax(rows, n_words):
    rng = np.random.default_rng(rows * 7 + n_words)
    masks = rng.integers(0, 2 ** 32, size=(rows, n_words), dtype=np.uint32)
    delta = rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32)
    signs = np.array([(1, -1, 0)[i % 3] for i in range(rows)], np.int32)
    port = ops.bitmap_patch(_t(masks.view(np.int32)),
                            _t(delta.view(np.int32)), _t(signs))
    got = port.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(jops.bitmap_patch(masks, delta, signs)))
    np.testing.assert_array_equal(
        got, jref.bitmap_patch_np(masks, delta, signs))


@pytest.mark.parametrize("n_words", [1, 77, 2049])
def test_mask_and_popcount_matches_jax(n_words):
    rng = np.random.default_rng(n_words)
    a = rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32)
    words, count = ops.mask_and_popcount(_t(a.view(np.int32)),
                                         _t(b.view(np.int32)))
    jw, jc = jops.mask_and_popcount(a, b)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jw))
    assert int(count) == int(jc)
    rw, rc = jref.mask_and_popcount_ref(jnp.asarray(a), jnp.asarray(b))
    assert int(count) == int(rc)
    assert int(count) == int(np.unpackbits((a & b).view(np.uint8)).sum())


def test_words_unpack_little_endian():
    ids = np.array([0, 5, 31, 32, 63, 100], np.int64)
    dense = np.zeros((1, 101), bool)
    dense[0, ids] = True
    bits = ref.unpack_words(_t(_pack(dense).view(np.int32)), 101)
    assert torch.nonzero(bits[0]).flatten().tolist() == ids.tolist()


def test_wrappers_reject_unknown_devices_and_mismatches():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="delta"):
        ops.bitmap_patch(torch.zeros(2, 3, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="devices|device"):
        ops.scoped_topk(x.to("meta"), x, torch.ones(4, dtype=torch.int8), 2)


def test_align_block_n_and_block_registry():
    from repro_torch.kernels.ops import _align_block_n, _blocks
    assert _align_block_n(1024, 137) == 160
    assert _align_block_n(1024, 10) == 128
    assert _align_block_n(4096, 5000) == 4096
    ops.set_block_overrides({"scoped_topk": (4, 2048)})
    try:
        assert _blocks("scoped_topk", None, None) == (4, 2048)
        assert _blocks("scoped_topk", 2, None) == (2, 2048)
        assert _blocks("multi_scope_topk", None, None) == (8, None)
    finally:
        ops.set_block_overrides({})
