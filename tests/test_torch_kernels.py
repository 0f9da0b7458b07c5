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

from test_torch_gpu import (PQ_LAUNCHES, STREAM_LAUNCHES,  # noqa: E402
                            TILED_LAUNCHES)

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


@pytest.mark.parametrize("n_words", [1, 3, 77, 2049, 2 ** 20 + 3])
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
        assert _blocks("multi_scope_topk", None, None) == (64, None)
    finally:
        ops.set_block_overrides({})


# ------------------------------------------------------ int8 and PQ scans
from repro.vectordb import flat as jflat  # noqa: E402
from repro_torch.vectordb.quant import PQCodebook, quantize_rows  # noqa: E402

# every q and n, k cycling and the metric alternating
QSWEEP = [(q, n, (1, 10, 40)[(i + j) % 3], "l2" if (i + j) % 2 else "ip")
          for i, q in enumerate((1, 5, 16))
          for j, n in enumerate((137, 2081))]


def _i8_case(q, n, d, seed):
    """int8 codes through the port's copy of the quantizer (Q, X keep
    duplicated rows, so exact ties occur)."""
    Q, X = _integer_case(q, n, d, seed)
    X = X + np.random.default_rng(seed).normal(size=X.shape).astype(
        np.float32) * 0.1
    X[n // 2] = X[3]
    qi, qs = quantize_rows(Q)
    xi, xs = quantize_rows(X)
    codes = xi.astype(np.int32)
    sq = np.einsum("nd,nd->n", codes, codes).astype(np.float32) * xs * xs
    return qi, qs, xi, xs, sq


def _pq_case(q, n, d, m, seed, metric="ip"):
    """A trained codebook (few centroids per subspace for n rows: many
    rows share codes, so ADC scores tie exactly)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    cb = PQCodebook(d, m, seed=seed)
    cb.train(X)
    return cb.lut(Q, metric), cb.encode(X)


def _assert_tie_aware(port, other, label):
    """PQ: the Pallas kernel's ``.sum(axis=2)`` and numpy's pairwise sum
    may round differently from the sequential sum over M: ids are equal
    except inside tie groups, values to rtol = atol = 1e-5."""
    pv, pi = (np.asarray(a) for a in port)
    ov, oi = (np.asarray(a) for a in other)
    oi = np.where(np.isfinite(ov) & (ov > NEG_INF), oi, -1)
    err = ref.topk_disagreement(pi, pv, oi, ov, TOL)
    assert err is None, f"{label}: {err}"


def _dense_case(n, seed, density=0.4):
    rng = np.random.default_rng(seed)
    dense = np.zeros((3, n), bool)
    dense[0] = rng.random(n) < density
    dense[1] = rng.random(n) < 0.2
    dense[2, n - 20:] = True               # only the ragged last tile
    return dense


@pytest.mark.parametrize("q,n,k,metric", QSWEEP)
def test_i8_kernels_match_jax(q, n, k, metric):
    """int8 scores are exact integer dots times the scales in both
    packages: ids are equal, values agree to 1e-5."""
    qi, qs, xi, xs, sq = _i8_case(q, n, 16, seed=q * 100 + n)
    dense = _dense_case(n, seed=n + k)
    sid = (np.arange(q) % 3).astype(np.int32)
    mask = dense[0]
    label = f"i8 q{q} n{n} k{k} {metric}"
    port = ops.scoped_topk_i8(_t(qi), _t(qs), _t(xi), _t(xs), _t(sq),
                              _t(mask.astype(np.int8)), k, metric)
    _assert_same(port, jops.scoped_topk_i8(qi, qs, xi, xs, sq, mask, k=k,
                                           metric=metric), label + " pallas")
    _assert_same(port, jref.scoped_topk_i8_ref(qi, qs, xi, xs, sq, mask, k,
                                               metric), label + " numpy")
    words = _pack(dense)
    port = ops.multi_scope_topk_i8(_t(qi), _t(qs), _t(xi), _t(xs), _t(sq),
                                   _t(words.view(np.int32)), _t(sid), k,
                                   metric)
    _assert_same(port, jops.multi_scope_topk_i8(qi, qs, xi, xs, sq, words,
                                                sid, k=k, metric=metric),
                 label + " multi pallas")
    _assert_same(port, jref.multi_scope_topk_i8_ref(qi, qs, xi, xs, sq,
                                                    words, sid, k, metric),
                 label + " multi numpy")


# QSWEEP at M = 4 under dense masks, then kernel 7's widest real gather
# launch cut to size (the PQ batch's gather plans: q = 5, k = r = 80, the
# gathered codes under an all-ones mask) at M = 16 and 32, n not a
# multiple of the 128-row tile
PQ_SWEEP = [(q, n, k, metric, 4, False) for q, n, k, metric in QSWEEP] + [
    (5, 2945, 80, "ip", 16, True), (5, 2945, 80, "l2", 32, True)]


@pytest.mark.parametrize(
    "q,n,k,metric,m,ones", PQ_SWEEP,
    ids=[f"{q}-{n}-{k}-{metric}" + (f"-M{m}-ones" if ones else "")
         for q, n, k, metric, m, ones in PQ_SWEEP])
def test_pq_kernels_match_jax(q, n, k, metric, m, ones):
    lut, codes = _pq_case(q, n, 2 * m if ones else 16, m, seed=q * 100 + n,
                          metric=metric)
    dense = _dense_case(n, seed=n + k)
    if ones:
        dense[0] = True
    sid = (np.arange(q) % 3).astype(np.int32)
    mask = dense[0]
    words = _pack(dense)
    label = f"pq q{q} n{n} k{k} {metric}"
    port = ops.scoped_topk_pq(_t(lut), _t(codes), _t(mask.astype(np.int8)),
                              k)
    _assert_tie_aware(port, jops.scoped_topk_pq(lut, codes, mask, k=k),
                      label + " pallas")
    _assert_tie_aware(port, jref.scoped_topk_pq_ref(lut, codes, mask, k),
                      label + " numpy")
    twin = jflat._scan_topk_pq(jnp.asarray(lut), jnp.asarray(codes),
                               jnp.asarray(_pack(mask[None])[0]), k)
    _assert_tie_aware(port, twin, label + " jnp twin")
    # the twin adds over M in the same order: its filled lanes are bitwise
    filled = np.isfinite(np.asarray(twin[0]))
    np.testing.assert_array_equal(port[1].numpy()[filled],
                                  np.asarray(twin[1])[filled])
    np.testing.assert_array_equal(port[0].numpy()[filled],
                                  np.asarray(twin[0])[filled])
    port = ops.multi_scope_topk_pq(_t(lut), _t(codes),
                                   _t(words.view(np.int32)), _t(sid), k)
    _assert_tie_aware(port, jops.multi_scope_topk_pq(lut, codes, words, sid,
                                                     k=k),
                      label + " multi pallas")
    _assert_tie_aware(port, jref.multi_scope_topk_pq_ref(lut, codes, words,
                                                         sid, k),
                      label + " multi numpy")
    _assert_tie_aware(port, jflat._multi_scan_topk_pq(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(words),
        jnp.asarray(sid), k), label + " multi jnp twin")


@pytest.mark.parametrize("case", ["empty_scope", "k_over_scope",
                                  "all_masked_tiles"])
@pytest.mark.parametrize("tier", ["i8_ip", "i8_l2", "pq"])
def test_quantized_edge_cases_match_jax(case, tier):
    q, n, k = 5, 2081, 40
    rng = np.random.default_rng(9)
    dense = np.zeros((3, n), bool)
    if case == "k_over_scope":
        dense[0, rng.choice(n, 13, replace=False)] = True   # 13 < k
    elif case == "all_masked_tiles":
        dense[0, n - 20:] = True
    dense[1] = rng.random(n) < 0.3
    dense[2] = True
    sid = np.array([0, 0, 1, 2, 0], np.int32)
    mask, words = dense[0], _pack(dense)
    if tier == "pq":
        lut, codes = _pq_case(q, n, 16, 4, seed=11)
        port = ops.multi_scope_topk_pq(_t(lut), _t(codes),
                                       _t(words.view(np.int32)), _t(sid), k)
        _assert_tie_aware(port, jops.multi_scope_topk_pq(lut, codes, words,
                                                         sid, k=k),
                          f"{case} pq multi")
        port = ops.scoped_topk_pq(_t(lut), _t(codes),
                                  _t(mask.astype(np.int8)), k)
        _assert_tie_aware(port, jops.scoped_topk_pq(lut, codes, mask, k=k),
                          f"{case} pq scoped")
    else:
        metric = tier[3:]
        qi, qs, xi, xs, sq = _i8_case(q, n, 16, seed=12)
        port = ops.multi_scope_topk_i8(_t(qi), _t(qs), _t(xi), _t(xs),
                                       _t(sq), _t(words.view(np.int32)),
                                       _t(sid), k, metric)
        _assert_same(port, jops.multi_scope_topk_i8(
            qi, qs, xi, xs, sq, words, sid, k=k, metric=metric),
            f"{case} {tier} multi")
        port = ops.scoped_topk_i8(_t(qi), _t(qs), _t(xi), _t(xs), _t(sq),
                                  _t(mask.astype(np.int8)), k, metric)
        _assert_same(port, jops.scoped_topk_i8(qi, qs, xi, xs, sq, mask,
                                               k=k, metric=metric),
                     f"{case} {tier} scoped")
    if case == "empty_scope":
        assert np.all(np.asarray(port[1]) == -1)
    if case == "k_over_scope":
        assert np.all(np.asarray(port[1])[:, 13:] == -1)


@pytest.mark.parametrize("tier", ["f32", "i8", "pq"])
def test_windows_past_256_match_numpy(tier):
    """A rescore window past the old kernel limit of 256 (bench_pq's 320,
    and one past n), through the plain versions."""
    q, n = 3, 700
    rng = np.random.default_rng(5)
    dense = rng.random((2, n)) < 0.7
    mask, words = dense[0], _pack(dense)
    sid = np.array([0, 1, 0], np.int32)
    for k in (320, 800):
        kk = min(k, n)                  # the oracles take k <= n only
        if tier == "f32":
            Q, X = _integer_case(q, n, 16, seed=6)
            port = ops.multi_scope_topk(_t(Q), _t(X),
                                        _t(words.view(np.int32)), _t(sid), k)
            want = jref.multi_scope_topk_ref(
                jnp.asarray(Q), jnp.asarray(X), jnp.asarray(words),
                jnp.asarray(sid), k=kk)
        elif tier == "i8":
            qi, qs, xi, xs, sq = _i8_case(q, n, 16, seed=7)
            port = ops.multi_scope_topk_i8(_t(qi), _t(qs), _t(xi), _t(xs),
                                           None, _t(words.view(np.int32)),
                                           _t(sid), k)
            want = jref.multi_scope_topk_i8_ref(qi, qs, xi, xs, sq, words,
                                                sid, kk)
        else:
            lut, codes = _pq_case(q, n, 16, 4, seed=8)
            port = ops.multi_scope_topk_pq(_t(lut), _t(codes),
                                           _t(words.view(np.int32)), _t(sid),
                                           k)
            want = jref.multi_scope_topk_pq_ref(lut, codes, words, sid, kk)
        want = [np.pad(np.asarray(a), ((0, 0), (0, max(0, k - a.shape[1]))),
                       constant_values=(NEG_INF if a.dtype.kind == "f"
                                        else -1)) for a in want]
        _assert_tie_aware(port, want, f"{tier} k{k}")
        assert port[1].shape == (q, k)
        assert np.all(port[1].numpy()[:, dense[sid].sum(1).max():] == -1)


def test_i8_l2_needs_the_dequantized_norms():
    qi = torch.zeros(1, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="sq"):
        ops.scoped_topk_i8(qi, torch.ones(1), qi, torch.ones(1), None,
                           torch.ones(1, dtype=torch.int8), 1, "l2")


_MAIN = 1_940_000


@pytest.mark.parametrize("kind,q,n,depth,k,block_q", TILED_LAUNCHES)
def test_tiled_geometry_fits_the_card(kind, q, n, depth, k, block_q):
    """The tiled pass 1's grid on an H100 (132 SMs) for a query tile of
    the cap min(block_q, q, 64): row chunks of whole mask words, at least
    one row tile and k rows each, at most 65535 of them, covering the n
    rows. At the main shapes the 64-query tile reads each row once in
    about one block per SM. (The C entry plans the tile itself, which may
    be smaller than the cap, and the shared memory from the cap, the depth
    and k; tests/test_torch_gpu.py::test_tiled_plan_fits_shared_memory
    holds that plan and its grid at every one of these shapes on the
    card.)"""
    st = ops._st                     # the wrappers' module
    qt = min(block_q or st.TILE_Q, q, st.TILE_Q)
    geo = st.tiled_geometry(kind, q, n, k, qt, None, 132)
    assert geo.qt == qt
    assert geo.chunk_rows % 32 == 0
    assert geo.chunk_rows >= max(k, st.TILE_R[kind])
    assert 1 <= geo.n_chunks <= 65535
    assert geo.n_chunks * geo.chunk_rows >= n > (geo.n_chunks - 1) * \
        geo.chunk_rows
    if n == _MAIN:
        assert geo.qt == 64
        assert 132 <= geo.n_chunks * -(-q // geo.qt) <= 264


@pytest.mark.parametrize("q,n,d,k", STREAM_LAUNCHES)
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_stream_geometry_fits_the_card(q, n, d, k, blocks):
    """Kernel 1's grid on an H100 (132 SMs) for a query tile of
    min(q, 8) and ``blocks`` blocks per SM: row chunks of whole 128-row
    tiles (so whole mask words), at most one wave of blocks unless the
    rows need more chunks, at most 65535 chunks, covering the n rows. A
    gather plan's few thousand rows get one tile per block. (The C entry
    plans the tile, the list placement and the blocks per SM;
    tests/test_torch_gpu.py::test_stream_plan_fits_shared_memory holds that
    plan's shared memory on the card.)"""
    st = ops._st
    qt = min(q, st.STREAM_Q)
    geo = st.stream_geometry(q, n, qt, blocks, None, 132)
    tiles = -(-q // qt)
    assert geo.qt == qt
    assert geo.chunk_rows % st.STREAM_ROWS == 0 and geo.chunk_rows % 32 == 0
    assert 1 <= geo.n_chunks <= 65535
    assert geo.n_chunks * geo.chunk_rows >= n > (geo.n_chunks - 1) * \
        geo.chunk_rows
    assert geo.n_chunks * tiles <= max(132 * blocks, tiles)
    if n <= 4000:
        assert geo.chunk_rows == st.STREAM_ROWS
    if n == _MAIN and blocks == 2:
        assert 256 <= geo.n_chunks <= 264


# kernel 7's grid: (q, n) at the main shape, the widest real gather and
# small launches; the C plan's PQ tile is one query and 1-4 blocks share an
# SM (4 at M = 32, k <= 80)
PQ_STREAM_SHAPES = [(q, n) for n in (_MAIN, 41_829, 1, 137, 4000)
                    for q in (1, 5)]


@pytest.mark.parametrize("q,n", PQ_STREAM_SHAPES)
@pytest.mark.parametrize("blocks", [1, 4])
def test_pq_stream_geometry_keeps_chunks_above_the_floor(q, n, blocks):
    """Kernel 7's grid on an H100 (132 SMs): each chunk holds at least
    STREAM_PQ_ROWS rows (so its codes outweigh its block's LUT copy)
    unless the launch has fewer rows, the grid is at most one wave of
    ``blocks`` per SM, chunks are whole 128-row tiles, at most 65535 of
    them, covering the n rows. At the main shape (q = 1) the chunks split
    the rows over the wave; at the widest gather (q = 5) the floor sets
    them."""
    st = ops._st
    tiles = q
    geo = st.stream_geometry(q, n, 1, blocks, None, 132, st.STREAM_PQ_ROWS)
    assert geo.chunk_rows >= min(st.STREAM_PQ_ROWS, n)
    assert geo.chunk_rows % st.STREAM_ROWS == 0
    assert 1 <= geo.n_chunks <= 65535
    assert geo.n_chunks * geo.chunk_rows >= n > (geo.n_chunks - 1) * \
        geo.chunk_rows
    assert geo.n_chunks * tiles <= max(132 * blocks, tiles)
    if n <= st.STREAM_PQ_ROWS:
        assert geo.n_chunks == 1
    if n == 41_829 and blocks == 4:
        assert geo.chunk_rows == st.STREAM_PQ_ROWS and geo.n_chunks == 41
    if n == _MAIN and q == 1:
        assert geo.n_chunks > 132 * blocks - 10


def test_stream_geometry_keeps_a_given_block_n_and_refuses_bad_tiles():
    """A tuned block_n is kept, rounded up to whole mask words; a query
    tile outside [1, 8] or no block per SM is refused, and so is a plan's
    cap outside [1, 8] before the library is asked."""
    st = ops._st
    geo = st.stream_geometry(3, 2081, 3, 1, 100, 132)
    assert geo.chunk_rows == 128 and geo.n_chunks == 17
    assert st.stream_geometry(1, 10, 1, 2, None, 132) == (1, 128, 1)
    for qt, blocks in ((0, 1), (9, 1), (1, 0)):
        with pytest.raises(ValueError):
            st.stream_geometry(1, 100, qt, blocks, None, 132)
    for min_rows in (0, 100):
        with pytest.raises(ValueError):
            st.stream_geometry(1, 100, 1, 1, None, 132, min_rows)
    for cap in (0, 9):
        with pytest.raises(ValueError):
            st.stream_plan(cap, 128, 10)


@pytest.mark.parametrize("q,n,m,k", PQ_LAUNCHES)
def test_pq_geometry_fits_the_card(q, n, m, k):
    """Kernel 8's grid on an H100 for the plan's query tile (5 queries of
    32 KB LUTs at M = 32, at most 8): row chunks of whole mask words and at
    least one 512-row tile and k rows each, covering the n rows, and at
    most one block per SM in all (one wave) where the query tiles allow.
    (test_pq_plan_fits_shared_memory holds the tile on the card.)"""
    st = ops._st
    qt = min(q, 5 if m <= 32 else 1)
    geo = st.tiled_geometry("pq", q, n, k, qt, None, 132)
    assert geo.chunk_rows % 32 == 0
    assert geo.chunk_rows >= max(k, st.TILE_R["pq"])
    assert 1 <= geo.n_chunks <= 65535
    assert geo.n_chunks * geo.chunk_rows >= n > (geo.n_chunks - 1) * \
        geo.chunk_rows
    tiles = -(-q // qt)
    assert geo.n_chunks * tiles <= max(132, tiles)
    if n == _MAIN:
        assert (tiles, geo.n_chunks) == (13, 10)


@pytest.mark.parametrize("nq,n_lists,max_aligned,qt,chunk", [
    (64, 64, 70_240, 8, 4096), (44, 64, 70_240, 8, 4096), (1, 1, 32, 1, 4096),
    (5, 5, 0, 5, 4096), (9, 3, 4096, 8, 4096), (300, 2, 4097, 4, 4096)])
def test_list_grid_covers_every_list_chunk(nq, n_lists, max_aligned, qt,
                                           chunk):
    """Kernel 9's list-form grid: a list is probed at most once per query,
    so ceil(nq / qt) query tiles per list hold all its queries, and cmax
    chunks of ``chunk`` positions cover the widest list (one chunk when
    every list is empty); blocks = lists x tiles x cmax, within the grid's
    limits (x < 2^31, y <= 65535)."""
    st = ops._st
    tiles, cmax, blocks = st.list_grid(nq, n_lists, max_aligned, qt, chunk)
    assert tiles * qt >= nq > (tiles - 1) * qt
    assert cmax * chunk >= max_aligned > (cmax - 1) * chunk or \
        (max_aligned == 0 and cmax == 1)
    assert blocks == n_lists * tiles * cmax
    assert n_lists * tiles < 2 ** 31 and cmax <= 65535


def test_pass2_groups_split_few_queries_many_lists():
    """Pass 2's first level: one block per ~32 lists while the queries
    leave most of the card idle (kernel 5's q = 1 over 396 lists: 12),
    a single level when they fill it or have few lists, never more blocks
    than one wave."""
    st = ops._st
    assert st.pass2_groups(1, 396, 132) == 12
    assert st.pass2_groups(1, 262, 132) == 8
    assert st.pass2_groups(1, 40, 132) == 1
    assert st.pass2_groups(100, 396, 132) == 1
    for nq, lists in ((1, 10_000), (5, 327), (64, 400)):
        g = st.pass2_groups(nq, lists, 132)
        assert 1 <= g and nq * g <= 132 and g <= max(1, lists // 32)
