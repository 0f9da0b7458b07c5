"""The port's IVF executor against the reference's, kernel 9 included.

Same numpy data through both packages. Here on the CPU the port runs the
plain PyTorch versions of its kernels (``device="cpu"``).

* Kernel 9 (``ivf_gather_topk``): the port's plain version against the
  Pallas kernel in interpret mode (``repro.kernels.ops.ivf_gather_topk``)
  and the numpy oracle (``repro.kernels.ref.ivf_gather_topk_ref``); its
  fp32 / int8 / PQ modes against the reference's jnp twins
  (``_ivf_batch_jnp``, ``_ivf_batch_i8``, ``_ivf_batch_pq``). Ids are equal
  on filled lanes, or tie-aware through ``topk_disagreement`` where the
  reference sums in another order; scores within rtol = atol = 1e-5; int8
  scores are exact in both and compared bit for bit.
* K-means: the port's ``_lloyd`` / ``_assign`` against the reference's on
  the same data and init, centers within 1e-5 and equal assignments.
* The index: the reference's partitions handed to the port through
  ``convert.ivf_from_state`` (torch and XLA k-means round differently), the
  same probed candidate sets, and ``search_multi`` / ``dsq_batch`` within
  the tolerance above at fp32, int8 and PQ. Inside the port ``dsq_batch``
  equals a loop of ``dsq`` bit for bit.

The data follow ``tests/test_ivf_batch.py``: ``make_wiki_dir(scale=0.0015,
dim=32)`` and 16 lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.vectordb import DirectoryVectorDB as RefDB  # noqa: E402
from repro.vectordb import ivf as jivf  # noqa: E402
from repro.vectordb.quant import quantize_rows as ref_quantize  # noqa: E402
from repro_torch.datasets import make_wiki_dir  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import topk_disagreement  # noqa: E402
from repro_torch.vectordb import (DirectoryVectorDB, IVFIndex,  # noqa: E402
                                  ivf_from_state)
from repro_torch.vectordb import ivf as pivf  # noqa: E402
from repro_torch.vectordb.quant import quantize_rows  # noqa: E402

NEG_INF = float(np.finfo(np.float32).min)
TOL = 1e-5
DIM = 32
N_LISTS = 16
PRECISIONS = ("fp32", "int8", "pq")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pack(dense: np.ndarray) -> np.ndarray:
    """(S, n) bool -> (S, ceil(n/32)) little-endian uint32 words."""
    pad = (-dense.shape[1]) % 32
    return np.stack([np.packbits(np.pad(m, (0, pad)), bitorder="little")
                     .view(np.uint32) for m in dense])


def _wiki():
    return make_wiki_dir(scale=0.0015, dim=DIM, n_queries=12, seed=5)


def _pair(metric="ip"):
    """A reference database with flat and IVF executors, and a port one
    over the same rows holding the reference's partitions."""
    ds = _wiki()
    rdb = RefDB(dim=DIM, metric=metric, scope_strategy="triehi",
                calibration=False)
    rdb.ingest(ds.vectors, ds.entry_paths)
    rdb.build_ann("flat")
    rdb.build_ann("ivf", n_lists=N_LISTS)
    pdb = DirectoryVectorDB(dim=DIM, metric=metric, scope_strategy="triehi",
                            calibration=False, device="cpu")
    pdb.ingest(ds.vectors, ds.entry_paths)
    pdb.build_ann("flat")
    r = rdb.executors["ivf"]
    ivf_from_state(pdb, r.centers, r.lists, r.repartition_gen)
    return ds, rdb, pdb


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _mixed(ds, B):
    paths = [ds.query_anchors[i % 4] for i in range(B)]
    paths[0] = "/"                              # one broad scope in the mix
    rec = [bool(ds.query_recursive[i % 4]) for i in range(B)]
    return paths, rec


def _assert_bitwise(a, b, label):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x.ids, y.ids, err_msg=f"{label} {i}")
        np.testing.assert_array_equal(x.scores, y.scores,
                                      err_msg=f"{label} {i}")
        assert x.scope_size == y.scope_size, (label, i)


def _assert_close(ids, scores, ref_ids, ref_scores, label):
    ref_ids = np.asarray(ref_ids, np.int64)
    ref_scores = np.asarray(ref_scores, np.float32)
    ref_ids = np.where(np.isfinite(ref_scores), ref_ids, -1)
    err = topk_disagreement(ids, scores, ref_ids, ref_scores, TOL)
    assert err is None, f"{label}: {err}"
    assert np.all(np.asarray(scores)[np.asarray(ids) < 0] == -np.inf), label


# ------------------------------------------------------------- kernel 9
def _gather_case(b, c, d, n, seed, pad=0.1, density=0.5):
    """Per-query candidates drawn without repeats (as IVF lists hold each
    row once), -1 padding, a packed scope row per query, and a position
    tie: query 0's rows at positions 2 and 5 are equal, the later one with
    the lower store id."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:c] for _ in range(b)]).astype(
        np.int32)
    cand[rng.random((b, c)) < pad] = -1
    dense = rng.random((b, n)) < density
    if c >= 6 and pad < 1.0:
        hi, lo = max(cand[0, 2], cand[0, 5]), min(cand[0, 2], cand[0, 5])
        if lo < 0:
            hi, lo = n - 1, n - 2
        cand[0, 2], cand[0, 5] = hi, lo
        X[lo] = X[hi]
        dense[0, [lo, hi]] = True
    return Q, X, cand, dense


def _assert_filled(port, jax_out, label):
    """Empty lanes are the JAX side's ``finfo.min`` lanes (the Pallas merge
    leaves a repeated id there, ROADMAP queue 3): there the port holds
    exactly (finfo.min, -1); filled lanes hold the same ids and values
    within 1e-5."""
    pv, pi = (np.asarray(a) for a in port)
    jv, ji = (np.asarray(a) for a in jax_out)
    empty = jv <= NEG_INF
    assert np.all(pv[empty] == NEG_INF) and np.all(pi[empty] == -1), label
    np.testing.assert_array_equal(pi[~empty], ji[~empty], err_msg=label)
    np.testing.assert_allclose(pv[~empty], jv[~empty], rtol=TOL, atol=TOL,
                               err_msg=label)


@pytest.mark.parametrize("b,c,d,n,k,metric,pad", [
    (1, 128, 32, 512, 4, "ip", 0.1),
    (4, 640, 64, 2000, 10, "ip", 0.3),
    (3, 1000, 16, 1500, 8, "l2", 0.1),       # C not a block multiple
    (5, 37, 16, 300, 40, "l2", 0.5),         # k > admitted candidates
    (2, 1, 8, 64, 3, "ip", 0.0),             # C = 1
    (3, 96, 8, 400, 5, "ip", 1.0),           # all padding
])
def test_ivf_gather_topk_matches_jax(b, c, d, n, k, metric, pad):
    Q, X, cand, dense = _gather_case(b, c, d, n, seed=b * 31 + c, pad=pad)
    qwords = _pack(dense)
    port = ops.ivf_gather_topk(_t(Q), _t(X), _t(cand), _t(qwords.view(
        np.int32)), torch.arange(b, dtype=torch.int32), k, metric)
    rows = X[np.maximum(cand, 0)]
    _assert_filled(port, jops.ivf_gather_topk(Q, rows, cand, qwords, k=k,
                                              metric=metric,
                                              interpret=True),
                   f"pallas b{b} c{c} {metric}")
    rv, ri = jref.ivf_gather_topk_ref(Q, rows, cand, qwords, k=k,
                                      metric=metric)
    kk = ri.shape[1]                         # the oracle stops at C lanes
    np.testing.assert_array_equal(port[1].numpy()[:, :kk], ri)
    assert np.all(port[1].numpy()[:, kk:] == -1)
    np.testing.assert_allclose(port[0].numpy()[:, :kk], rv, rtol=TOL,
                               atol=TOL)
    if pad == 1.0:
        assert np.all(port[1].numpy() == -1)
    if c >= 6 and pad < 1.0:                 # ties fall to the position
        ids = port[1].numpy()[0].tolist()
        hi, lo = cand[0, 2], cand[0, 5]
        if hi in ids and lo in ids:
            assert ids.index(hi) < ids.index(lo)


def _single_list_layout(Q, cand, n):
    """A reference CSR layout whose center b is query b and whose list b
    is ``cand[b]`` (padding -> the reference's sentinel n): at nprobe = 1
    each query probes exactly its own candidate row."""
    B, C = cand.shape
    flat = np.concatenate([np.where(cand >= 0, cand, n).reshape(-1), [n]])
    return (jnp.asarray(Q), jnp.asarray(np.arange(B, dtype=np.int32) * C),
            jnp.asarray(np.full(B, C, np.int32)),
            jnp.asarray(flat.astype(np.int32)))


@pytest.mark.parametrize("tier", ["fp32", "int8", "pq"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_ivf_modes_match_reference_jnp_twins(tier, metric):
    """The gathered fp32 / int8 / PQ modes against ``_ivf_batch_jnp`` /
    ``_ivf_batch_i8`` / ``_ivf_batch_pq``, fed the same candidates through
    a one-list-per-query layout, with two scopes."""
    from repro.vectordb.quant import PQCodebook as RefCodebook
    from repro_torch.vectordb.quant import PQCodebook
    b, c, d, n, k = 6, 200, 32, 700, 12
    Q, X, cand, dense = _gather_case(b, c, d, n, seed=7, pad=0.2)
    Q = Q * 3.0                              # queries far from each other
    words = _pack(dense[:2])
    sids = np.array([0, 1, 0, 1, 1, 0], np.int32)
    centers, offsets, aligned, flat = _single_list_layout(Q, cand, n)
    jw, js = jnp.asarray(words), jnp.asarray(sids)
    tw, ts, tc = _t(words.view(np.int32)), _t(sids), _t(cand)
    if tier == "fp32":
        sq = np.einsum("nd,nd->n", X, X).astype(np.float32)
        want = jivf._ivf_batch_jnp(
            jnp.asarray(Q), centers, offsets, aligned, flat, jnp.asarray(X),
            jnp.asarray(sq), jw, js, k=k, nprobe=1, max_aligned=c,
            metric=metric)
        got = ops.ivf_gather_topk(_t(Q), _t(X), tc, tw, ts, k, metric,
                                  sq=_t(sq))
    elif tier == "int8":
        qi, qs = quantize_rows(Q)
        xi, xs = quantize_rows(X)
        for a, r in zip((qi, qs, xi, xs), (*ref_quantize(Q),
                                           *ref_quantize(X))):
            np.testing.assert_array_equal(a, r)
        codes = xi.astype(np.int32)
        sq = np.einsum("nd,nd->n", codes, codes).astype(np.float32) * xs * xs
        want = jivf._ivf_batch_i8(
            jnp.asarray(Q), jnp.asarray(qi), jnp.asarray(qs), centers,
            offsets, aligned, flat, jnp.asarray(xi), jnp.asarray(xs),
            jnp.asarray(sq), jw, js, k=k, nprobe=1, max_aligned=c,
            metric=metric)
        got = ops.ivf_gather_topk_i8(_t(qi), _t(qs), _t(xi), _t(xs),
                                     _t(sq), tc, tw, ts, k, metric)
    else:
        cb, rcb = PQCodebook(d, 8, seed=1), RefCodebook(d, 8, seed=1)
        cb.train(X)
        rcb.train(X)
        lut, codes = cb.lut(Q, metric), cb.encode(X)
        np.testing.assert_array_equal(lut, rcb.lut(Q, metric))
        want = jivf._ivf_batch_pq(
            jnp.asarray(Q), jnp.asarray(lut), centers, offsets, aligned,
            flat, jnp.asarray(codes), jw, js, k=k, nprobe=1, max_aligned=c)
        got = ops.ivf_gather_topk_pq(_t(lut), _t(codes), tc, tw, ts, k)
    wv, wi = (np.asarray(a) for a in want)
    gv, gi = got[0].numpy(), got[1].numpy().astype(np.int64)
    wi = np.where(np.isfinite(wv), wi, -1)
    assert np.any(gi >= 0)
    if tier == "int8":                       # exact integer dots in both
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv[gi >= 0], wv[wi >= 0])
    else:
        wv = np.where(wi >= 0, wv, NEG_INF)
        err = topk_disagreement(gi, gv, wi, wv, TOL)
        assert err is None, f"{tier} {metric}: {err}"


def test_plain_kernel_ranks_ties_by_position_not_id():
    """Equal scores at positions 0..3 with descending store ids come back
    in position order (jax.lax.top_k over the candidate axis), not in id
    order."""
    X = np.ones((8, 4), np.float32)
    cand = np.array([[7, 5, 3, 1]], np.int32)
    words = _pack(np.ones((1, 8), bool))
    vals, ids = ops.ivf_gather_topk(_t(np.ones((1, 4), np.float32)), _t(X),
                                    _t(cand), _t(words.view(np.int32)),
                                    torch.zeros(1, dtype=torch.int32), 4)
    assert ids.tolist() == [[7, 5, 3, 1]]
    assert torch.all(vals == 4.0)
    # a scope id outside the mask matrix admits nothing, as in the kernel
    vals, ids = ops.ivf_gather_topk(_t(np.ones((1, 4), np.float32)), _t(X),
                                    _t(cand), _t(words.view(np.int32)),
                                    torch.ones(1, dtype=torch.int32), 4)
    assert ids.tolist() == [[-1] * 4] and torch.all(vals == NEG_INF)


# ------------------------------------------------- kernel 9, list form
def _list_case(b, sizes, nprobe, n, d, seed, metric, density=0.5,
               inner_pad=0.0):
    """A padded-CSR layout of n rows: list c holds ``sizes[c]`` distinct
    rows in ascending id order (a share ``inner_pad`` of its slots then
    turned to -1), padded with -1 to a multiple of 32, and the final -1
    slot; ``nprobe`` distinct lists per query; two scopes, query b taking
    scope b % 2 and the last query (b > 2) a scope id out of range. Query
    0's first two probed lists hold a tie that list order and id order
    rank differently: the first holds id hi, the second id lo < hi, both
    rows admitted and the query's best (the query itself for l2, 4x it
    for ip). Where ``nprobe`` lists are
    empty, query 1 probes only those."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    perm = rng.permutation(n)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    lists = [np.sort(perm[bounds[c]:bounds[c + 1]])
             for c in range(len(sizes))]
    aligned = np.array([-(-len(m) // 32) * 32 for m in lists], np.int64)
    offsets = np.concatenate([[0], np.cumsum(aligned)[:-1]]).astype(np.int64)
    flat = np.full(int(aligned.sum()) + 1, -1, np.int32)
    for c, m in enumerate(lists):
        flat[offsets[c]:offsets[c] + len(m)] = m
        drop = rng.random(len(m)) < inner_pad
        flat[offsets[c]:offsets[c] + len(m)][drop] = -1
    probe = np.stack([rng.choice(len(sizes), nprobe, replace=False)
                      for _ in range(b)]).astype(np.int32)
    empty = np.flatnonzero(np.asarray(sizes) == 0)
    if b > 1 and len(empty) >= nprobe:            # query 1 finds nothing
        probe[1] = empty[:nprobe]
    dense = rng.random((2, n)) < density
    sids = (np.arange(b) % 2).astype(np.int32)
    if b > 2:
        sids[-1] = 5                              # out of range: no rows
    p0, p1 = (flat[offsets[c]:offsets[c] + aligned[c]] for c in probe[0, :2])
    p0, p1 = p0[p0 >= 0], p1[p1 >= 0]
    if len(p0) and len(p1) and p0.max() > p1.min():
        hi, lo = int(p0.max()), int(p1.min())
        X[hi] = X[lo] = Q[0] * (1.0 if metric == "l2" else 4.0)
        dense[sids[0], [hi, lo]] = True
    return Q, X, (offsets, aligned, flat, int(aligned.max())), probe, \
        dense, sids


def _skewed(n_lists, n, seed):
    """List sizes of k-means on skewed data: a few wide lists, a long
    tail, one empty list."""
    w = 1.0 / (1.0 + np.arange(n_lists)) ** 0.8
    w = np.random.default_rng(seed).permutation(w)
    sizes = np.floor(w / w.sum() * n * 0.9).astype(int)
    sizes[np.argmin(sizes)] = 0
    return sizes


LIST_CASES = [                  # b, sizes, nprobe, n, d, k, metric
    (4, _skewed(8, 900, 0), 3, 900, 16, 10, "ip"),
    (6, _skewed(12, 3000, 1), 4, 3000, 32, 40, "l2"),
    (3, [0, 0, 70, 200], 2, 400, 8, 5, "ip"),     # empty probes
    (2, [33, 64, 1], 3, 100, 13, 50, "l2"),       # k past the admitted
]


@pytest.mark.parametrize("tier", ["fp32", "int8", "pq"])
@pytest.mark.parametrize("case", range(len(LIST_CASES)))
def test_ivf_probe_topk_matches_cand_form_and_jax(case, tier):
    """Kernel 9's list form (``ivf_probe_topk*``) against its candidate
    form on the expanded (B, nprobe * max_aligned) matrix and against the
    JAX package on the same candidates: the Pallas ``ivf_gather_topk`` in
    interpret mode (fp32), the jnp twins ``_ivf_batch_i8`` /
    ``_ivf_batch_pq`` (int8, PQ). Covers -1 padding inside and after a
    list, skewed and empty lists, a query whose probed lists are all
    empty, a scope id out of range and the cross-list tie, which falls to
    the earlier-probed list's (higher) id."""
    from repro.vectordb.quant import PQCodebook as RefCodebook
    from repro_torch.vectordb.quant import PQCodebook
    b, sizes, nprobe, n, d, k, metric = LIST_CASES[case]
    Q, X, (off, al, flat, ma), probe, dense, sids = _list_case(
        b, sizes, nprobe, n, d, case, metric, inner_pad=0.1)
    words = _pack(dense)
    tw, ts = _t(words.view(np.int32)), _t(sids)
    lay = (_t(off), _t(al), _t(flat), ma)
    cand = pivf._expand(pivf.CSRLayout(*lay, n), _t(probe.astype(np.int64)))
    C = cand.shape[1]
    if tier == "fp32":
        sq = np.einsum("nd,nd->n", X, X).astype(np.float32)
        listed = ops.ivf_probe_topk(_t(Q), _t(X), *lay, _t(probe), tw, ts,
                                    k, metric, sq=_t(sq))
        cform = ops.ivf_gather_topk(_t(Q), _t(X), cand, tw, ts, k, metric,
                                    sq=_t(sq))
    elif tier == "int8":
        qi, qs = quantize_rows(Q)
        xi, xs = quantize_rows(X)
        c32 = xi.astype(np.int32)
        sq = np.einsum("nd,nd->n", c32, c32).astype(np.float32) * xs * xs
        args = (_t(qi), _t(qs), _t(xi), _t(xs), _t(sq))
        listed = ops.ivf_probe_topk_i8(*args, *lay, _t(probe), tw, ts, k,
                                       metric)
        cform = ops.ivf_gather_topk_i8(*args, cand, tw, ts, k, metric)
    else:
        cb, rcb = PQCodebook(d, 4 if d % 4 == 0 else 1, seed=1), \
            RefCodebook(d, 4 if d % 4 == 0 else 1, seed=1)
        cb.train(X)
        rcb.train(X)
        lut, codes = cb.lut(Q, metric), cb.encode(X)
        listed = ops.ivf_probe_topk_pq(_t(lut), _t(codes), *lay, _t(probe),
                                       tw, ts, k)
        cform = ops.ivf_gather_topk_pq(_t(lut), _t(codes), cand, tw, ts, k)
    # the two forms are one contract: equal bit for bit
    assert torch.equal(listed[1], cform[1]) and torch.equal(listed[0],
                                                             cform[0])
    gv, gi = listed[0].numpy(), listed[1].numpy().astype(np.int64)
    if b > 2:
        assert np.all(gi[-1] == -1) and np.all(gv[-1] == NEG_INF)
    if case == 2:                             # query 1's lists are empty
        assert np.all(gi[1] == -1) and np.any(gi >= 0)
    cn = cand.numpy()
    if tier == "fp32":
        qwords = words[np.where(sids < 2, sids, 0)]
        qwords[sids >= 2] = 0
        rows = X[np.maximum(cn, 0)]
        want = jops.ivf_gather_topk(Q, rows, cn, qwords, k=k, metric=metric,
                                    interpret=True)
        _assert_filled(listed, want, f"list case {case} {metric}")
        ids = gi[0].tolist()
        p0 = flat[off[probe[0, 0]]:off[probe[0, 0]] + al[probe[0, 0]]]
        p1 = flat[off[probe[0, 1]]:off[probe[0, 1]] + al[probe[0, 1]]]
        p0, p1 = p0[p0 >= 0], p1[p1 >= 0]
        if len(p0) and len(p1) and p0.max() > p1.min():
            hi, lo = int(p0.max()), int(p1.min())
            assert ids[:2] == [hi, lo], (ids[:2], hi, lo)
        return
    centers, offsets, aligned, flat1 = _single_list_layout(Q, cn, n)
    jw, js = jnp.asarray(words), jnp.asarray(sids)
    if tier == "int8":
        want = jivf._ivf_batch_i8(
            jnp.asarray(Q), jnp.asarray(qi), jnp.asarray(qs), centers,
            offsets, aligned, flat1, jnp.asarray(xi), jnp.asarray(xs),
            jnp.asarray(sq), jw, js, k=min(k, C), nprobe=1, max_aligned=C,
            metric=metric)
    else:
        want = jivf._ivf_batch_pq(
            jnp.asarray(Q), jnp.asarray(lut), centers, offsets, aligned,
            flat1, jnp.asarray(codes), jw, js, k=min(k, C), nprobe=1,
            max_aligned=C)
    # the jnp twins clamp a scope id out of range (the port's kernels
    # admit nothing there, checked above): compared on the other queries
    ok = sids < 2
    wv, wi = (np.asarray(a)[ok] for a in want)
    gv, gi = gv[ok], gi[ok]
    wi = np.where(np.isfinite(wv) & (wv > NEG_INF), wi, -1)
    kk = wi.shape[1]
    assert np.all(gi[:, kk:] == -1)
    if tier == "int8":                        # exact integer dots in both
        np.testing.assert_array_equal(gi[:, :kk], wi)
        np.testing.assert_array_equal(gv[:, :kk][wi >= 0], wv[wi >= 0])
    else:
        wv = np.where(wi >= 0, wv, NEG_INF)
        err = topk_disagreement(gi[:, :kk], gv[:, :kk], wi, wv, TOL)
        assert err is None, f"pq case {case}: {err}"


# -------------------------------------------------------------- k-means
@pytest.mark.parametrize("seed", [0, 1])
def test_lloyd_and_assign_match_reference(seed):
    """Blobs with a margin, so fp32 rounding in either package cannot move
    a row to another center: equal assignments, centers within 1e-5; an
    init center far from every row stays where it is (empty cluster)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(6, 8)).astype(np.float32) * 8.0
    data = (means[rng.integers(0, 6, size=600)]
            + rng.normal(size=(600, 8)).astype(np.float32))
    init = data[rng.choice(600, size=7, replace=False)].copy()
    init[6] = 1e3                                     # stays empty
    mine = pivf._lloyd(_t(data), _t(init), 10).numpy()
    theirs = np.asarray(jivf._lloyd(jnp.asarray(data), jnp.asarray(init),
                                    n_iters=10))
    np.testing.assert_allclose(mine, theirs, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(mine[6], init[6])
    np.testing.assert_array_equal(
        pivf._assign(_t(data), _t(mine)).numpy(),
        np.asarray(jivf._assign(jnp.asarray(data), jnp.asarray(theirs))))
    # ties go to the lower center index in both
    dup = np.stack([mine[0], mine[0]])
    assert int(pivf._assign(_t(mine[:1]), _t(dup))[0]) == 0


def test_probe_is_batch_invariant_and_equals_reference(pair):
    """A query's probe distances are bitwise the same alone and in a batch,
    and the expanded candidates equal the reference's (padding -1)."""
    ds, rdb, pdb = pair
    r, p = rdb.executors["ivf"], pdb.executors["ivf"]
    q = _t(ds.queries.astype(np.float32))
    cen = _t(np.array(r.centers))
    full = pivf.probe_distances(q, cen)
    for i in range(q.shape[0]):
        assert torch.equal(pivf.probe_distances(q[i:i + 1], cen)[0],
                           full[i])
    lay, rlay = p.layout(), r.layout()
    assert lay.max_aligned == rlay.max_aligned
    for nprobe in (1, 6, N_LISTS):
        got = pivf._expand(lay, pivf._probe(q, cen, nprobe)).numpy()
        want = np.asarray(jivf._probe_and_expand(
            jnp.asarray(ds.queries), jnp.asarray(r.centers), rlay.offsets,
            rlay.aligned, rlay.flat_ids, nprobe, rlay.max_aligned))
        np.testing.assert_array_equal(got, np.where(want < len(rdb.store),
                                                    want, -1))


# ----------------------------------------------------------- the index
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", ["ip", "l2", "cos"])
def test_search_multi_matches_reference(metric, precision):
    """Two scopes and tombstones through ``search_multi`` at nprobe 6 and
    every list, against the reference's jnp path."""
    ds, rdb, pdb = _pair(metric)
    n = len(rdb.store)
    for v in (3, 17, 40):
        rdb.delete(v)
        pdb.delete(v)
    dense = np.zeros((2, n), bool)
    dense[0, ::2] = True
    dense[1] = True
    words = _pack(dense)
    q = ds.queries.astype(np.float32)
    sids = (np.arange(len(q)) % 2).astype(np.int32)
    r, p = rdb.executors["ivf"], pdb.executors["ivf"]
    for nprobe in (6, N_LISTS):
        s1, i1 = p.search_multi(q, words, sids, 10, nprobe=nprobe,
                                precision=precision)
        s2, i2 = r.search_multi(q, words, sids, 10, nprobe=nprobe,
                                use_pallas=False, precision=precision)
        _assert_close(i1, s1, i2, s2, f"{metric} {precision} {nprobe}")
        assert not ({3, 17, 40} & set(i1.ravel().tolist()))
        assert np.all(i1[sids == 0][i1[sids == 0] >= 0] % 2 == 0)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_dsq_batch_equals_loop_and_reference(pair, precision):
    """One launch for the batch, bitwise equal to a loop of dsq, plans
    labelled ``ivf``, and the reference's ids within tolerance, with its
    launch and rescore accounting."""
    ds, rdb, pdb = pair
    B = len(ds.queries)
    paths, rec = _mixed(ds, B)
    kw = dict(k=10, executor="ivf", nprobe=6, precision=precision)
    pb = pdb.dsq_batch(ds.queries, paths, recursive=rec, **kw)
    rb = rdb.dsq_batch(ds.queries, paths, recursive=rec, **kw)
    loop = [pdb.dsq(ds.queries[i], paths[i], recursive=rec[i], **kw)
            for i in range(B)]
    _assert_bitwise(pb, loop, f"{precision} batch vs loop")
    pa, ra = pb[0].batch, rb[0].batch
    assert pa.launches == 1
    for key in ("launches", "rescore_candidates", "precision_groups",
                "plan_groups", "unique_scopes", "batch_size"):
        assert getattr(pa, key) == getattr(ra, key), key
    for i in range(B):
        assert pb[i].plan == rb[i].plan == (
            "ivf" if pb[i].scope_size else "empty")
        assert pb[i].scope_size == rb[i].scope_size
        _assert_close(pb[i].ids, pb[i].scores, rb[i].ids, rb[i].scores,
                      f"{precision} {i}")


def test_dsq_batch_default_and_per_request_nprobe(pair):
    """No nprobe takes the cost model's default in batch and loop alike; a
    per-request sequence takes one launch per distinct value."""
    ds, rdb, pdb = pair
    B = 8
    paths, rec = _mixed(ds, B)
    q = ds.queries[:B]
    default = pdb.dsq_batch(q, paths, k=10, recursive=rec, executor="ivf")
    _assert_bitwise(default, [pdb.dsq(q[i], paths[i], k=10,
                                      recursive=rec[i], executor="ivf")
                              for i in range(B)], "default nprobe")
    assert default[0].batch.launches == 1
    npr = [4] * 4 + [8] * 4
    batch = pdb.dsq_batch(q, paths, k=10, recursive=rec, executor="ivf",
                          nprobe=npr)
    assert batch[0].batch.launches == 2
    _assert_bitwise(batch, [pdb.dsq(q[i], paths[i], k=10, recursive=rec[i],
                                    executor="ivf", nprobe=npr[i])
                            for i in range(B)], "per-request nprobe")
    with pytest.raises(ValueError, match="nprobe"):
        pdb.dsq_batch(q, paths, k=10, executor="ivf", nprobe=[4, 8])


def test_unplannable_param_reaches_the_executor(pair):
    ds, _, pdb = pair
    with pytest.raises(TypeError):
        pdb.dsq_batch(ds.queries[:2], ["/", "/"], k=5, executor="ivf",
                      bogus_param=1)


def test_exhaustive_probe_equals_flat(pair):
    """Probing every list is an exact scoped search: the flat executor's
    ids, tie-aware, and its scores within 1e-5."""
    ds, _, pdb = pair
    B = len(ds.queries)
    paths, rec = _mixed(ds, B)
    ivf = pdb.dsq_batch(ds.queries, paths, k=10, recursive=rec,
                        executor="ivf", nprobe=N_LISTS)
    flat = pdb.dsq_batch(ds.queries, paths, k=10, recursive=rec)
    for i in range(B):
        _assert_close(ivf[i].ids, ivf[i].scores, flat[i].ids,
                      flat[i].scores, f"request {i}")


def test_search_matches_host_loop_oracle(pair):
    """The device path against the per-query numpy oracle, scoped and
    unscoped: same members, scores within 1e-5."""
    ds, _, pdb = pair
    p = pdb.executors["ivf"]
    q = ds.queries.astype(np.float32)
    cand = np.arange(0, len(pdb.store), 3, dtype=np.uint32)
    for ids in (None, cand):
        s1, i1 = p.search(q, 10, candidate_ids=ids, nprobe=6)
        s2, i2 = p.search_loop(q, 10, candidate_ids=ids, nprobe=6)
        _assert_close(i1, s1, i2, s2, "oracle")
    assert np.all(i1[i1 >= 0] % 3 == 0)


def test_tombstones_never_surface():
    ds, rdb, pdb = _pair()
    q = ds.queries[:4].astype(np.float32)
    _, ids0 = pdb.executors["ivf"].search(q, 10, nprobe=8)
    victims = [int(x) for x in ids0[0][ids0[0] >= 0][:3]]
    for v in victims:
        pdb.delete(v)
        rdb.delete(v)
    for prec in PRECISIONS:
        s, ids = pdb.executors["ivf"].search(q, 10, precision=prec)
        assert not (set(victims) & set(ids.ravel().tolist())), prec
        rs, rids = rdb.executors["ivf"].search(q, 10, precision=prec)
        _assert_close(ids, s, rids, rs, prec)
        batch = pdb.dsq_batch(q, ["/"] * len(q), k=10, executor="ivf",
                              precision=prec)
        got = {int(x) for r in batch for x in r.ids.ravel() if x >= 0}
        assert not (set(victims) & got), prec


def test_add_routes_rows_like_the_reference():
    """Ingest after the build: the port routes the new rows through its
    own assign into amortized lists, the same lists as the reference, and
    the layout follows the store size."""
    ds = _wiki()
    n0 = ds.n_entries // 4
    rdb = RefDB(dim=DIM, calibration=False)
    rdb.ingest(ds.vectors[:n0], ds.entry_paths[:n0])
    rdb.build_ann("ivf", n_lists=8)
    pdb = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu")
    pdb.ingest(ds.vectors[:n0], ds.entry_paths[:n0])
    r = rdb.executors["ivf"]
    p = ivf_from_state(pdb, r.centers, r.lists)
    step = max(1, (ds.n_entries - n0) // 7)
    for lo in range(n0, ds.n_entries, step):
        hi = min(lo + step, ds.n_entries)
        rdb.ingest(ds.vectors[lo:hi], ds.entry_paths[lo:hi])
        pdb.ingest(ds.vectors[lo:hi], ds.entry_paths[lo:hi])
    for mine, theirs in zip(p.lists, r.lists):
        np.testing.assert_array_equal(mine, theirs)
    members = np.sort(np.concatenate(p.lists))
    assert np.array_equal(members, np.arange(ds.n_entries, dtype=np.uint32))
    assert any(len(d) > ln for d, ln in zip(p._data, p._len))  # capacity
    assert p.layout().n == len(pdb.store)
    assert p.partition_stats() == r.partition_stats()
    res = pdb.dsq(ds.queries[0], "/", k=10, executor="ivf", nprobe=8)
    assert (res.ids[0] >= 0).sum() == 10


def test_repartition_replays_bitwise_and_remap_matches_reference():
    """``repartition`` on two identical port databases gives bitwise equal
    centers and lists (the replay contract), drops tombstoned rows and keeps
    batch == loop; ``remap_ids`` rewrites the lists as the reference's
    does."""
    dbs = []
    for _ in range(2):
        ds, rdb, pdb = _pair()
        for v in range(0, 300, 7):
            pdb.delete(v)
        dbs.append(pdb)
    outs = [d.executors["ivf"].repartition(seed=3, sample=1500)
            for d in dbs]
    a, b = (d.executors["ivf"] for d in dbs)
    assert outs[0] == outs[1] and outs[0]["gen"] == 1
    np.testing.assert_array_equal(a.centers, b.centers)
    for x, y in zip(a.lists, b.lists):
        np.testing.assert_array_equal(x, y)
    kept = np.concatenate(a.lists)
    assert not np.isin(np.arange(0, 300, 7), kept).any()
    assert len(kept) == len(dbs[0].store) - 43
    assert outs[0]["pad_waste_after"] == a.pad_waste()
    paths, rec = _mixed(ds, 8)
    _assert_bitwise(
        dbs[0].dsq_batch(ds.queries[:8], paths, k=10, recursive=rec,
                         executor="ivf"),
        [dbs[0].dsq(ds.queries[i], paths[i], k=10, recursive=rec[i],
                    executor="ivf") for i in range(8)], "after repartition")
    # remap through a compaction-shaped mapping, in both packages
    _, rdb, pdb = _pair()
    n = len(rdb.store)
    mapping = np.full(n, -1, np.int64)
    keep = np.arange(n) % 5 != 0
    mapping[keep] = np.arange(int(keep.sum()))
    r, p = rdb.executors["ivf"], pdb.executors["ivf"]
    r.remap_ids(mapping)
    p.remap_ids(mapping)
    for x, y in zip(p.lists, r.lists):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(p.assign, r.assign)
    assert p.pad_waste() == r.pad_waste()


def test_build_is_repeatable_and_close_to_reference():
    """The port's own k-means: two builds give bitwise equal centers and
    lists, and the partitions hold every row once."""
    ds = _wiki()
    dbs = []
    for _ in range(2):
        pdb = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu")
        pdb.ingest(ds.vectors, ds.entry_paths)
        pdb.build_ann("ivf", n_lists=N_LISTS, seed=0)
        dbs.append(pdb.executors["ivf"])
    np.testing.assert_array_equal(dbs[0].centers, dbs[1].centers)
    for x, y in zip(dbs[0].lists, dbs[1].lists):
        np.testing.assert_array_equal(x, y)
    members = np.sort(np.concatenate(dbs[0].lists))
    assert np.array_equal(members, np.arange(ds.n_entries, dtype=np.uint32))
    stats = dbs[0].partition_stats()
    assert stats["n_lists"] == N_LISTS
    assert stats["pad_waste"] == dbs[0].pad_waste()
    assert isinstance(dbs[0], IVFIndex)


def test_tiered_fp32_batch_equals_explicit_pq():
    """Past a device byte budget fp32 IVF requests take the PQ plan: the
    batch equals an explicit PQ batch bitwise, and the reference's."""
    ds, rdb, pdb = _pair()
    B = len(ds.queries)
    paths, rec = _mixed(ds, B)
    kw = dict(k=10, recursive=rec, executor="ivf", nprobe=6, rescore_k=40)
    explicit = pdb.dsq_batch(ds.queries, paths, precision="pq", **kw)
    for db in (pdb, rdb):
        db.store.set_device_budget(db.store.alive_nbytes() // 3)
    assert pdb.store.tiered_active()
    tiered = pdb.dsq_batch(ds.queries, paths, **kw)
    _assert_bitwise(tiered, explicit, "tiered vs explicit pq")
    assert tiered[0].batch.precision_groups.get("pq", 0) > 0
    rt = rdb.dsq_batch(ds.queries, paths, **kw)
    for i in range(B):
        _assert_close(tiered[i].ids, tiered[i].scores, rt[i].ids,
                      rt[i].scores, f"tiered {i}")
    assert (tiered[0].batch.rescore_fetch_bytes
            == rt[0].batch.rescore_fetch_bytes)


def test_dsm_between_batches_reresolves():
    """A merge between identical IVF batches re-resolves the cached scope
    masks exactly like per-request dsq."""
    ds, rdb, pdb = _pair()
    B = 8
    paths, rec = _mixed(ds, B)
    before = pdb.dsq_batch(ds.queries[:B], paths, k=8, recursive=rec,
                           executor="ivf", nprobe=4)
    src = next(p for p in paths if p != "/")
    pdb.rmdir(src)
    after = pdb.dsq_batch(ds.queries[:B], paths, k=8, recursive=rec,
                          executor="ivf", nprobe=4)
    loop = [pdb.dsq(ds.queries[i], paths[i], k=8, recursive=rec[i],
                    executor="ivf", nprobe=4) for i in range(B)]
    _assert_bitwise(after, loop, "after rmdir")
    for i in range(B):
        if paths[i] == src:
            assert after[i].scope_size == 0 < before[i].scope_size


def test_layout_checks_member_ids_once():
    """The CSR layout holds only ids in [-1, n) and rejects a member outside
    the store when it is built: the search launches, which skip the
    per-launch id check, read only ids that passed this one."""
    ds = _wiki()
    pdb = DirectoryVectorDB(dim=DIM, calibration=False, device="cpu")
    pdb.ingest(ds.vectors, ds.entry_paths)
    pdb.build_ann("ivf", n_lists=N_LISTS, seed=0)
    ix = pdb.executors["ivf"]
    flat = ix.layout().flat_ids
    assert int(flat.min()) == -1 and int(flat.max()) < len(pdb.store)
    ix._append(0, np.array([len(pdb.store)], dtype=np.uint32))
    ix._layout = None
    with pytest.raises(ValueError, match="outside"):
        ix.layout()
