"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: the kernels have no CPU mode, so without a CUDA device the
test skips. It imports nothing of JAX, so it also runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Scores agree to rtol = atol = 1e-5 (cuBLAS-free fixed-order FMA chains vs
torch's gemv); ids are equal except inside a tie group of the plain
version's scores; the bitmap kernels are bit-exact. Block shapes are varied
because results must not depend on them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5


def _words(dense: torch.Tensor) -> torch.Tensor:
    """(S, n) bool -> (S, ceil(n/32)) int32 views of little-endian words."""
    bits = torch.nn.functional.pad(dense.to(torch.int64),
                                   (0, (-dense.shape[1]) % 32))
    bits = bits.reshape(dense.shape[0], -1, 32)
    w = (bits << torch.arange(32, device=dense.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _agree(got, want, label):
    err = ref.topk_disagreement(got[1].cpu().numpy(), got[0].cpu().numpy(),
                                want[1].cpu().numpy(), want[0].cpu().numpy(),
                                TOL)
    assert err is None, f"{label}: {err}"
    vals, ids = got[0].cpu().numpy(), got[1].cpu().numpy()
    assert np.all(vals[ids < 0] == ref.NEG_INF), label


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k,metric,block_q,block_n", [
    (1, 137, 16, 1, "ip", None, None),
    (5, 1024, 128, 10, "l2", None, None),
    (8, 2081, 16, 40, "ip", None, None),
    (7, 2081, 13, 17, "l2", 3, 160),          # scalar loads, odd tiles
    (9, 5000, 64, 256, "ip", 8, 32),          # k = 256, one list per lane
])
def test_cuda_kernels_match_plain_versions(q, n, d, k, metric, block_q,
                                           block_n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(q * 7 + n)
    Q = torch.randn(q, d, generator=g, device=dev)
    X = torch.randn(n, d, generator=g, device=dev)
    X[n // 2] = X[n // 3]                                   # a tie
    dense = torch.rand(3, n, generator=g, device=dev) < 0.4
    dense[1] = False                                        # empty scope
    sid = torch.randint(0, 3, (q,), generator=g, device=dev,
                        dtype=torch.int32)
    mask, words = dense[0].to(torch.int8), _words(dense)
    sq = ref.row_sq_norms(X)
    ops.reset_launch_counts()
    _agree(ops.scoped_topk(Q, X, mask, k, metric, sq, block_q, block_n),
           ref.scoped_topk_ref(Q, X, mask, k, metric, sq), "scoped_topk")
    _agree(ops.multi_scope_topk(Q, X, words, sid, k, metric, sq, block_q,
                                block_n),
           ref.multi_scope_topk_ref(Q, X, words, sid, k, metric, sq),
           "multi_scope_topk")
    signs = torch.tensor([1, -1, 0], dtype=torch.int32, device=dev)
    assert torch.equal(ops.bitmap_patch(words, words[2], signs),
                       ref.bitmap_patch_ref(words, words[2], signs))
    w1, c1 = ops.mask_and_popcount(words[0], words[2])
    w2, c2 = ref.mask_and_popcount_ref(words[0], words[2])
    assert torch.equal(w1, w2) and int(c1) == int(c2)
    counts = ops.launch_counts()
    assert all(counts[name] == 1 for name in (
        "scoped_topk", "multi_scope_topk", "bitmap_patch",
        "mask_and_popcount"))


def _i8_inputs(g, q, n, d, dev):
    Q = torch.randn(q, d, generator=g, device=dev)
    X = torch.randn(n, d, generator=g, device=dev)
    X[n // 2] = X[n // 3]                                   # a tie
    qs = Q.abs().amax(1) / 127
    xs = X.abs().amax(1) / 127
    q8 = torch.round(Q / qs[:, None]).to(torch.int8)
    x8 = torch.round(X / xs[:, None]).to(torch.int8)
    sq = (x8.float() ** 2).sum(1) * xs * xs
    return q8, qs, x8, xs, sq


def _pq_inputs(g, q, n, m, dev):
    lut = torch.randn(q, m, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    codes[n // 2] = codes[n // 3]                           # a tie
    return lut, codes


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,m,k,metric,block_q,block_n", [
    (1, 137, 16, 4, 1, "ip", None, None),
    (5, 1024, 128, 32, 40, "l2", None, None),
    (16, 2081, 13, 13, 17, "l2", 3, 160),     # scalar loads, odd tiles
    (9, 5000, 64, 16, 320, "ip", 8, 32),      # a rescore window past 256
])
def test_quantized_kernels_match_plain_versions(q, n, d, m, k, metric,
                                                block_q, block_n):
    """int8 scores are exact integer sums and PQ scores add in subspace
    order in both versions, so ids and values are bit-for-bit equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(q * 11 + n)
    q8, qs, x8, xs, sq = _i8_inputs(g, q, n, d, dev)
    lut, codes = _pq_inputs(g, q, n, m, dev)
    dense = torch.rand(3, n, generator=g, device=dev) < 0.4
    dense[1] = False                                        # empty scope
    sid = torch.randint(0, 3, (q,), generator=g, device=dev,
                        dtype=torch.int32)
    mask, words = dense[0].to(torch.int8), _words(dense)
    ops.reset_launch_counts()
    pairs = [
        (ops.scoped_topk_i8(q8, qs, x8, xs, sq, mask, k, metric, block_q,
                            block_n),
         ref.scoped_topk_i8_ref(q8, qs, x8, xs, sq, mask, k, metric)),
        (ops.multi_scope_topk_i8(q8, qs, x8, xs, sq, words, sid, k, metric,
                                 block_q, block_n),
         ref.multi_scope_topk_i8_ref(q8, qs, x8, xs, sq, words, sid, k,
                                     metric)),
        (ops.scoped_topk_pq(lut, codes, mask, k, block_q, block_n),
         ref.scoped_topk_pq_ref(lut, codes, mask, k)),
        (ops.multi_scope_topk_pq(lut, codes, words, sid, k, block_q,
                                 block_n),
         ref.multi_scope_topk_pq_ref(lut, codes, words, sid, k)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(got[1], want[1]), i
        assert torch.equal(got[0], want[0]), i
    counts = ops.launch_counts()
    assert all(counts[name] == 1 for name in (
        "scoped_topk_i8", "multi_scope_topk_i8", "scoped_topk_pq",
        "multi_scope_topk_pq"))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,q,n,depth,k", [
    ("f32", 3, 3000, 64, 257),
    ("f32", 5, 6000, 32, 4096),               # lists: qt shrinks
    ("f32", 2, 20000, 16, 10000),             # lists in device memory
    ("f32", 8, 3000, 8192, 10),               # d sliced
    ("i8", 8, 2000, 32768, 10),               # d sliced
    ("pq", 8, 3000, 256, 10),                 # one LUT > shared memory
    ("pq", 4, 5000, 32, 320),
])
def test_lifted_k_and_depth_limits(kind, q, n, depth, k):
    """Any k and any depth launch the kernel (no fallback) and equal the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n + depth + k)
    dense = torch.rand(2, n, generator=g, device=dev) < 0.6
    mask, words = dense[0].to(torch.int8), _words(dense)
    sid = (torch.arange(q, device=dev) % 2).to(torch.int32)
    if kind == "f32":
        Q = torch.randn(q, depth, generator=g, device=dev)
        X = torch.randn(n, depth, generator=g, device=dev)
        sq = ref.row_sq_norms(X)
        _agree(ops.scoped_topk(Q, X, mask, k, "l2", sq),
               ref.scoped_topk_ref(Q, X, mask, k, "l2", sq), "scoped")
        _agree(ops.multi_scope_topk(Q, X, words, sid, k, "ip"),
               ref.multi_scope_topk_ref(Q, X, words, sid, k, "ip"), "multi")
        return
    if kind == "i8":
        q8, qs, x8, xs, sq = _i8_inputs(g, q, n, depth, dev)
        pairs = [(ops.scoped_topk_i8(q8, qs, x8, xs, sq, mask, k, "l2"),
                  ref.scoped_topk_i8_ref(q8, qs, x8, xs, sq, mask, k, "l2")),
                 (ops.multi_scope_topk_i8(q8, qs, x8, xs, None, words, sid,
                                          k),
                  ref.multi_scope_topk_i8_ref(q8, qs, x8, xs, None, words,
                                              sid, k))]
    else:
        lut, codes = _pq_inputs(g, q, n, depth, dev)
        pairs = [(ops.scoped_topk_pq(lut, codes, mask, k),
                  ref.scoped_topk_pq_ref(lut, codes, mask, k)),
                 (ops.multi_scope_topk_pq(lut, codes, words, sid, k),
                  ref.multi_scope_topk_pq_ref(lut, codes, words, sid, k))]
    for got, want in pairs:
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _gathered_inputs(g, b, c, n, dev, pad=0.2):
    """(b, c) candidate ids, each query's drawn without repeats, -1 for
    padding, and a position tie in query 0 (positions 1 and 3 hold equal
    rows, the later one with the lower id)."""
    cand = torch.stack([torch.randperm(n, generator=g, device=dev)[:c]
                        for _ in range(b)]).to(torch.int32)
    cand[torch.rand(b, c, generator=g, device=dev) < pad] = -1
    if c >= 4:
        cand[0, 1], cand[0, 3] = n - 1, n - 2
    return cand


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,n,d,m,k,metric,pad", [
    (1, 1, 64, 16, 4, 3, "ip", 0.0),          # C = 1
    (3, 300, 2000, 13, 13, 10, "l2", 0.2),    # scalar loads, C % 256 != 0
    (5, 2048, 9000, 128, 32, 40, "ip", 0.5),  # k > some queries' admitted
    (2, 700, 1000, 64, 16, 700, "l2", 0.1),   # k > C
    (4, 512, 3000, 32, 8, 10, "ip", 1.0),     # all padding
    (2, 900, 3000, 8192, 64, 10, "ip", 0.1),  # d sliced
])
def test_ivf_gather_topk_matches_plain_versions(b, c, n, d, m, k, metric,
                                                pad):
    """Kernel 9 and its int8 / PQ modes against their plain versions: fp32
    within the tolerance above, int8 and PQ bit for bit; one launch each;
    a scope id out of range admits nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(b * 13 + c)
    Q = torch.randn(b, d, generator=g, device=dev)
    X = torch.randn(n, d, generator=g, device=dev)
    X[n - 2] = X[n - 1]                                     # a tie
    sq = ref.row_sq_norms(X)
    q8, qs, x8, xs, sq8 = _i8_inputs(g, b, n, d, dev)
    lut, codes = _pq_inputs(g, b, n, m, dev)
    codes[n - 2] = codes[n - 1]
    cand = _gathered_inputs(g, b, c, n, dev, pad)
    dense = torch.rand(2, n, generator=g, device=dev) < 0.6
    dense[:, n - 2:] = True
    words = _words(dense)
    sid = (torch.arange(b, device=dev) % 2).to(torch.int32)
    sid[-1] = 7 if b > 1 else 0                             # out of range
    ops.reset_launch_counts()
    got = ops.ivf_gather_topk(Q, X, cand, words, sid, k, metric, sq)
    want = ref.ivf_gather_topk_ref(Q, X, cand, words, sid, k, metric, sq)
    _agree(got, want, "ivf_gather_topk")
    if b > 1:
        assert torch.all(got[1][-1] == -1)
    pairs = [(ops.ivf_gather_topk_i8(q8, qs, x8, xs, sq8, cand, words, sid,
                                     k, metric),
              ref.ivf_gather_topk_i8_ref(q8, qs, x8, xs, sq8, cand, words,
                                         sid, k, metric)),
             (ops.ivf_gather_topk_pq(lut, codes, cand, words, sid, k),
              ref.ivf_gather_topk_pq_ref(lut, codes, cand, words, sid, k))]
    for i, (a, w) in enumerate(pairs):
        assert torch.equal(a[1], w[1]), i
        assert torch.equal(a[0], w[0]), i
    counts = ops.launch_counts()
    assert all(counts[name] == 1 for name in (
        "ivf_gather_topk", "ivf_gather_topk_i8", "ivf_gather_topk_pq"))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,s,d,dtype", [
    (2, 8, 2, 1000, 64, torch.float32),       # the reference sweep
    (3, 16, 8, 700, 32, torch.float32),
    (2, 8, 2, 512, 64, torch.bfloat16),
    (4, 16, 8, 532, 128, torch.bfloat16),     # the RAG decode shape
    (2, 4, 4, 1, 128, torch.float32),         # s = 1, group 1
    (2, 6, 2, 257, 48, torch.bfloat16),       # group 3
    (2, 8, 1, 130, 256, torch.float32),       # group 8, d = 256
    (2, 4, 2, 99, 13, torch.bfloat16),        # odd d: scalar staging
])
def test_flash_decode_kernel_matches_plain_version(b, h, kv, s, d, dtype):
    """Kernel 10 against its plain version on the same inputs, ragged
    lengths, a window-and-chunk hole pattern in one row and a row that
    admits nothing (zeros, no NaN). Tolerances are the CPU tests': 3e-4 at
    fp32 (online vs one-pass softmax), 3e-2 at bf16 (p rounded to bf16
    before the PV product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(b * 1000 + s + d)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, kv, s, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, kv, s, d, generator=g, device=dev).to(dtype)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] < lens[:, None]).to(torch.int8)
    mask[0] &= ((pos % 7) < 5).to(torch.int8)               # holes
    if b > 2:
        mask[-1] = 0                                        # admits nothing
    ops.reset_launch_counts()
    got = ops.flash_decode(q, k, v, mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_decode"] == 1
    want = ref.flash_decode_ref(q, k, v, mask)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if b > 2:
        assert torch.all(got[-1] == 0)


@pytest.mark.gpu
def test_flash_decode_refuses_a_group_beyond_shared_memory():
    """A group whose queries and accumulators do not fit one block's
    shared memory is refused by the C entry, and the wrapper raises; no
    launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q = torch.zeros(1, 128, 256, device=dev)
    kv = torch.zeros(1, 1, 8, 256, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="shared memory"):
        ops.flash_decode(q, kv, kv, torch.ones(1, 8, dtype=torch.int8,
                                               device=dev))
    assert ops.launch_counts()["flash_decode"] == 0
