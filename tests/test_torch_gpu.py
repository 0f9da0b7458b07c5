"""The port's CUDA kernels against their plain PyTorch versions, on a card,
and the device seams of the serving tier and online maintenance (the
threaded scheduler, the staged query copy, compaction's rebuilt words).

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


def _flash_inputs(b, h, kv, s, d, dtype, seed, window=0, lo=1):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, kv, s, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, kv, s, d, generator=g, device=dev).to(dtype)
    lens = torch.randint(lo, s + 1, (b,), generator=g, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    mask = pos < lens[:, None]
    if window:
        mask &= pos > lens[:, None] - 1 - window
    return q, k, v, mask.to(torch.int8)


def _flash_agrees(got, q, k, v, mask, label):
    """``chip_smoke.py``'s tolerance: 3e-4 (1 + |want|) at fp32; 2^-7
    (|want| + A) at bf16, A = sum p |v| / l (p rounded to bf16 before the
    PV product, output rounded to bf16); zeros where nothing is admitted."""
    want = ref.flash_decode_ref(q, k, v, mask).float()
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all(), label
    if q.dtype == torch.bfloat16:
        spread = ref.flash_decode_ref(q.float(), k.float(), v.float().abs(),
                                      mask)
        limit = 2.0 ** -7 * (want.abs() + spread)
    else:
        limit = 3e-4 * (1 + want.abs())
    err = (got.float() - want).abs()
    assert bool((err <= limit).all()), f"{label}: max err {float(err.max())}"
    assert bool((got[mask.sum(1) == 0] == 0).all()), label


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,s,d,window,lo", [
    (64, 16, 8, 532, 128, 0, 517),     # the RAG main shape: 2-warp blocks
    (8, 16, 8, 532, 128, 0, 517),      # the same at b = 8: 4-warp blocks
    (1, 16, 8, 32_768, 128, 0, 32_768),  # the long cache
    (50, 8, 8, 130, 256, 0, 1),        # d = 256 on 2-warp blocks
    (8, 25, 5, 661, 64, 0, 600),       # hymba, b = 64 -> 8
    (4, 25, 5, 2_193, 64, 1_024, 2_100),  # hymba past its window
    (4, 32, 32, 224, 96, 0, 200),      # phi-3, group 1
    (4, 20, 20, 1_500, 64, 0, 1_500),  # whisper's cross-attention, b 16 -> 4
])
def test_flash_decode_family_shapes_split_and_repeat(b, h, kv, s, d, window,
                                                     lo):
    """Kernel 10 at the six timed shapes (bf16) and two more of its block
    geometries: within the plain version's tolerance, one launch a call
    however the cache is split, and two calls bitwise equal (the splits
    merge in a fixed order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, mask = _flash_inputs(b, h, kv, s, d, torch.bfloat16,
                                  seed=s + d, window=window, lo=lo)
    ops.reset_launch_counts()
    one = ops.flash_decode(q, k, v, mask)
    two = ops.flash_decode(q, k, v, mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_decode"] == 2
    assert torch.equal(one, two)
    _flash_agrees(one, q, k, v, mask, f"{b, h, kv, s, d}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [13, 64, 128])
def test_flash_decode_forced_splits(dtype, d):
    """Forced splits through the launch wrapper's keyword: 1, 2, 7 and one
    per tile, on ragged rows whose later splits admit nothing, holes and a
    row that admits nothing; each within tolerance and repeatable bit for
    bit. A split count past the tiles is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    fd = ops._fd                           # the launch-wrapper module
    b, h, kv, s = 4, 10, 2, 640
    q, k, v, mask = _flash_inputs(b, h, kv, s, d, dtype, seed=d)
    mask[0, 100:] = 0                                  # empty later splits
    mask[1] &= (torch.arange(s, device=mask.device) % 7 < 5).to(torch.int8)
    mask[-1] = 0
    for n_split in (1, 2, 7, s // fd.SPLIT_TILE):
        got = fd.flash_decode(q, k, v, mask, n_split=n_split)
        again = fd.flash_decode(q, k, v, mask, n_split=n_split)
        torch.cuda.synchronize()
        assert torch.equal(got, again), n_split
        _flash_agrees(got, q, k, v, mask, f"n_split {n_split}")
    before = ops.launch_counts()["flash_decode"]
    for bad in (0, s // fd.SPLIT_TILE + 1):
        with pytest.raises(ValueError, match="n_split"):
            fd.flash_decode(q, k, v, mask, n_split=bad)
    assert ops.launch_counts()["flash_decode"] == before


@pytest.mark.gpu
def test_flash_decode_group_above_one_mma_slice():
    """A bf16 group of 40 takes three 16-row slices of the mma kernel; fp32
    keeps it whole in one block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, mask = _flash_inputs(2, 80, 2, 300, 64, dtype, seed=40)
        _flash_agrees(ops.flash_decode(q, k, v, mask), q, k, v, mask,
                      f"group 40 {dtype}")


# (kind, q, n, depth, k, block_q) of every tiled-pass-1 launch that
# chip_smoke.py and these tests make: phase 1's edge sweep, main shapes,
# lifted limits and int8 tier shapes, the tiled cases below and the
# block-diagonal masks (tests/test_torch_kernels.py checks their launch
# shapes on the CPU)
_MAIN = 1_940_000
TILED_LAUNCHES = sorted({
    *[(kind, q, n, d, k, None) for kind in ("f32", "i8")
      for q, n, d, k, _, _ in (
          (1, 137, 16, 1, 0, 0), (15, 1000, 13, 10, 0, 0),
          (16, 2081, 100, 80, 0, 0), (17, 4100, 128, 257, 0, 0),
          (64, 5000, 128, 10, 0, 0), (65, 3001, 16, 80, 0, 0),
          (130, 2500, 100, 257, 0, 0), (64, 3000, 300, 10, 0, 0),
          (64, 2000, 1100, 10, 0, 0), (33, 2000, 128, 600, 0, 0),
          (64, 5120, 128, 10, 0, 0), (20, 1600, 13, 10, 0, 0),
          (2, 30000, 64, 20000, 0, 0))],
    ("f32", 20, 3000, 64, 10, 3), ("i8", 20, 3000, 64, 10, 3),
    ("f32", 70, 3000, 64, 40, 8), ("i8", 70, 3000, 64, 40, 8),
    ("f32", 8, 2081, 16, 40, None), ("f32", 5, 1024, 128, 10, None),
    ("i8", 16, 2081, 13, 40, None), ("i8", 16, 137, 16, 40, None),
    ("f32", 64, _MAIN, 128, 10, None), ("f32", 64, _MAIN, 128, 320, None),
    ("i8", 64, _MAIN, 128, 40, None), ("i8", 64, _MAIN, 128, 80, None),
    ("f32", 64, 100_000, 8192, 10, None), ("f32", 3, 30_000, 64, 10_000,
                                           None),
    ("f32", 5, 20_000, 64, 4096, None), ("f32", 8, 20_000, 8192, 10, None),
    ("i8", 3, 30_000, 64, 10_000, None), ("i8", 5, 20_000, 64, 4096, None),
    ("i8", 8, 20_000, 8192, 10, None), ("i8", 8, 4000, 32768, 10, None),
}, key=str)




# the tiled pass 1 of kernels 2 and 6: (q, n, d, k, metric, block_q), each
# case run at fp32 and int8. q crosses the 16-query groups and the 64-query
# tile; d takes byte (13), 4-byte (100) and 16-byte (16, 128) copies, depth
# slices (100, 128 at fp32) and a query side past 64 KB (300 at fp32, 1100
# at both); k = 257 and 600 halve the query tile to keep the lists in
# shared memory, k = 20,000 puts them in device memory; n is never a
# multiple of the row tile (256 rows fp32, 128 int8)
TILED_CASES = [
    (1, 137, 16, 1, "ip", None),
    (15, 1000, 13, 10, "l2", None),
    (16, 2081, 100, 80, "ip", None),
    (17, 4100, 128, 257, "l2", None),
    (64, 5000, 128, 10, "ip", None),
    (65, 3001, 16, 80, "l2", None),
    (130, 2500, 100, 257, "ip", None),
    (64, 3000, 300, 10, "ip", None),
    (64, 2000, 1100, 10, "l2", None),
    (33, 2000, 128, 600, "ip", None),
    (20, 3000, 64, 10, "ip", 3),
    (70, 3000, 64, 40, "l2", 8),
    (2, 30000, 64, 20000, "ip", None),
]


def _tiled_inputs(q, n, d, seed, blockdiag=False):
    """Queries, rows with a duplicated row, their int8 codes, and scope
    words: four scopes (sparse, empty, only the last rows, dense) with ids
    in [0, 5) (4 is out of range), or with ``blockdiag`` gather_rescore's
    masks: query b admits its own slice of n / q rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.randn(q, d, generator=g, device=dev)
    X = torch.randn(n, d, generator=g, device=dev)
    X[n // 2] = X[n // 3]                                   # a tie
    if blockdiag:
        r = n // q
        dense = torch.zeros(q, n, dtype=torch.bool, device=dev)
        for b in range(q):
            dense[b, b * r:(b + 1) * r] = True
        dense &= torch.rand(q, n, generator=g, device=dev) < 0.9
        sid = torch.arange(q, dtype=torch.int32, device=dev)
    else:
        dense = torch.rand(4, n, generator=g, device=dev) < 0.4
        dense[1] = False                                    # empty scope
        dense[2, : n - 5] = False                           # the last rows
        dense[3] = torch.rand(n, generator=g, device=dev) < 0.9
        sid = torch.randint(0, 5, (q,), generator=g, device=dev,
                            dtype=torch.int32)
        sid[0] = 4                                          # out of range
    return Q, X, dense, _words(dense), sid, _i8_inputs(g, q, n, d, dev)


def _dense_row(dense, sid, i):
    """Query i's scope as the dense mask kernels 1 and 5 take."""
    s = int(sid[i])
    if 0 <= s < dense.shape[0]:
        return dense[s].to(torch.int8)
    return torch.zeros(dense.shape[1], dtype=torch.int8, device=dense.device)


def _tiled_pairs(Q, X, dense, words, sid, i8, k, metric, block_q):
    q8, qs, x8, xs, sq8 = i8
    sq = ref.row_sq_norms(X)
    ops.reset_launch_counts()
    got = ops.multi_scope_topk(Q, X, words, sid, k, metric, sq, block_q)
    got8 = ops.multi_scope_topk_i8(q8, qs, x8, xs, sq8, words, sid, k,
                                   metric, block_q)
    counts = ops.launch_counts()
    assert counts["multi_scope_topk"] == 1
    assert counts["multi_scope_topk_i8"] == 1
    return got, got8, sq


def _hold_tiled_against_dense(Q, X, dense, words, sid, i8, k, metric,
                              block_q):
    """Kernel 2 against kernel 1 and kernel 6 against kernel 5, query by
    query on the unpacked scope row: ids and values bitwise equal."""
    q8, qs, x8, xs, sq8 = i8
    got, got8, sq = _tiled_pairs(Q, X, dense, words, sid, i8, k, metric,
                                 block_q)
    for i in range(Q.shape[0]):
        mask = _dense_row(dense, sid, i)
        v1, i1 = ops.scoped_topk(Q[i:i + 1], X, mask, k, metric, sq)
        assert torch.equal(got[1][i:i + 1], i1), f"fp32 ids, query {i}"
        assert torch.equal(got[0][i:i + 1], v1), f"fp32 values, query {i}"
        v5, i5 = ops.scoped_topk_i8(q8[i:i + 1], qs[i:i + 1], x8, xs, sq8,
                                    mask, k, metric)
        assert torch.equal(got8[1][i:i + 1], i5), f"int8 ids, query {i}"
        assert torch.equal(got8[0][i:i + 1], v5), f"int8 values, query {i}"
    if int(sid[0]) >= dense.shape[0]:
        assert torch.all(got[1][0] == -1) and torch.all(got8[1][0] == -1)


def _hold_tiled_against_plain(Q, X, dense, words, sid, i8, k, metric,
                              block_q):
    """The plain versions index scope rows directly: an out-of-range id is
    given an empty row there (what the kernels make of it)."""
    q8, qs, x8, xs, sq8 = i8
    got, got8, sq = _tiled_pairs(Q, X, dense, words, sid, i8, k, metric,
                                 block_q)
    empty = max(0, int(sid.max()) + 1 - words.shape[0])
    pw = torch.nn.functional.pad(words, (0, 0, 0, empty))
    _agree(got, ref.multi_scope_topk_ref(Q, X, pw, sid, k, metric, sq),
           "multi_scope_topk")
    want8 = ref.multi_scope_topk_i8_ref(q8, qs, x8, xs, sq8, pw, sid, k,
                                        metric)
    assert torch.equal(got8[1], want8[1]) and torch.equal(got8[0], want8[0])


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k,metric,block_q", TILED_CASES)
def test_tiled_scans_equal_dense_scans_bitwise(q, n, d, k, metric, block_q):
    """dsq_batch (kernels 2 / 6) is held bitwise equal to a loop of dsq
    (kernels 1 / 5): the tiled pass 1 must give every query exactly the
    dense-mask scan's ids and values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _hold_tiled_against_dense(*_tiled_inputs(q, n, d, q * 31 + n + d), k,
                              metric, block_q)


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k,metric,block_q", TILED_CASES)
def test_tiled_scans_match_plain_versions(q, n, d, k, metric, block_q):
    """Kernels 2 and 6 against their plain versions: fp32 within the
    tolerance above, int8 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _hold_tiled_against_plain(*_tiled_inputs(q, n, d, q * 37 + n + d), k,
                              metric, block_q)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,q,n,depth,k,block_q", TILED_LAUNCHES)
def test_tiled_plan_fits_shared_memory(kind, q, n, depth, k, block_q):
    """The C entry's plan (query tile, depth slice, resident query side,
    list placement) for every tiled launch above fits a block's 232,448
    bytes with its two-stage ring, so no such launch is refused; the tile
    is at most the cap and plans itself again; at the main shapes the
    tile is 64 queries (32 at k = 320, where 64 lists do not fit) and
    the grid is one or two blocks per SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    st = ops._st
    cap = min(block_q or st.TILE_Q, q, st.TILE_Q)
    qt, smem = st.tiled_plan(kind, cap, depth, k)
    assert 0 < smem <= st.SMEM_LIMIT and 1 <= qt <= cap
    assert st.tiled_plan(kind, qt, depth, k) == (qt, smem)
    geo = st.tiled_geometry(kind, q, n, k, qt, None)
    assert 1 <= geo.n_chunks <= 65535
    if n == _MAIN:
        assert qt == (64 if k <= 80 else 32)
        assert 132 <= geo.n_chunks * -(-q // qt) <= 264


@pytest.mark.gpu
@pytest.mark.parametrize("q,r,d,k,metric", [
    (64, 40, 128, 10, "ip"),                  # gather_rescore's shape
    (20, 80, 13, 10, "l2"),
])
def test_tiled_scans_on_block_diagonal_masks(q, r, d, k, metric):
    """gather_rescore's masks (query b admits only its own r rows of the
    q * r gathered block): bitwise equal to kernels 1 / 5 and to the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args = _tiled_inputs(q, q * r, d, q + r, blockdiag=True)
    _hold_tiled_against_dense(*args, k, metric, None)
    _hold_tiled_against_plain(*args, k, metric, None)


# ------------------------------------------------------ kernels 1 and 8
# launch shapes of the streaming pass 1 (kernel 1: q, n, d, k) and of the
# PQ tiled pass (kernel 8: q, n, M, k) that the cases below, chip_smoke.py
# and the main path make (tests/test_torch_kernels.py checks their grids on
# the CPU)
STREAM_LAUNCHES = [
    (1, _MAIN, 128, 10), (1, _MAIN, 128, 320), (1, 100_000, 8192, 10),
    (1, 4000, 128, 10), (1, 137, 16, 200), (8, 2081, 16, 40),
    (5, 3001, 13, 17), (3, 1000, 100, 320), (3, 30_000, 64, 10_000),
    (5, 20_000, 64, 4096), (8, 20_000, 8192, 10), (9, 5000, 64, 256),
    (3, 100_000, 64, 256),
]
PQ_LAUNCHES = [
    (64, _MAIN, 32, 80), (64, _MAIN, 32, 40), (1, 137, 4, 1),
    (5, 1024, 32, 40), (16, 2081, 13, 17), (9, 5000, 16, 320),
    (8, 3000, 256, 10), (4, 5000, 32, 320), (13, 3001, 3, 10),
    (3, 30_000, 16, 10_000), (1, 3000, 32, 80), (64, 5120, 32, 80),
]

# kernel 1's cases: (q, n, d, k, metric, mask, offset). q = 1 and q <= 8;
# n never a multiple of the 128-row tile (4000: a gather plan's launch,
# all rows admitted); d = 13 and 100 are not multiples of the 4-float
# vector (and 13 takes 4-byte copies), d = 8192 is 128 slices;
# ``offset`` rows start ``offset`` floats past a 16-byte boundary; k = 320
# takes the wide merge, k = 4096 at q = 5 puts the per-warp lists in device
# memory; mask "empty" admits nothing, "few" 5 rows (k above them)
STREAM_CASES = [
    (1, 2081, 128, 10, "ip", "dense", 0),
    (1, 4000, 128, 10, "l2", "ones", 0),
    (1, 137, 16, 200, "ip", "few", 0),
    (1, 3001, 64, 10, "ip", "empty", 0),
    (8, 2081, 16, 40, "ip", "dense", 0),
    (5, 3001, 13, 17, "l2", "dense", 1),
    (3, 1000, 100, 320, "ip", "dense", 2),
    (2, 5000, 64, 10, "l2", "ones", 3),
    (5, 20_000, 64, 4096, "ip", "dense", 0),
    (1, 20_000, 8192, 10, "l2", "dense", 0),
    (7, 70_001, 128, 10, "ip", "dense", 0),
]


def _stream_inputs(q, n, d, mask, offset, seed):
    """Queries, rows (a view ``offset`` floats into a larger buffer, with a
    duplicated row), their norms and the dense mask of the case."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.randn(q, d, generator=g, device=dev)
    X = torch.randn(n * d + offset, generator=g, device=dev)[offset:]
    X = X.view(n, d)
    X[n // 2] = X[n // 3]                                   # a tie
    if mask == "ones":
        dense = torch.ones(n, dtype=torch.bool, device=dev)
    elif mask == "empty":
        dense = torch.zeros(n, dtype=torch.bool, device=dev)
    elif mask == "few":
        dense = torch.zeros(n, dtype=torch.bool, device=dev)
        dense[torch.randperm(n, generator=g, device=dev)[:5]] = True
    else:
        dense = torch.rand(n, generator=g, device=dev) < 0.4
    return Q, X, ref.row_sq_norms(X), dense


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k,metric,mask,offset", STREAM_CASES)
def test_stream_scan_matches_plain_version_and_kernel_2(q, n, d, k, metric,
                                                        mask, offset):
    """Kernel 1 (the streaming pass 1) against its plain version (ids
    tie-aware, scores within TOL) and bit for bit against kernel 2 given
    the same mask as one scope row shared by every query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    Q, X, sq, dense = _stream_inputs(q, n, d, mask, offset,
                                     q * 13 + n + d + k)
    m8 = dense.to(torch.int8)
    ops.reset_launch_counts()
    got = ops.scoped_topk(Q, X, m8, k, metric, sq)
    assert ops.launch_counts()["scoped_topk"] == 1
    _agree(got, ref.scoped_topk_ref(Q, X, m8, k, metric, sq), "scoped_topk")
    admitted = int(dense.sum())
    if admitted < k:
        assert torch.all(got[1][:, admitted:] == -1)
    words = _words(dense[None])
    sid = torch.zeros(q, dtype=torch.int32, device=Q.device)
    two = ops.multi_scope_topk(Q, X, words, sid, k, metric, sq)
    assert torch.equal(got[1], two[1]) and torch.equal(got[0], two[0])


# kernel 8's cases: (q, n, M, k, offset). q = 1, q <= 8 and q = 13 (three
# query tiles); n never a multiple of the 512-row tile but at 3072; M = 3
# and 13 take byte copies, M = 256 stages the LUT in slices; ``offset``
# codes start ``offset`` bytes past a 16-byte boundary; k = 320 takes the
# wide merge, k above the admitted rows of the sparse and empty scopes;
# scope ids include an empty scope and one out of range
PQ_CASES = [
    (1, 3001, 32, 80, 0),
    (8, 2081, 32, 40, 0),
    (13, 5000, 32, 80, 0),
    (5, 3072, 16, 320, 0),
    (4, 2000, 3, 10, 1),
    (6, 4100, 13, 17, 5),
    (3, 3000, 256, 10, 0),
    (2, 1000, 32, 900, 0),
    (9, 20_001, 32, 80, 16),
]


def _pq_case_inputs(q, n, m, offset, seed):
    """LUTs, codes (a view ``offset`` bytes into a larger buffer, with a
    duplicated row), and four scopes: dense, empty, only the last 7 rows,
    sparse; scope ids cycle through them and 4 (out of range)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.randn(q, m, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (n * m + offset,), generator=g,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    codes = codes[offset:].view(n, m)
    codes[n // 2] = codes[n // 3]                           # a tie
    dense = torch.zeros(4, n, dtype=torch.bool, device=dev)
    dense[0] = torch.rand(n, generator=g, device=dev) < 0.6
    dense[2, n - 7:] = True
    dense[3] = torch.rand(n, generator=g, device=dev) < 0.05
    sid = (torch.arange(q, device=dev) % 5).to(torch.int32)
    return lut, codes, dense, _words(dense), sid


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,m,k,offset", PQ_CASES)
def test_pq_tiled_scan_equals_plain_version_and_kernel_7(q, n, m, k, offset):
    """Kernel 8 (the PQ tiled pass) bit for bit against its plain version
    and, query by query, against kernel 7 on the query's unpacked scope
    row (the PQ batch == a loop of dsq at PQ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    lut, codes, dense, words, sid = _pq_case_inputs(q, n, m, offset,
                                                    q * 17 + n + m + k)
    ops.reset_launch_counts()
    got = ops.multi_scope_topk_pq(lut, codes, words, sid, k)
    assert ops.launch_counts()["multi_scope_topk_pq"] == 1
    pw = torch.nn.functional.pad(words, (0, 0, 0, 1))       # id 4: empty
    want = ref.multi_scope_topk_pq_ref(lut, codes, pw, sid, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    for i in range(q):
        one = ops.scoped_topk_pq(lut[i:i + 1], codes,
                                 _dense_row(dense, sid, i), k)
        assert torch.equal(got[1][i:i + 1], one[1]), f"ids, query {i}"
        assert torch.equal(got[0][i:i + 1], one[0]), f"values, query {i}"


# kernel 7's cases: (q, n, M, k, offset, mask): PQ_CASES' shapes under
# each case's dense scope row, then q = 1 at a gather plan's 4,000 rows and
# the main shape's 1.94M (all-ones masks), the widest real gather (q = 5,
# 41,829 rows, k = r = 80), k = 1, the wide merge (k = 320), lists in
# device memory (k = 4096), M = 256 (the LUT rides in slices), M = 3 and
# 13 (byte copies), codes ``offset`` bytes past a 16-byte boundary, and
# masks that admit only the last 7 rows or nothing
K7_CASES = [(q, n, m, k, offset, "dense") for q, n, m, k, offset in
            PQ_CASES] + [
    (1, 4000, 32, 80, 0, "ones"), (1, _MAIN, 32, 40, 0, "ones"),
    (5, 41_829, 32, 80, 0, "ones"), (1, 4000, 32, 1, 16, "dense"),
    (2, 3001, 32, 320, 5, "dense"), (3, 20_000, 16, 4096, 0, "dense"),
    (2, 5000, 256, 10, 1, "dense"), (1, 3001, 13, 80, 0, "last"),
    (4, 3001, 3, 10, 0, "empty")]
K7_LAUNCHES = sorted({(q, n, m, k) for q, n, m, k, *_ in K7_CASES} |
                     {(1, _MAIN, 32, 80), (5, 4000, 32, 80)})


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,m,k,offset,mask", K7_CASES)
def test_pq_stream_scan_matches_plain_version(q, n, m, k, offset, mask):
    """Kernel 7 (the streaming pass 1 in its PQ mode, one launch) bit for
    bit against its plain version: the same lookups added in subspace
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    lut, codes, dense, _, _ = _pq_case_inputs(q, n, m, offset,
                                              q * 23 + n + m + k)
    m8 = {"dense": dense[0], "ones": torch.ones_like(dense[0]),
          "last": dense[2], "empty": dense[1]}[mask].to(torch.int8)
    ops.reset_launch_counts()
    got = ops.scoped_topk_pq(lut, codes, m8, k)
    assert ops.launch_counts()["scoped_topk_pq"] == 1
    want = ref.scoped_topk_pq_ref(lut, codes, m8, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    admitted = int((m8 != 0).sum())
    if admitted < k:
        assert torch.all(got[1][:, admitted:] == -1)


STREAM_PLAN_CASES = [("f32", *c) for c in STREAM_LAUNCHES] + [
    ("pq", *c) for c in K7_LAUNCHES]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,q,n,d,k", STREAM_PLAN_CASES)
def test_stream_plan_fits_shared_memory(kind, q, n, d, k):
    """The C entry's plan for kernels 1 and 7 fits a block's 232,448 bytes
    with its three-stage ring, the tile is at most the cap (1 at PQ) and
    plans itself again, the per-warp lists stay in shared memory unless
    one query's do not fit (then one partial per warp, 4 a chunk). At
    kernel 1's main shape (q = 1, k = 10) two blocks share an SM, so the
    grid is one wave of 262 blocks; at kernel 7's (M = 32) the resident
    LUT leaves room for four, and its chunks keep at least 1,024 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    st = ops._st
    cap = min(q, st.STREAM_Q)
    plan = st.stream_plan(cap, d, k, kind)
    assert 0 < plan.smem <= st.SMEM_LIMIT and 1 <= plan.qt <= cap
    assert 1 <= plan.blocks <= 4 and plan.lists in (1, 4)
    assert st.stream_plan(plan.qt, d, k, kind) == plan
    floor = st.STREAM_PQ_ROWS if kind == "pq" else st.STREAM_ROWS
    geo = st.stream_geometry(q, n, plan.qt, plan.blocks, None,
                             min_rows=floor)
    assert 1 <= geo.n_chunks <= 65535
    assert geo.chunk_rows % st.STREAM_ROWS == 0 or geo.n_chunks == 1
    assert geo.chunk_rows >= min(floor, n)
    if (kind, n, d, k) == ("f32", _MAIN, 128, 10):
        assert (plan.qt, plan.lists, plan.blocks) == (1, 1, 2)
        assert 256 <= geo.n_chunks <= 264
    if kind == "pq":
        assert plan.qt == 1
        if (d, k) in ((32, 40), (32, 80)) and q == 1:
            assert (plan.qt, plan.lists, plan.blocks) == (1, 1, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [1, 3, 60_625, 2 ** 20 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_mask_and_popcount_is_one_launch(n_words, offset):
    """Kernel 4 equals its plain version bit for bit, with ``a`` aligned or
    a view one word into a larger buffer (4-byte words then), and each call
    is one launch of one kernel (torch.profiler)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_words + offset)
    buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_words + 1,), generator=g,
                        device=dev, dtype=torch.int32)
    a = buf[offset:offset + n_words]
    b = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_words,), generator=g,
                      device=dev, dtype=torch.int32)
    ops.reset_launch_counts()
    w1, c1 = ops.mask_and_popcount(a, b)
    w2, c2 = ref.mask_and_popcount_ref(a, b)
    assert torch.equal(w1, w2) and int(c1) == int(c2)
    assert ops.launch_counts()["mask_and_popcount"] == 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.mask_and_popcount(a, b)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0.0) > 0]
    assert [(("and_popc_kernel" in e.key), e.count) for e in kernels] == \
        [(True, 5)], [(e.key, e.count) for e in kernels]


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,m,k", PQ_LAUNCHES)
def test_pq_plan_fits_shared_memory(q, n, m, k):
    """The C entry's plan for kernel 8 fits a block's 232,448 bytes, the
    tile is at most 8 queries and plans itself again; at the main shape
    (M = 32, k = 80) the resident LUTs of 5 queries fit beside the ring
    and the grid is one wave of at most one block per SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    st = ops._st
    qt, smem = st.tiled_plan("pq", min(q, st.TILE_Q), m, k)
    assert 0 < smem <= st.SMEM_LIMIT and 1 <= qt <= min(q, 8)
    assert st.tiled_plan("pq", qt, m, k) == (qt, smem)
    geo = st.tiled_geometry("pq", q, n, k, qt, None)
    assert 1 <= geo.n_chunks <= 65535
    if n == _MAIN:
        assert qt == 5
        assert geo.n_chunks * -(-q // qt) <= 132


# ------------------------------------------- kernel 5 (streaming int8)
# (q, n, d, k, metric, mask, offset): q = 1 and q <= 8, n never a multiple
# of the 128-row tile (4000: a gather plan's launch, all rows admitted);
# d = 13 takes byte copies and a padded depth, d = 300 two slices, d = 32768
# 128 of them; ``offset`` rows start ``offset`` bytes past a 16-byte
# boundary; k = 320 takes the wide merge, k = 4096 at q = 5 puts the
# per-warp lists in device memory
I8_STREAM_CASES = [
    (1, 2081, 128, 40, "ip", "dense", 0),
    (1, 4000, 128, 40, "l2", "ones", 0),
    (1, 137, 16, 200, "ip", "few", 0),
    (1, 3001, 64, 10, "ip", "empty", 0),
    (8, 2081, 16, 40, "l2", "dense", 0),
    (5, 3001, 13, 17, "l2", "dense", 1),
    (3, 1000, 300, 320, "ip", "dense", 4),
    (5, 20_000, 64, 4096, "ip", "dense", 0),
    (2, 2000, 32768, 10, "l2", "dense", 0),
    (7, 70_001, 128, 80, "ip", "dense", 0),
]
I8_STREAM_LAUNCHES = sorted({(q, n, d, k) for q, n, d, k, *_ in
                             I8_STREAM_CASES} | {(1, _MAIN, 128, 40),
                                                 (1, 4000, 128, 40)})


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k,metric,mask,offset", I8_STREAM_CASES)
def test_i8_stream_scan_matches_plain_version_and_kernel_6(q, n, d, k,
                                                          metric, mask,
                                                          offset):
    """Kernel 5 (the streaming pass 1 at int8) bit for bit against its
    plain version, and kernel 6 given the same mask as one scope row bit
    for bit against it (the int8 batch == a loop of dsq)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(q * 19 + n + d + k)
    q8, qs, x8, xs, sq = _i8_inputs(g, q, n, d, dev)
    if offset:                                 # rows off 16-byte alignment
        buf = torch.empty(n * d + offset, dtype=torch.int8, device=dev)
        buf[offset:] = x8.reshape(-1)
        x8 = buf[offset:].view(n, d)
    _, _, _, dense = _stream_inputs(1, n, 4, mask, 0, q + n)
    m8 = dense.to(torch.int8)
    ops.reset_launch_counts()
    got = ops.scoped_topk_i8(q8, qs, x8, xs, sq, m8, k, metric)
    assert ops.launch_counts()["scoped_topk_i8"] == 1
    want = ref.scoped_topk_i8_ref(q8, qs, x8, xs, sq, m8, k, metric)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    words = _words(dense[None])
    sid = torch.zeros(q, dtype=torch.int32, device=dev)
    six = ops.multi_scope_topk_i8(q8, qs, x8, xs, sq, words, sid, k, metric)
    assert torch.equal(got[1], six[1]) and torch.equal(got[0], six[0])


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k", I8_STREAM_LAUNCHES)
def test_i8_stream_plan_fits_shared_memory(q, n, d, k):
    """The C entry's plan for kernel 5 fits a block's 232,448 bytes and
    plans itself again; at the main shape (q = 1, d = 128, k = 40) three
    blocks share an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    st = ops._st
    plan = st.stream_plan(min(q, st.STREAM_Q), d, k, "i8")
    assert 0 < plan.smem <= st.SMEM_LIMIT and 1 <= plan.qt <= min(q, 8)
    assert 1 <= plan.blocks <= 4 and plan.lists in (1, 4)
    assert st.stream_plan(plan.qt, d, k, "i8") == plan
    geo = st.stream_geometry(q, n, plan.qt, plan.blocks, None)
    assert 1 <= geo.n_chunks <= 65535
    if (d, k) == (128, 40) and q == 1:
        assert (plan.qt, plan.lists, plan.blocks) == (1, 1, 3)


# ------------------------------------------------ kernel 9, list form
def _list_inputs(b, n_lists, nprobe, n, d, m, seed, metric, empty=1,
                 pad=0.1):
    """A skewed padded-CSR layout of n rows over ``n_lists`` lists (a few
    wide ones, ``empty`` empty ones; list c's rows ascending, ``pad`` of
    its slots -1, padded with -1 to a multiple of 32), distinct probes per
    query, and the inputs of the three kinds; query 0's first two probed
    lists hold a tie that list order and id order rank differently, its
    two rows the query's best (the query itself for l2, 4x it for ip)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    w = 1.0 / (1.0 + torch.arange(n_lists, device=dev).double()) ** 0.8
    w = w[torch.randperm(n_lists, generator=g, device=dev)]
    sizes = torch.floor(w / w.sum() * n * 0.95).long()
    sizes[torch.argsort(sizes)[:empty]] = 0
    perm = torch.randperm(n, generator=g, device=dev)
    aligned = (sizes + 31) // 32 * 32
    offsets = torch.cumsum(aligned, 0) - aligned
    flat = torch.full((int(aligned.sum()) + 1,), -1, dtype=torch.int32,
                      device=dev)
    start = 0
    for c in range(n_lists):
        ln = int(sizes[c])
        rows = perm[start:start + ln].sort().values.to(torch.int32)
        rows[torch.rand(ln, generator=g, device=dev) < pad] = -1
        flat[int(offsets[c]):int(offsets[c]) + ln] = rows
        start += ln
    probe = torch.stack([torch.randperm(n_lists, generator=g, device=dev)
                         [:nprobe] for _ in range(b)]).to(torch.int32)
    Q = torch.randn(b, d, generator=g, device=dev)
    X = torch.randn(n, d, generator=g, device=dev)
    dense = torch.rand(2, n, generator=g, device=dev) < 0.6
    sid = (torch.arange(b, device=dev) % 2).to(torch.int32)
    if b > 2:
        sid[-1] = 7                                         # out of range
    a = flat[int(offsets[probe[0, 0]]):][:int(aligned[probe[0, 0]])]
    z = flat[int(offsets[probe[0, 1]]):][:int(aligned[probe[0, 1]])]
    a, z = a[a >= 0], z[z >= 0]
    if len(a) and len(z) and int(a.max()) > int(z.min()):
        X[int(a.max())] = X[int(z.min())] = Q[0] * (     # the tie
            1.0 if metric == "l2" else 4.0)
        dense[:, [int(a.max()), int(z.min())]] = True
    q8, qs, x8, xs, sq8 = _i8_inputs(g, b, n, d, dev)
    lut, codes = _pq_inputs(g, b, n, m, dev)
    layout = (offsets, aligned, flat, int(aligned.max()))
    return Q, X, (q8, qs, x8, xs, sq8), (lut, codes), layout, probe, \
        _words(dense), sid


def _expand(layout, probe):
    """The (B, nprobe * max_aligned) candidate matrix of a layout."""
    offsets, aligned, flat, ma = layout
    within = torch.arange(ma, device=probe.device)
    p = probe.long()
    idx = offsets[p][..., None] + within
    idx = torch.where(within < aligned[p][..., None], idx, flat.shape[0] - 1)
    return flat[idx].reshape(probe.shape[0], -1)


# (b, n_lists, nprobe, n, d, m, k, metric): list chunks past 4096
# positions, lists that more than 8 queries probe (several query tiles),
# d = 13 (byte copies), d sliced, k past 256 (wide merges) and k = 3000
# (the streaming pass's lists in device memory)
LIST_CASES = [
    (5, 7, 3, 5000, 64, 16, 10, "ip"),
    (64, 16, 8, 60_000, 128, 32, 40, "l2"),
    (20, 6, 5, 9000, 128, 32, 80, "ip"),
    (3, 4, 2, 3000, 13, 13, 17, "ip"),
    (9, 5, 5, 20_000, 32, 8, 320, "ip"),
    (2, 3, 3, 2000, 8192, 64, 10, "l2"),
    (4, 6, 4, 12_000, 32, 8, 3000, "ip"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n_lists,nprobe,n,d,m,k,metric", LIST_CASES)
def test_ivf_list_form_equals_cand_form_and_plain_versions(b, n_lists,
                                                          nprobe, n, d, m,
                                                          k, metric):
    """Kernel 9's list form (``ivf_probe_topk*``) at all three precisions
    bit for bit against its candidate form on the expanded matrix, and
    against its plain version (fp32 within the tolerance above, int8 and PQ
    bit for bit); one launch each; a scope id out of range admits nothing;
    the cross-list tie falls to the earlier-probed list's (higher) id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    Q, X, i8, pq, layout, probe, words, sid = _list_inputs(
        b, n_lists, nprobe, n, d, m, b * 7 + n + k, metric)
    q8, qs, x8, xs, sq8 = i8
    lut, codes = pq
    sq = ref.row_sq_norms(X)
    cand = _expand(layout, probe)
    ops.reset_launch_counts()
    got = ops.ivf_probe_topk(Q, X, *layout, probe, words, sid, k, metric, sq)
    assert ops.launch_counts()["ivf_gather_topk"] == 1
    two = ops.ivf_gather_topk(Q, X, cand, words, sid, k, metric, sq)
    assert torch.equal(got[1], two[1]) and torch.equal(got[0], two[0])
    _agree(got, ref.ivf_probe_topk_ref(Q, X, *layout, probe, words, sid, k,
                                       metric, sq), "ivf_probe_topk")
    if b > 2:
        assert torch.all(got[1][-1] == -1)
    offsets, aligned, flat, _ = layout
    a = flat[int(offsets[probe[0, 0]]):][:int(aligned[probe[0, 0]])]
    z = flat[int(offsets[probe[0, 1]]):][:int(aligned[probe[0, 1]])]
    a, z = a[a >= 0], z[z >= 0]
    if len(a) and len(z) and int(a.max()) > int(z.min()):
        assert got[1][0, :2].tolist() == [int(a.max()), int(z.min())]
    pairs = [
        (ops.ivf_probe_topk_i8(q8, qs, x8, xs, sq8, *layout, probe, words,
                               sid, k, metric),
         ops.ivf_gather_topk_i8(q8, qs, x8, xs, sq8, cand, words, sid, k,
                                metric),
         ref.ivf_probe_topk_i8_ref(q8, qs, x8, xs, sq8, *layout, probe,
                                   words, sid, k, metric)),
        (ops.ivf_probe_topk_pq(lut, codes, *layout, probe, words, sid, k),
         ops.ivf_gather_topk_pq(lut, codes, cand, words, sid, k),
         ref.ivf_probe_topk_pq_ref(lut, codes, *layout, probe, words, sid,
                                   k))]
    for i, (lst, cnd, want) in enumerate(pairs):
        for other in (cnd, want):
            assert torch.equal(lst[1], other[1]), i
            assert torch.equal(lst[0], other[0]), i


# (kind, q, depth, k) of the list form's launches in these tests and
# chip_smoke.py (phase 1's synthetic layout, phase 5's real one)
LIST_LAUNCHES = sorted({
    *[(kind, q, d if kind != "pq" else m, k) for kind in ("f32", "i8", "pq")
      for q, _, _, _, d, m, k, _ in LIST_CASES],
    ("f32", 64, 128, 10), ("f32", 64, 128, 80), ("i8", 64, 128, 40),
    ("pq", 64, 32, 80), ("f32", 1, 128, 10), ("f32", 8, 128, 10)})


@pytest.mark.gpu
@pytest.mark.parametrize("kind,q,depth,k", LIST_LAUNCHES)
def test_list_plan_fits_shared_memory(kind, q, depth, k):
    """The C entry's plan for kernel 9's list form fits a block's 232,448
    bytes with a chunk's compacted rows, the tile is at most 8 queries and
    plans itself again; at the main shapes (d = 128 at fp32 k = 10 and int8
    k = 40) two blocks share an SM, and at PQ M = 32, k = 80 four queries'
    LUTs stay resident."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    st = ops._st
    cap = min(q, st.LIST_Q)
    plan = st.list_plan(kind, cap, depth, k)
    assert 0 < plan.smem <= st.SMEM_LIMIT and 1 <= plan.qt <= cap
    assert plan.chunk % 32 == 0 and plan.lists in (1, 4)
    assert st.list_plan(kind, plan.qt, depth, k) == plan
    if (kind, depth, k, q) in (("f32", 128, 10, 64), ("i8", 128, 40, 64)):
        assert (plan.qt, plan.lists, plan.blocks) == (8, 1, 2)
    if (kind, depth, k, q) == ("pq", 32, 80, 64):
        assert plan.qt == 4


def _gather_batch_layout(n, d, n_lists, seed):
    """The flat executor's batch of gather-plan scopes at WIKI-Dir's width:
    ``n_lists`` sorted, distinct id lists of 10^2 to 10^5 of n rows
    (log-uniform sizes), unpadded, each probed by 1 to 8 queries in a
    shuffled order, one all-ones scope row."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = (10 ** (2 + 3 * torch.rand(n_lists, generator=g, device=dev))
             ).long()
    lists = [torch.randperm(n, generator=g, device=dev)[:m].sort().values
             .to(torch.int32) for m in sizes.tolist()]
    per = (1 + torch.randint(0, 8, (n_lists,), generator=g,
                             device=dev)).tolist()
    probe = torch.tensor([c for c, p in enumerate(per) for _ in range(p)],
                         dtype=torch.int32, device=dev)
    probe = probe[torch.randperm(len(probe), generator=g, device=dev)]
    offsets = torch.cumsum(sizes, 0) - sizes
    X = torch.randn(n, d, generator=g, device=dev)
    Q = torch.randn(len(probe), d, generator=g, device=dev)
    ones = torch.full((1, (n + 31) // 32), -1, dtype=torch.int32, device=dev)
    sid = torch.zeros(len(probe), dtype=torch.int32, device=dev)
    layout = (offsets, sizes, torch.cat(lists), int(sizes.max()))
    return Q, X, lists, layout, probe[:, None], ones, sid, max(per)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_list_form_at_gather_batch_shapes_equals_kernel_1(metric):
    """Kernel 9's list form at the shapes of a WIKI-Dir batch's gather-plan
    scopes (d = 1024, k = 10, 70 lists of 10^2 to 10^5 ids, 1 to 8 queries
    a list, ``per_list`` the most): one launch, within the tolerance of its
    plain version, and bit for bit what kernel 1 gives over each list's
    gathered rows under an all-ones mask (the single-request gather
    plan)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    k = 10
    Q, X, lists, layout, probe, ones, sid, per = _gather_batch_layout(
        400_000, 1024, 70, 28)
    sq = ref.row_sq_norms(X) if metric == "l2" else None
    ops.reset_launch_counts()
    got = ops.ivf_probe_topk(Q, X, *layout, probe, ones, sid, k, metric, sq,
                             check_ids=False, per_list=per)
    assert ops.launch_counts()["ivf_gather_topk"] == 1
    _agree(got, ref.ivf_probe_topk_ref(Q, X, *layout, probe, ones, sid, k,
                                       metric, sq), "gather batch layout")
    for c, ids in enumerate(lists):
        b = (probe[:, 0] == c).nonzero().flatten()
        if not len(b):
            continue
        idx = ids.long()
        vals, loc = ops.scoped_topk(
            Q[b], X[idx], torch.ones(len(ids), dtype=torch.int8,
                                     device=X.device), k, metric,
            None if sq is None else sq[idx])
        mapped = torch.where(loc >= 0, ids[loc.long().clamp(min=0)], -1)
        assert torch.equal(got[0][b], vals), c
        assert torch.equal(got[1][b], mapped), c


# ------------------------------------------- serving and maintenance on card
def _wiki_db(with_ivf=False):
    """A small WIKI-Dir database on the card (flat; IVF when asked)."""
    from repro_torch.datasets import make_wiki_dir
    from repro_torch.vectordb import DirectoryVectorDB
    ds = make_wiki_dir(scale=0.002, dim=32, n_queries=24, seed=7)
    db = DirectoryVectorDB(dim=32, calibration=False, device="cuda")
    db.ingest(ds.vectors, ds.entry_paths)
    db.build_ann("flat")
    if with_ivf:
        db.build_ann("ivf", n_lists=8)
    return ds, db


def _mix(ds, n):
    paths = [(ds.query_anchors[i % 6] or "/") for i in range(n)]
    paths[0] = "/"
    rec = [bool(i % 3) for i in range(n)]
    rec[0] = True                          # the whole tree: a scan group
    return ds.queries[np.arange(n) % len(ds.queries)], paths, rec


def _gather_anchors(db, lo, hi, count):
    """``count`` recursive anchors whose scopes hold lo..hi rows, spread
    over that range by size."""
    from repro_torch.core import paths as P
    idx = db.namespaces["fs"]
    sized = sorted((len(idx.resolve(P.to_str(d), recursive=True)
                        .to_array()), P.to_str(d))
                   for d in idx.list_dirs())
    sized = [a for m, a in sized if lo <= m <= hi]
    assert len(sized) >= count, (lo, hi, len(sized))
    return [sized[i * len(sized) // count] for i in range(count)]


@pytest.mark.gpu
def test_gather_batch_at_d1024_is_one_list_launch_equal_to_dsq():
    """A WIKI-Dir batch at d = 1024 (scale 0.01) with 40 gather-plan scopes
    of 1 to 970 rows and a scan: one kernel-9 list launch and no kernel-1
    launch rank its gather scopes, and every request equals its own
    ``dsq`` (kernel 1 over the gathered rows) bit for bit; the sharded
    executor's batch equals the flat one bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.datasets import make_wiki_dir
    from repro_torch.vectordb import DirectoryVectorDB
    ds = make_wiki_dir(scale=0.01, dim=1024, n_queries=64, seed=3)
    db = DirectoryVectorDB(dim=1024, calibration=False, device="cuda")
    db.ingest(ds.vectors, ds.entry_paths)
    db.build_ann("flat")
    anchors = _gather_anchors(db, 1, len(db.store) // 20, 40)
    paths = anchors + ["/"] * 4 + anchors[::2]
    queries = ds.queries[np.arange(len(paths)) % len(ds.queries)]
    db.dsq_batch(queries, paths, k=10)                 # plans and caches
    ops.reset_launch_counts()
    batch = db.dsq_batch(queries, paths, k=10)
    counts = ops.launch_counts()
    acct = batch[0].batch
    assert acct.plan_groups == {"gather": 40, "scan": 1}
    assert acct.gather_listed == 40 and acct.launches == 2
    assert counts["ivf_gather_topk"] == 1 and counts["scoped_topk"] == 0
    assert counts["multi_scope_topk"] == 1
    loop = [db.dsq(queries[i], paths[i], k=10) for i in range(len(paths))]
    for i, (a, b) in enumerate(zip(batch, loop)):
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=str(i))
        np.testing.assert_array_equal(a.scores, b.scores, err_msg=str(i))
    db.build_ann("sharded", n_shards=4)
    sharded = db.dsq_batch(queries, paths, k=10, executor="sharded")
    assert sharded[0].batch.gather_listed == 40
    for i, (a, b) in enumerate(zip(sharded, batch)):
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=str(i))
        np.testing.assert_array_equal(a.scores, b.scores, err_msg=str(i))


@pytest.mark.gpu
def test_threaded_scheduler_on_card_equals_direct_dsq():
    """The collector / executor threads on a CUDA database: every ticket
    equals its direct single-request ``dsq`` bit for bit, no stage fault
    was absorbed, and the scheduled batches launched the scan kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import threading
    from repro_torch.serving import ScheduledDSQ, SchedulerConfig
    ds, db = _wiki_db()
    n = 96
    queries, paths, rec = _mix(ds, n)
    direct = [db.dsq(queries[i], paths[i], k=10, recursive=rec[i])
              for i in range(n)]            # builds the kernels first
    tickets = [None] * n
    ops.reset_launch_counts()
    sdsq = ScheduledDSQ(db, k=10, cfg=SchedulerConfig(max_batch=16,
                                                      max_wait_ms=2.0))
    with sdsq:
        def client(lo):
            for i in range(lo, n, 4):
                tickets[i] = sdsq.submit(queries[i], paths[i],
                                         recursive=rec[i])
        threads = [threading.Thread(target=client, args=(j,))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [t.result(60.0) for t in tickets]
    launched = ops.launch_counts()
    assert launched["multi_scope_topk"] + launched["scoped_topk"] > 0
    for res, want in zip(results, direct):
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.scores, want.scores)
    snap = sdsq.metrics.snapshot()
    assert snap["completed"] == n and snap["failed"] == 0
    assert sdsq.scheduler.stage_faults == 0 and sdsq.health == "healthy"


@pytest.mark.gpu
def test_staged_query_copy_completes_before_first_use():
    """``stage_dsq`` stages a batch's query matrix in pinned memory and
    copies it on the owner's side stream. With that stream held busy, a
    large matrix's copy is still queued when it was issued, and a consumer
    ordered by ``wait`` reads the whole matrix. Then, threaded, an execute
    delayed past the next stage still finds its own batch's device copy
    intact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.serving import (ScheduledDSQ, SchedulerConfig,
                                     StagedQueries)
    from repro_torch.serving.scheduler import assemble_dsq, stage_dsq
    ds, db = _wiki_db()
    queries, paths, rec = _mix(ds, 64)
    side = torch.cuda.Stream()
    staged = stage_dsq(db, [(queries[i], paths[i], rec[i], ())
                            for i in range(64)], 10, "fs", "flat",
                       stream=side)
    assert isinstance(staged, StagedQueries) and staged.host.is_pinned()
    assert torch.equal(staged.wait().cpu(), torch.from_numpy(queries))
    big = np.random.default_rng(0).normal(
        size=(1 << 20, 32)).astype(np.float32)            # 128 MiB
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000_000)                  # ~0.5 s of spinning
    staged = StagedQueries(big, db.device, side)
    assert not staged.event.query()                       # still queued
    got = staged.wait()                   # this stream now waits on it
    assert torch.equal(got, torch.from_numpy(big).to(db.device))
    staged.release()
    assert staged.event.query()

    sdsq = ScheduledDSQ(db, k=10, cfg=SchedulerConfig(max_batch=64,
                                                      max_wait_ms=2.0))
    execute = sdsq.scheduler.execute_fn
    seen = []

    def delayed(batch_payloads, staged):
        import time
        time.sleep(0.02)                  # the next batch stages meanwhile
        queries = assemble_dsq(batch_payloads)[0]
        seen.append(torch.equal(staged.wait().cpu(),
                                torch.from_numpy(queries)))
        return execute(batch_payloads, staged)

    sdsq.scheduler.execute_fn = delayed
    queries, paths, rec = _mix(ds, 256)
    with sdsq:
        tickets = [sdsq.submit(queries[i], paths[i], recursive=rec[i])
                   for i in range(256)]
        results = [t.result(60.0) for t in tickets]
    assert len(results) == 256 and seen and all(seen)
    assert sdsq.scheduler.stage_faults == 0


@pytest.mark.gpu
def test_compaction_rebuilds_cached_device_words():
    """After ``maint_compact`` every cached scope's device words are
    rebuilt for the compacted store, ``ceil(new_n / 32)`` long, and the
    batch after compaction is the batch before it, ids mapped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.vectordb import MaintenancePolicy
    ds, db = _wiki_db(with_ivf=True)
    queries, paths, rec = _mix(ds, 32)
    db.dsq_batch(queries, paths, k=10, recursive=rec)
    deep = sorted(set(ds.entry_paths), key=lambda p: (-p.count("/"), p))
    victims = [p for p in deep[:64]
               if not any(q != p and q.startswith(p) for q in deep)][:8]
    assert not any(r for r in db.dsm_batch(
        [("remove", p) for p in victims]).errors)
    assert 0 < db.store.n_deleted < len(db.store) // 4
    before = db.dsq_batch(queries, paths, k=10, recursive=rec)
    cache = db.planner().cache
    assert any(ent._words is not None for ent in cache._entries.values())
    mgr = db.maintenance(policy=MaintenancePolicy(tombstone_fraction=0.0,
                                                  tombstone_min=1))
    seen = []
    propagate = mgr._propagate_remap
    mgr._propagate_remap = lambda m: (seen.append(np.array(m)),
                                      propagate(m))[1]
    kinds = [r["kind"] for r in mgr.run_all()]
    assert "maint_compact" in kinds and len(seen) == 1
    new_n = len(db.store)
    for ent in cache._entries.values():
        assert ent._words is None and ent.n == new_n
        w = ent.words
        assert w.is_cuda and w.shape[0] == (new_n + 31) // 32
    after = db.dsq_batch(queries, paths, k=10, recursive=rec)
    for a, b in zip(after, before):
        mapped = np.where(b.ids >= 0, seen[0][np.maximum(b.ids, 0)], -1)
        np.testing.assert_array_equal(a.ids, mapped)
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.gpu
@pytest.mark.parametrize("precision,rescore_k", [("fp32", None),
                                                 ("int8", None),
                                                 ("pq", 80)])
def test_four_shard_batch_on_card_equals_flat(precision, rescore_k):
    """The sharded tier on one card, 4 row shards: the batch equals the
    flat batch bit for bit, each scan group launching its kernel (2, 6 or
    8) once per shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ds, db = _wiki_db()
    db.build_ann("sharded", n_shards=4)
    ex = db.executors["sharded"]
    assert [d.type for d in ex.mesh] == ["cuda"] * 4
    queries, paths, rec = _mix(ds, 32)
    kw = dict(k=10, recursive=rec, precision=precision, rescore_k=rescore_k)
    flat = db.dsq_batch(queries, paths, **kw)
    db.dsq_batch(queries, paths, executor="sharded", **kw)   # pins slots
    ops.reset_launch_counts()
    got = db.dsq_batch(queries, paths, executor="sharded", **kw)
    kernel = {"fp32": "multi_scope_topk", "int8": "multi_scope_topk_i8",
              "pq": "multi_scope_topk_pq"}[precision]
    acct = got[0].batch
    assert acct.plan_groups.get("scan", 0) > 0
    assert ops.launch_counts()[kernel] == 4
    assert acct.shard_mask_hits == acct.plan_groups["scan"]
    for a, b in zip(got, flat):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.gpu
def test_shard_merge_on_card_keeps_empty_lanes():
    """A scope of 3 rows inside shard 2 of 4, ranked for k = 10 on the
    card: the 7 empty lanes are -1 (not the previous shard's last row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.distributed import search as dsearch
    from repro_torch.launch.mesh import make_mesh_for_devices
    mesh = make_mesh_for_devices(n_shards=4)
    n, d = 4096, 32
    g = np.random.default_rng(3)
    rows = g.normal(size=(n, d)).astype(np.float32)
    members = [2100, 2101, 2140]
    words = np.zeros((1, n // 32), np.uint32)
    for i in members:
        words[0, i >> 5] |= np.uint32(1 << (i & 31))
    alive = np.full(n // 32, 0xFFFFFFFF, np.uint32)
    q = torch.from_numpy(g.normal(size=(3, d)).astype(np.float32))
    fn = dsearch.make_sharded_batch_search(mesh, n, d, 10)
    vals, ids = fn(dsearch.shard_rows(mesh, rows, n),
                   dsearch.shard_words(mesh, words, n),
                   dsearch.shard_words(mesh, alive, n),
                   np.zeros(3, np.int32), q.cuda())
    ids = ids.cpu().numpy()
    assert (ids[:, 3:] == -1).all()
    assert {int(x) for x in ids[:, :3].ravel()} == set(members)
    assert (vals[:, 3:] == ref.NEG_INF).all()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_differential_fuzz_on_card(seed):
    """``tests/test_torch_differential.py``'s seeded op fuzz with every
    database on the card (dim 16, k 5, ~100-200 rows, 8 IVF lists): the
    kernels' tiny-shape paths in front of the pure-Python oracle, the three
    strategies and the flat / sharded / IVF / PG executors at fp32, int8
    and PQ, sharded == flat bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from test_torch_differential import run_fuzz_seed
    run_fuzz_seed(seed, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_on_card_matches_cpu(accum):
    """One ``make_train_step`` step of the smoke qwen3-0.6b (fp32, 2
    layers) on the card against the same step on the CPU, from the same
    parameters and batch: losses within rtol 1e-5, every updated parameter
    within 1e-4 of its largest magnitude (plain IEEE fp32 on both; the
    products are summed in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import smoke_config
    from repro_torch.models import Transformer, init_params, model_schema
    from repro_torch.training import (DataConfig, OptConfig,
                                      SyntheticLMData, init_opt_state,
                                      make_train_step)
    cfg = smoke_config("qwen3-0.6b")
    tree = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                       cfg.param_dtype(), "cpu")
    batch = SyntheticLMData(DataConfig(cfg.vocab_size, 32, 8)).batch(0)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1),
                           accum_steps=accum)
    out = {}
    for dev in ("cpu", "cuda"):
        model = Transformer(cfg, tree, device=dev, trainable=True)
        params = {n: p.detach() for n, p in model.named_parameters()}
        _, m = step(model, init_opt_state(params), batch)
        out[dev] = (float(m["loss"]), {n: p.cpu() for n, p in params.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, want in out["cpu"][1].items():
        err = (out["cuda"][1][name] - want).abs().max()
        assert err <= 1e-4 * want.abs().max(), (name, float(err))


_FAMILIES = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-130m",
             "hymba-1.5b", "whisper-large-v3", "phi-3-vision-4.2b"]


def _family_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    if cfg.num_patches:
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("name", _FAMILIES)
def test_family_prefill_decode_on_card_matches_cpu(name):
    """The smoke config of each new family (fp32): prefill, then two
    decode steps teacher-forced with the CPU's tokens, on the card (kernel
    10 for every attention, self and cross) against the port on the CPU
    (plain versions): logits and every cache leaf within 1e-4 of their
    largest magnitude (plain IEEE fp32 on both, products summed in other
    orders); whisper within 5e-4 (observed 9e-5 of it: its smoke
    encoder's std-0.71 leaves amplify the roundings, as in
    tests/test_torch_models.py's NEW_TOL_BY)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import smoke_config
    from repro_torch.models import (Transformer, decode_step, init_params,
                                    model_schema, prefill)
    cfg = smoke_config(name)
    tree = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                       cfg.param_dtype(), "cpu")
    batch = _family_batch(cfg, 3, 12)
    steps = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                              size=(2, 3, 1))
    out = {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        model = Transformer(cfg, tree, device=dev)
        logits, cache = prefill(model, batch, cfg, 12 + cfg.meta_tokens + 4)
        seen = [logits.cpu()]
        for nxt in steps:
            logits, cache = decode_step(model, cache, nxt, cfg)
            seen.append(logits.cpu())
        out[dev] = seen, {k: t.cpu() for k, t in cache.items()}
    per_step = 0 if cfg.attn_free else cfg.n_layers * (
        2 if cfg.is_encdec else 1)
    assert ops.launch_counts()["flash_decode"] == 2 * per_step
    tol = 5e-4 if cfg.is_encdec else 1e-4
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert (got - want).abs().max() <= tol * want.abs().max()
    for key, want in out["cpu"][1].items():
        got = out["cuda"][1][key]
        if key == "len":
            assert torch.equal(got, want)
            continue
        err = (got.float() - want.float()).abs().max()
        assert err <= tol * want.float().abs().max(), (key, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-130m",
                                  "hymba-1.5b"])
def test_family_train_step_on_card_matches_cpu(name):
    """One ``make_train_step`` step of the MoE, SSM and hybrid smoke
    configs (fp32) on the card against the CPU, from the same parameters
    and batch: losses within rtol 1e-5, every updated parameter within
    1e-3 of its largest magnitude (AdamW's first update is ~lr * sign(g)
    for gradients near zero, so a rounding-level gradient difference moves
    a parameter by up to 2 lr = 2e-3 of a leaf; eps 1e-3 keeps that
    smooth, as in tests/test_torch_training.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import smoke_config
    from repro_torch.models import Transformer, init_params, model_schema
    from repro_torch.training import (DataConfig, OptConfig,
                                      SyntheticLMData, init_opt_state,
                                      make_train_step)
    cfg = smoke_config(name)
    tree = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                       cfg.param_dtype(), "cpu")
    batch = SyntheticLMData(DataConfig(cfg.vocab_size, 32, 8)).batch(0)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          eps=1e-3))
    out = {}
    for dev in ("cpu", "cuda"):
        model = Transformer(cfg, tree, device=dev, trainable=True)
        params = {n: p.detach() for n, p in model.named_parameters()}
        _, m = step(model, init_opt_state(params), batch)
        out[dev] = (float(m["loss"]), {n: p.cpu() for n, p in params.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for pname, want in out["cpu"][1].items():
        err = (out["cuda"][1][pname] - want).abs().max()
        assert err <= 1e-3 * want.abs().max(), (pname, float(err))


def _top2_gaps(model, cfg, context, steps):
    """The CPU path's greedy decode of one context: the gap between the
    largest and second-largest logit at each of ``steps`` steps."""
    from repro_torch.models import decode_step, prefill
    toks = np.asarray(context, np.int32)[None, :]
    logits, cache = prefill(model, {"tokens": toks}, cfg,
                            toks.shape[1] + cfg.meta_tokens + steps)
    gaps = []
    for _ in range(steps):
        top = torch.topk(logits[0, -1].float(), 2).values
        gaps.append(float(top[0] - top[1]))
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, cache = decode_step(model, cache, cur, cfg)
    return gaps


@pytest.mark.gpu
def test_serve_smoke_on_card_matches_cpu():
    """``launch.serve --smoke`` (fp32) on the card against its own CPU run,
    both at ``--batch 1`` from the same parameters: every request served,
    hits equal, and tokens equal up to a greedy near-tie. Where the tokens
    first differ, the CPU logits' top-2 gap at that step must be under 1e-4
    (the two paths sum products in other orders), and the test says so;
    later tokens follow different contexts and are not compared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import serve
    from repro_torch.models import Transformer, init_params, model_schema
    argv = ["--smoke", "--batch", "1", "--requests", "6", "--qps", "20",
            "--new-tokens", "6", "--contexts", "300"]
    cfg = serve.model_config(serve.parse_args(argv))
    tree = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                       cfg.param_dtype(), "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        args = serve.parse_args(argv + ["--device", dev])
        b = serve.build(args, params=Transformer(cfg, tree, device=dev))
        out = serve.serve(b.server, b.queries, b.scopes, b.prompts,
                          qps=args.qps, max_batch=1, slo_ms=args.slo_ms,
                          queue_capacity=args.queue_capacity,
                          new_tokens=args.new_tokens, seed=args.seed)
        assert (out["served"], out["shed"], out["failed"]) == (6, 0, 0), dev
        runs[dev] = (b, {r["index"]: r for r in out["results"]})
    (cpu_b, cpu), (_, card) = runs["cpu"], runs["cuda"]
    for i, want in cpu.items():
        got = card[i]
        assert got["hits"] == want["hits"] and \
            got["scope_size"] == want["scope_size"], i
        diff = np.nonzero(got["tokens"] != want["tokens"])[0]
        if len(diff) == 0:
            continue
        j = int(diff[0])
        ctx = cpu_b.server.ctx
        context = cpu_b.server.assemble_with_prompt(
            [ctx.payloads[e] for e in want["hits"]], cpu_b.prompts[i])
        gap = _top2_gaps(cpu_b.server.params, cfg, context, j + 1)[j]
        print(f"request {i}: tokens differ from step {j}, a near-tie of "
              f"the CPU logits (top-2 gap {gap:.3g})")
        assert gap < 1e-4, (i, j, gap)
