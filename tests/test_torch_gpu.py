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
    (9, 5000, 64, 256, "ip", 8, 32),          # the largest k
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
    assert all(v == 1 for v in ops.launch_counts().values())
