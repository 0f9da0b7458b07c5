"""The bf16 / int8 rows of the port's ``make_scoped_search`` against the
reference's ``local_search`` on a 1-device mesh, and the two input-spec
builders of ``distributed/search.py`` (the twin of
``tests/test_sharded.py::test_multi_scope_input_specs_shapes``).

The reference contracts bf16 products with fp32 accumulation in XLA's
order, the port in torch's, so scores agree within 1e-5 of the largest
|score| and ids agree except at lanes whose score lies within that
tolerance of a neighbour's (a near-tie either order may break).

int8 rows under l2: XLA on the CPU may keep excess precision
(``--xla_allow_excess_precision``, on by default) and fuse the rows'
bf16 dequantisation into the norm's fp32 sum without rounding it, while
the dot reads the rounded bf16 rows. The program asks for bf16 rows in
both, as the port computes, so those cases run the reference in a
subprocess with the flag off."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.distributed import search as dsearch  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402

REL_TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]

_STRICT = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
from test_torch_search_specs import _reference
a = np.load(sys.argv[1])
v, i = _reference(a["db"], a["mask"], a["queries"], int(a["k"]),
                  str(a["metric"]), jnp.int8)
np.savez(sys.argv[1], v=v, i=i)
"""


def _reference_strict(tmp_path, db, mask, queries, k, metric):
    """:func:`_reference` for int8 rows, in a process whose XLA rounds
    every bf16 value it is asked for."""
    path = str(tmp_path / "case.npz")
    np.savez(path, db=db, mask=mask, queries=queries, k=k, metric=metric)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _STRICT, path,
                           str(ROOT / "tests")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = np.load(path)
    return out["v"], out["i"]


def _reference(db, mask, queries, k, metric, dtype):
    from repro.compat import make_mesh
    from repro.distributed.search import make_scoped_search
    mesh = make_mesh((1,), ("data",))
    n, d = db.shape
    fn = make_scoped_search(mesh, n, d, k, metric=metric, dtype=dtype)
    if dtype == jnp.int8:
        rows = jnp.asarray(db, jnp.int8)
    else:
        rows = jnp.asarray(db, jnp.bfloat16)
    v, i = fn(rows, jnp.asarray(mask), jnp.asarray(queries))
    return np.asarray(v, np.float32), np.asarray(i)


def _check(got_v, got_i, want_v, want_i):
    finite = np.isfinite(want_v)
    assert np.array_equal(got_i >= 0, finite)
    tol = REL_TOL * np.abs(want_v[finite]).max()
    np.testing.assert_allclose(got_v[finite], want_v[finite], rtol=0,
                               atol=tol)
    # ids equal, except where a neighbour's score is within the tolerance
    for q in range(want_v.shape[0]):
        v = want_v[q]
        for j in np.nonzero(finite[q])[0]:
            gaps = [abs(v[j] - v[o]) for o in (j - 1, j + 1)
                    if 0 <= o < len(v) and np.isfinite(v[o])]
            if min(gaps, default=np.inf) > tol:
                assert got_i[q, j] == want_i[q, j], (q, j)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_low_precision_scoped_search_matches_reference(n_shards, kind,
                                                       metric, tmp_path):
    n, d, k, q = 512, 32, 10, 5
    rng = np.random.default_rng(3)
    mask = (rng.random(n) < 0.4).astype(np.int8)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    if kind == "int8":
        host = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        rows = torch.from_numpy(host)
        tdt, jdt = torch.int8, jnp.int8
    else:
        host = rng.normal(size=(n, d)).astype(np.float32)
        rows = torch.from_numpy(host).to(torch.bfloat16)
        tdt, jdt = torch.bfloat16, jnp.bfloat16
    if kind == "int8" and metric == "l2":
        want_v, want_i = _reference_strict(tmp_path, host, mask, queries, k,
                                           metric)
    else:
        want_v, want_i = _reference(host, mask, queries, k, metric, jdt)
    mesh = make_mesh_for_devices(device="cpu", n_shards=n_shards)
    n_loc = n // n_shards
    fn = dsearch.make_scoped_search(mesh, n, d, k, metric=metric, dtype=tdt)
    got_v, got_i = fn([rows[s * n_loc:(s + 1) * n_loc]
                       for s in range(n_shards)],
                      dsearch.shard_rows(mesh, mask, n),
                      torch.from_numpy(queries))
    _check(got_v.numpy(), got_i.numpy(), want_v, want_i)


def test_low_precision_search_is_shard_invariant():
    """The merge of 4 shards equals the 1-shard search bit for bit."""
    n, d, k = 256, 16, 8
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                            ).to(torch.bfloat16)
    mask = (rng.random(n) < 0.5).astype(np.int8)
    queries = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32))
    out = []
    for shards in (1, 4):
        mesh = make_mesh_for_devices(device="cpu", n_shards=shards)
        fn = dsearch.make_scoped_search(mesh, n, d, k, dtype=torch.bfloat16)
        out.append(fn(list(rows.chunk(shards)),
                      dsearch.shard_rows(mesh, mask, n), queries))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_scoped_search_refuses_other_row_types():
    mesh = make_mesh_for_devices(device="cpu")
    with pytest.raises(ValueError, match="fp32, bf16 or int8"):
        dsearch.make_scoped_search(mesh, 64, 8, 4, dtype=torch.float16)


def test_search_input_specs_shapes():
    """Per-shard meta tensors with the reference's shapes, split by row."""
    from repro.compat import make_mesh
    from repro.distributed.search import search_input_specs as ref_specs
    (rdb, rmask, rq), _ = ref_specs(make_mesh((1,), ("data",)), 256, 32, 6)
    for shards in (1, 4):
        mesh = make_mesh_for_devices(device="cpu", n_shards=shards)
        db, mask, q = dsearch.search_input_specs(mesh, 256, 32, 6)
        assert len(db) == len(mask) == shards
        assert all(t.is_meta for t in db + mask + [q])
        assert sum(t.shape[0] for t in db) == rdb.shape[0]
        assert db[0].shape == (256 // shards, 32)
        assert db[0].dtype == torch.bfloat16
        assert mask[0].shape == (256 // shards,)
        assert mask[0].dtype == torch.int8
        assert tuple(q.shape) == rq.shape and q.dtype == torch.bfloat16
        assert rmask.dtype == jnp.int8 and rdb.dtype == jnp.bfloat16
    db, _, _ = dsearch.search_input_specs(mesh, 256, 32, 6, dtype=torch.int8)
    assert db[0].dtype == torch.int8
    with pytest.raises(ValueError):
        dsearch.search_input_specs(mesh, 258, 32, 6)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_multi_scope_input_specs_shapes(n_shards):
    mesh = make_mesh_for_devices(device="cpu", n_shards=n_shards)
    db, words, alive, sids, q = dsearch.multi_scope_search_input_specs(
        mesh, n_total=256, dim=32, n_queries=6, n_scopes=3)
    assert len(db) == len(words) == len(alive) == n_shards
    n_loc = 256 // n_shards
    assert db[0].shape == (n_loc, 32) and db[0].dtype == torch.float32
    assert words[0].shape == (3, n_loc // 32)
    assert words[0].dtype == torch.int32
    assert alive[0].shape == (n_loc // 32,) and alive[0].dtype == torch.int32
    assert sids.shape == (6,) and sids.dtype == torch.int32
    assert q.shape == (6, 32) and q.dtype == torch.float32
    # together the shards hold the reference's (3, 8) words
    assert sum(w.shape[1] for w in words) == 8
    with pytest.raises(ValueError):
        dsearch.multi_scope_search_input_specs(mesh, n_total=100, dim=32,
                                               n_queries=6, n_scopes=3)
    if n_shards == 4:       # 4 shards of 32 rows: one word each
        dsearch.multi_scope_search_input_specs(mesh, 128, 32, 6, 3)
        with pytest.raises(ValueError):
            dsearch.multi_scope_search_input_specs(mesh, 64, 32, 6, 3)
