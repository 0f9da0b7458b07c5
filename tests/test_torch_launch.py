"""The port's launch and analysis tools against the JAX package's: the spec
trees (``launch/specs.py``) leaf for leaf in all 10 full-width archs x 4
shapes, the roofline's analytic counts, the dry-run's records, the
production mesh, and the open-loop serving launcher (``launch/serve.py``)
request for request against the reference's ``RAGServer.answer``.

The port's parameters carry flat per-layer names (``layers.<i>.attn.wq``,
as ``Transformer.named_parameters()`` gives them); the reference stacks
each layer leaf ``(L, ...)`` under its path. They are compared by
restacking the port's leaves in the reference's flattening order (sorted
keys, ``models/convert.py``'s). Both sides allocate nothing: meta tensors
against ``jax.ShapeDtypeStruct``."""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis import roofline as JRL  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_applicable as jcell_applicable  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro_torch.analysis import roofline as RL  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def jmesh():
    from repro.compat import make_mesh
    return make_mesh((1, 1), ("data", "model"))


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _flat_ref(tree):
    """The reference's tree as ``{dotted path: (shape, dtype)}``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(k.key) for k in path): (tuple(x.shape),
                                                 _dtype(x.dtype))
            for path, x in leaves}


def _restack(flat):
    """The port's per-layer leaves stacked as the reference stacks them:
    ``layers.<i>.<path>`` -> ``layers.<path>`` of shape ``(L, ...)``."""
    groups, out = {}, {}
    for name, t in flat.items():
        m = re.match(r"(.*?layers)\.(\d+)\.(.*)", name)
        if m is None:
            out[name] = (tuple(t.shape), _dtype(t.dtype))
            continue
        key = f"{m.group(1)}.{m.group(3)}"
        groups.setdefault(key, {})[int(m.group(2))] = t
    for key, by_layer in groups.items():
        shapes = {(tuple(t.shape), _dtype(t.dtype))
                  for t in by_layer.values()}
        assert sorted(by_layer) == list(range(len(by_layer))), key
        assert len(shapes) == 1, key
        (shape, dt), = shapes
        out[key] = ((len(by_layer),) + shape, dt)
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_reference_leaf_for_leaf(arch, shape, jmesh):
    from repro.launch import specs as jspecs
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jshape = JSHAPES[shape]
    p = specs.params_specs(cfg)
    assert all(t.is_meta for t in p.values())
    assert _restack(p) == _flat_ref(jspecs.params_specs(jcfg, jmesh)[0])
    jopt = jspecs.opt_specs(jcfg, jmesh)[0]
    opt = specs.opt_specs(cfg)
    for key in ("mu", "nu"):
        assert _restack(opt[key]) == _flat_ref(jopt[key])
    assert (tuple(opt["step"].shape), _dtype(opt["step"].dtype)) == (
        (), "int32") == (jopt["step"].shape, _dtype(jopt["step"].dtype))
    b = specs.batch_specs(cfg, SHAPES[shape])
    assert {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in b.items()} \
        == _flat_ref(jspecs.batch_specs(jcfg, jshape, jmesh)[0])
    c = specs.cache_specs(cfg, SHAPES[shape])
    assert {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in c.items()} \
        == _flat_ref(jspecs.cache_specs(jcfg, jshape, jmesh)[0])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_counts_match_reference(arch, shape):
    """``model_flops_estimate`` and ``hbm_bytes_analytic`` equal the
    reference's, and ``terms_from`` reads the same FLOP and byte inputs
    (its terms differ by the peaks only: H100 against TPU v5e)."""
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jshape, shp = JSHAPES[shape], SHAPES[shape]
    mf = RL.model_flops_estimate(cfg, shp)
    assert mf == JRL.model_flops_estimate(jcfg, jshape)
    assert RL.hbm_bytes_analytic(cfg, shp) == JRL.hbm_bytes_analytic(jcfg,
                                                                    jshape)
    cost = RL.step_cost(cfg, shp)
    assert cost["bytes"] == JRL.hbm_bytes_analytic(jcfg, jshape)
    assert cost["link_bytes"] == 0.0 and cost["flops"] > 0
    t, jt = RL.terms_from(cost, 1, mf), JRL.terms_from(cost, 1, mf)
    assert t.hlo_flops == jt.hlo_flops == cost["flops"]
    assert t.model_flops == jt.model_flops == mf
    assert t.compute_s * RL.PEAK_FLOPS == pytest.approx(
        jt.compute_s * JRL.PEAK_FLOPS, rel=1e-12)
    assert t.memory_s * RL.HBM_BW == pytest.approx(
        jt.memory_s * JRL.HBM_BW, rel=1e-12)


def test_step_cost_formula_on_a_dense_model():
    """step_cost by hand for a dense GQA model: projections, head and the
    causal score / value products; train triples it."""
    from repro_torch.configs import ShapeSpec
    cfg = get_arch("qwen3-0.6b")
    D, H, KV, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                          cfg.d_ff, cfg.vocab_size)
    per_tok = D * H * hd * 2 + D * KV * hd * 2 + 3 * D * F
    B, S = 2, 8
    attn = 4 * B * H * hd * (S * (S + 1) / 2) * cfg.n_layers
    pre = RL.step_cost(cfg, ShapeSpec("p", S, B, "prefill"))["flops"]
    assert pre == 2 * B * S * per_tok * cfg.n_layers + 2 * B * D * V + attn
    train = RL.step_cost(cfg, ShapeSpec("t", S, B, "train"))["flops"]
    assert train == 3 * (2 * B * S * per_tok * cfg.n_layers
                         + 2 * B * S * D * V + attn)
    dec = RL.step_cost(cfg, ShapeSpec("d", S, B, "decode"))["flops"]
    assert dec == (2 * B * per_tok * cfg.n_layers + 2 * B * D * V
                   + 4 * B * H * hd * S * cfg.n_layers)


def test_specs_bytes_equal_an_allocated_model():
    """At smoke width the specs' names, shapes and bytes are those of a
    real model and its optimizer state, and the cache specs' are those of
    a real prefill's cache."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.launch.train import build
    from repro_torch.models import prefill
    for arch in ("qwen3-0.6b", "hymba-1.5b", "deepseek-moe-16b"):
        cfg = smoke_config(arch)
        model, params, opt = build(cfg, "cpu")
        p = specs.params_specs(cfg)
        assert {k: (t.shape, t.dtype) for k, t in p.items()} == {
            k: (t.shape, t.dtype) for k, t in params.items()}
        assert specs.tree_bytes(specs.opt_specs(cfg)) == \
            specs.tree_bytes(opt)
        B, S = 2, 6
        _, cache = prefill(model, {"tokens": np.ones((B, S), np.int32)}, cfg,
                           S + cfg.meta_tokens + 3)
        c = specs.cache_specs(cfg, ShapeSpec("c", S + cfg.meta_tokens + 3,
                                             B, "decode"))
        assert {k: (t.shape, t.dtype) for k, t in c.items()} == {
            k: (t.shape, t.dtype) for k, t in cache.items()}
        assert specs.tree_bytes(c) == specs.tree_bytes(cache)


def test_dryrun_writes_every_cell(tmp_path):
    recs = dryrun.main(["--device", "cpu", "--memory-gb", "80",
                        "--viking-scan", "--out", str(tmp_path)])
    files = sorted(tmp_path.glob("*.json"))
    assert len(recs) == len(files) == len(CELLS) + 2
    by_cell = {(r["arch"], r["shape"]): r for r in recs}
    for arch, shape in CELLS:
        rec = by_cell[(arch, shape)]
        ok, reason = jcell_applicable(jget_arch(arch), JSHAPES[shape])
        assert rec["skipped"] == (not ok) and rec["reason"] == reason
        assert rec["mesh"] == "1xH100" and rec["params"] == \
            jget_arch(arch).param_count()
        if ok:
            assert rec["fits"] == (rec["bytes"]["total"] <= 80e9)
            assert rec["roofline"]["dominant"] in ("compute", "memory")
            assert ("opt" in rec["bytes"]) == (SHAPES[shape].kind == "train")
            assert ("cache" in rec["bytes"]) == (
                SHAPES[shape].kind == "decode")
    scans = [r for r in recs if r["arch"].startswith("viking-scan")]
    assert [r["arch"] for r in scans] == ["viking-scan", "viking-scan-batch"]
    # 2**28 rows of d = 1024 in bf16 do not fit one 80 GB card
    assert scans[0]["bytes"]["per_shard"] >= 2 ** 28 * 1024 * 2
    assert scans[0]["fits"] is False
    on_disk = json.loads((tmp_path / "qwen3-0.6b_train_4k_1xH100.json")
                         .read_text())
    assert on_disk["bytes"] == by_cell[("qwen3-0.6b", "train_4k")]["bytes"]
    # a second run keeps the records; --force recomputes them
    again = dryrun.main(["--device", "cpu", "--arch", "mamba2-130m",
                         "--shape", "decode_32k", "--out", str(tmp_path)])
    assert again[0]["wall_s"] == by_cell[("mamba2-130m",
                                           "decode_32k")]["wall_s"]


def test_dryrun_import_touches_no_device_or_environment():
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    probe = ("import os, sys; before = dict(os.environ); "
             "import repro_torch.launch.dryrun; import torch; "
             "print(dict(os.environ) == before, "
             "torch.cuda.is_initialized())")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]


def test_production_mesh_on_the_cpu():
    mesh = make_production_mesh(device="cpu")
    assert len(mesh) == 1 and mesh[0].type == "cpu"
    with pytest.raises(ValueError, match="pod"):
        make_production_mesh(multi_pod=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k"])


# ------------------------------------------------------------- serving
SERVE_ARGV = ["--smoke", "--device", "cpu", "--batch", "1", "--requests",
              "4", "--qps", "40", "--new-tokens", "5", "--contexts", "300"]


def test_serve_matches_reference_answers():
    """``launch.serve --smoke --batch 1`` with the reference's parameters:
    every request served, each one's tokens equal to the reference's
    ``RAGServer.answer`` of that request alone, and its hits and scope size
    equal to the reference's retrieval."""
    from repro.datasets import make_wiki_dir as jwiki
    from repro.models import model_schema as jschema
    from repro.models.layers import init_params as jinit
    from repro.serving import rag as jrag
    from repro_torch.launch import serve
    from repro_torch.models import from_reference

    args = serve.parse_args(SERVE_ARGV)
    cfg = serve.model_config(args)
    from repro.configs import smoke_config as jsmoke
    jcfg = jsmoke(args.arch).replace(vocab_size=256)
    jp = jinit(jschema(jcfg), jax.random.PRNGKey(0), jcfg.param_dtype())
    model = from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")

    b = serve.build(args, params=model)
    out = serve.serve(b.server, b.queries, b.scopes, b.prompts,
                      qps=args.qps, max_batch=args.batch, slo_ms=args.slo_ms,
                      queue_capacity=args.queue_capacity,
                      new_tokens=args.new_tokens, seed=args.seed)
    assert (out["served"], out["shed"], out["failed"]) == (4, 0, 0)
    assert out["batches"] == 4

    # the reference launcher's set-up, step for step
    ds = jwiki(scale=0.003, dim=64, n_queries=args.requests, seed=args.seed)
    assert np.array_equal(ds.queries, b.ds.queries)
    jctx = jrag.ContextDatabase(dim=64, scope_strategy=args.scope_strategy)
    rng = np.random.default_rng(0)
    for i in range(min(args.contexts, ds.n_entries)):
        jctx.add_context(ds.vectors[i], ds.entry_paths[i],
                         ("L0", "L1", "L2")[i % 3],
                         rng.integers(0, 250, size=16 + 16 * (i % 3)))
    jctx.build("flat")
    rcfg = jrag.RAGConfig(k=6, token_budget=96, escalate_top=2)
    jserver = jrag.RAGServer(jctx, jp, jcfg, rcfg)
    scopes = [a or "/" for a in ds.query_anchors[:args.requests]]
    prompts = [rng.integers(0, 250, size=int(rng.integers(2, 12)))
               for _ in range(args.requests)]
    assert scopes == b.scopes
    assert all(np.array_equal(p, q) for p, q in zip(prompts, b.prompts))
    for r in out["results"]:
        i = r["index"]
        assert r["batch_size"] == 1 and r["tokens"].shape == (5,)
        want = jserver.answer(ds.queries[i:i + 1], [scopes[i]],
                              prompts=[prompts[i]], max_new_tokens=5)
        assert np.array_equal(r["tokens"], np.asarray(want["tokens"])[0]), i
        (hits, stats), = jctx.retrieve_batch(ds.queries[i:i + 1],
                                             [scopes[i]], rcfg)
        assert r["hits"] == [h.entry_id for h in hits]
        assert r["scope_size"] == stats["scope_size"] == \
            want["retrieval_stats"][0]["scope_size"]


def test_serve_main_reports_and_refuses_a_missing_card(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--qps", "100", "--new-tokens", "2", "--contexts",
                      "120"])
    text = capsys.readouterr().out
    assert "served 3/3 requests (shed 0, failed 0)" in text
    assert "latency from scheduled arrival" in text
    assert out["card"]["name"] == "cpu" and out["dtype"] == "float32"
    for key in ("achieved_qps", "p50_ms", "p95_ms", "p99_ms", "max_ms",
                "batches", "occupancy", "queue_mean_ms", "mean_scope"):
        assert np.isfinite(out[key]), key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(ValueError, match="dataset"):
        serve.build(serve.parse_args(["--smoke", "--device", "cpu"]),
                    ctx=object())
