"""Dry-run of every (arch x shape) cell on the card's data sheet: the specs'
bytes, the step's work and its roofline, with no allocation (the port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun        # on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --memory-gb 80 --viking-scan

The reference lowers and compiles each cell on 512 fake host devices and
reads XLA's cost analysis of full-depth and unrolled 1- and 2-layer
compiles. The port compiles nothing: each record holds the bytes of the
cell's spec trees (``launch/specs.py``: parameters, the optimizer state
for ``train``, the batch, the cache for ``decode``), the step's FLOPs and
bytes counted from the schema (``analysis/roofline.py::step_cost``), the
roofline terms on the H100 data sheet, and ``fits``: whether the trees fit
one device's memory (the card's own when ``--device cuda``, else
``--memory-gb``). ``--viking-scan`` adds the directory-scoped scan step
over the row-sharded store, at the reference's sizes. Importing this
module reads no environment variable and touches no device. Records go to
``build/dryrun/<arch>_<shape>_<mesh>.json`` unless ``--out`` names
another directory; a record already there is kept unless ``--force``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..analysis import roofline as RL
from ..configs import ARCHS, SHAPES, cell_applicable, get_arch
from ..device import resolve_device
from .mesh import make_mesh_for_devices, make_production_mesh, \
    mesh_device_count
from .specs import (batch_specs, cache_specs, opt_specs, params_specs,
                    tree_bytes)

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _mesh_name(chips: int) -> str:
    return f"{chips}xH100"


def _roofline(cost: Dict[str, float], chips: int, model_flops: float,
              peak: float = RL.PEAK_FLOPS) -> Dict[str, object]:
    """:func:`~repro_torch.analysis.roofline.terms_from` at the bf16 peak,
    or its terms at ``peak`` (the fp32 scan's products)."""
    t = RL.terms_from(cost, chips, model_flops)
    if peak != RL.PEAK_FLOPS:
        t.compute_s = cost["flops"] / (chips * peak)
    return {"compute_s": t.compute_s, "memory_s": t.memory_s,
            "collective_s": t.collective_s, "bound_s": t.bound_s,
            "dominant": t.dominant,
            "roofline_fraction": t.roofline_fraction}


def run_cell(arch: str, shape_name: str, chips: int,
             memory_bytes: Optional[float] = None) -> dict:
    """One cell's record: the reference's keys where they mean the same
    (``arch``, ``shape``, ``mesh``, ``n_layers``, ``skipped``,
    ``reason``, ``params``, ``active_params``, ``model_flops``), then
    ``bytes`` (per spec tree and in all), ``cost`` (``step_cost``),
    ``roofline`` and ``fits`` (None when ``memory_bytes`` is None)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(chips),
           "n_layers": cfg.n_layers, "skipped": not ok, "reason": reason,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "model_flops": RL.model_flops_estimate(cfg, shape)}
    if not ok:
        return rec
    trees = {"params": params_specs(cfg), "batch": batch_specs(cfg, shape)}
    if shape.kind == "train":
        trees["opt"] = opt_specs(cfg)
    if shape.kind == "decode":
        trees["cache"] = cache_specs(cfg, shape)
    nbytes = {name: tree_bytes(tree) for name, tree in trees.items()}
    nbytes["total"] = sum(nbytes.values())
    cost = RL.step_cost(cfg, shape)
    rec.update(bytes=nbytes, cost=cost,
               roofline=_roofline(cost, chips, rec["model_flops"]),
               fits=(None if memory_bytes is None
                     else nbytes["total"] <= memory_bytes))
    return rec


def _scan_record(arch: str, shape: str, chips: int, trees: Dict[str, list],
                 flops: float, out_bytes: float, peak: float,
                 memory_bytes: Optional[float]) -> dict:
    """A scan's record: per-shard and total bytes of its arguments (the
    queries replicated on every shard), its work (the products, every
    argument read once, ``out_bytes`` written) and ``fits`` of one
    shard's arguments."""
    per_shard = sum(tree_bytes(t[0]) if isinstance(t, list) else
                    tree_bytes(t) for t in trees.values())
    total = sum(sum(tree_bytes(x) for x in t) if isinstance(t, list) else
                tree_bytes(t) for t in trees.values())
    cost = {"flops": flops, "bytes": float(total + out_bytes),
            "link_bytes": 0.0}
    return {"arch": arch, "shape": shape, "mesh": _mesh_name(chips),
            "model_flops": flops,
            "bytes": {"per_shard": per_shard, "total": total},
            "cost": cost, "roofline": _roofline(cost, chips, flops, peak),
            "fits": None if memory_bytes is None
            else per_shard <= memory_bytes}


def run_viking_scan(chips: int, n_total: int = 2 ** 28, dim: int = 1024,
                    n_queries: int = 64, k: int = 100,
                    dtype: str = "bfloat16", device="cpu",
                    memory_bytes: Optional[float] = None) -> dict:
    """The directory-scoped top-k over the row-sharded store
    (``distributed.search.make_scoped_search`` at bf16 or int8 rows)."""
    from ..distributed.search import search_input_specs
    mesh = make_mesh_for_devices(device=device, n_shards=chips)
    db, mask, q = search_input_specs(
        mesh, n_total, dim, n_queries,
        dtype={"bfloat16": torch.bfloat16, "int8": torch.int8}[dtype])
    flops = 2.0 * n_total * dim * n_queries
    return _scan_record("viking-scan", f"n{n_total}_q{n_queries}_k{k}_{dtype}",
                        chips, {"db": db, "mask": mask, "queries": q}, flops,
                        n_queries * k * 12, RL.PEAK_FLOPS, memory_bytes)


def run_viking_scan_batch(chips: int, n_total: int = 2 ** 28,
                          dim: int = 1024, n_queries: int = 64,
                          n_scopes: int = 16, k: int = 100, device="cpu",
                          memory_bytes: Optional[float] = None) -> dict:
    """The batched sharded serving step: one call ranks a mixed-scope
    batch against the packed scope table (kernel 2 per shard, fp32 rows,
    ``distributed.search.make_sharded_batch_search``)."""
    from ..distributed.search import multi_scope_search_input_specs
    mesh = make_mesh_for_devices(device=device, n_shards=chips)
    db, words, alive, sids, q = multi_scope_search_input_specs(
        mesh, n_total, dim, n_queries, n_scopes)
    flops = 2.0 * n_total * dim * n_queries
    return _scan_record(
        "viking-scan-batch", f"n{n_total}_q{n_queries}_s{n_scopes}_k{k}",
        chips, {"db": db, "words": words, "alive": alive, "sids": sids,
                "queries": q}, flops, n_queries * k * 12,
        RL.PEAK_FLOPS_FP32, memory_bytes)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS),
                    help="single arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="single shape (default: all)")
    ap.add_argument("--chips", type=int, default=None,
                    help="cards of the mesh (default: one per visible card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--memory-gb", type=float, default=None,
                    help="device memory in GB (1e9 bytes) for 'fits' when "
                    "not on a card")
    ap.add_argument("--viking-scan", action="store_true",
                    help="also dry-run the scoped-search serving steps")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--force", action="store_true", help="recompute cached")
    return ap.parse_args(argv)


def main(argv=None) -> List[dict]:
    """Write (or keep) one record per cell; returns every record."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    chips = (args.chips if args.chips is not None else
             mesh_device_count(make_production_mesh(device=dev)))
    if dev.type == "cuda":
        memory = float(torch.cuda.get_device_properties(0).total_memory)
    else:
        memory = None if args.memory_gb is None else args.memory_gb * 1e9
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    jobs = [(f"{a}_{s}", lambda a=a, s=s: run_cell(a, s, chips, memory))
            for a in archs for s in shapes]
    if args.viking_scan:
        jobs += [("viking-scan", lambda: run_viking_scan(
                     chips, device=dev, memory_bytes=memory)),
                 ("viking-scan-batch", lambda: run_viking_scan_batch(
                     chips, device=dev, memory_bytes=memory))]
    records = []
    for name, job in jobs:
        path = outdir / f"{name}_{_mesh_name(chips)}.json"
        if path.exists() and not args.force:
            print(f"[cached] {path.name}")
            records.append(json.loads(path.read_text()))
            continue
        t0 = time.perf_counter()
        rec = job()
        rec["wall_s"] = time.perf_counter() - t0
        path.write_text(json.dumps(rec, indent=1))
        records.append(rec)
        if rec.get("skipped"):
            print(f"[SKIP] {path.name}: {rec['reason']}")
        else:
            r = rec["roofline"]
            print(f"[OK] {path.name}: {rec['bytes']['total'] / 1e9:.2f} GB "
                  f"fits={rec['fits']} bound {r['bound_s'] * 1e3:.3f} ms "
                  f"({r['dominant']})", flush=True)
    return records


if __name__ == "__main__":
    main()
