"""The controls: the reference put in the program's place at a lower
precision, judged by the same check as the program's answers.

    python3 bench/control.py --workload <cell> --seeds 1,2,3

For each seed the cell's data, query pool and (for a DSM cell) a replayed
stream of ``--ops`` DSM ops are made as a run makes them; ``--sample``
requests drawn from the pool, each at a state drawn among the op counts,
are answered by each control and judged against the reference. The
controls of a configuration are its ``control`` (TF32 for exact fp32, an
int4 scan for the int8 plan; the next precision below the one it states)
and the int8 plan with no rescore beyond k. Prints one JSON line per seed
and control with every number compared and its limit. The program does
not run; the benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def controls(cfg: dict, k: int, window: int):
    """(name, ranking plan, its window) of each control."""
    return [(cfg["control"], cfg["control"],
             window if cfg["control"] in ("int8", "int4") else k),
            ("int8_no_rescore", "int8", k)]


def readings(run, sample_n: int, n_ops: int, rng) -> list:
    """Every control's numbers on one seed."""
    run.generate()
    run.t0 = run.t1 = 0.0                   # no window: nothing timed
    if run.replay is not None:
        while len(run.ops) < n_ops and run.submit_dsm(0.0):
            pass
    run.dsm_readback = {}
    n = len(run.order)
    picks = run.order[rng.choice(n, min(sample_n, n), replace=False)]
    states = rng.integers(0, len(run.ops) + 1, len(picks))
    bare = [(int(i), int(s), None, None) for i, s in zip(picks, states)]
    _, masks, queries = run.scope_masks(bare)
    ref = run.ranker(run.cfg["precision"], run.window_k)
    out = []
    for name, plan, window in controls(run.cfg, run.k, run.window_k):
        ctl = run.ranker(plan, window)
        ctl.rows, ctl.entry_dir = ref.rows, ref.entry_dir
        ids, scores = ctl.topk(queries, masks, run.k)
        answers = [(i, s, ids[j], scores[j])
                   for j, (i, s, _, _) in enumerate(bare)]
        out.append((name, run.check(answers=answers, ranker=ref)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sample", type=int, default=1024)
    ap.add_argument("--ops", type=int, default=320)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["USE_FLAX"] = "0"
    from bench import harness
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload,
                             harness.with_workload(args.workload))
    for seed in [int(x) for x in args.seeds.split(",")]:
        run = harness.Run(spec, seed, 1.0, False, "cuda")
        rng = np.random.default_rng([seed, 7])
        for name, checks in readings(run, args.sample, args.ops, rng):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name,
                              "correct": harness.passed(checks),
                              "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
