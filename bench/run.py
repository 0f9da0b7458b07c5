"""The benchmark's one command:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (data from the seed, ingest, warm-up), measures for
``--seconds``, checks a sample of the answers against the plain reference
and prints one JSON object as the last line of standard output; the
numbers compared, each with its limit, are the last lines of standard
error. It runs only on a CUDA card: without one (or without as many as
the cell asks for) it prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # the kernels build once per checkout, inside it (build/, ignored by git)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    from bench import harness
    spec = harness.cell_spec(args.workload)
    import torch
    chips = int(spec["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.execute(spec, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
