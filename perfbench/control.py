"""Read the control of a cell's check on the card: the plain reference
with the torus broken (cells beyond the edge dead), put in the
program's place, on each seed given. The check must come out false.

    python3 perfbench/control.py --workload NAME --seconds S --seeds N ...

Each seed is one whole run of the cell (set-up, a window of S seconds,
the check) in this process; one JSON line per seed gives the numbers the
check compared and whether the run came out correct. The benchmark's
own runs never run the control.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from perfbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench_json["workloads"]
                if c["name"] == args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        result, _ = bench_run.run_cell(bench_json, cell, seed, args.seconds,
                                       False, "cuda:0", time.monotonic(),
                                       control=True)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
