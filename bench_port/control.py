"""Readings for a cell's limits: the program's numbers and the control's,
seed after seed in one process (not run by the benchmark's own runs).

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13 --seconds 20

Each seed builds the cell at its own size, runs its traffic for
``--seconds`` without the warm-up, and judges the window's statements
against the float32 reference with the configuration's int8 weights (the
program's readings) and against the same reference with int4 weights put
in the program's place (the control's).  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as bench_run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)
    bench_run._environment()

    import torch

    from bench_port.harness import spec
    from bench_port.harness.cell import run_cell

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, torch.device("cuda:0"), start,
                       control=True, warmup=False)
        readings = dict(out["readings"])
        print(json.dumps({
            "workload": args.workload, "seed": seed, "program": readings,
            "control": readings.pop("control"), "completed": out["attempted"] - out["failed"],
            "wall_s": time.perf_counter() - start,
        }), flush=True)
    found = bench_run.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
