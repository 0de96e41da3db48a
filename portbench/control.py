"""Readings for the limits of ``correct``: for each seed, one run of a
cell with a short window, the numbers the program gives, and the same
numbers with the plain reference computed in a lower precision put in the
program's place (the control).  Not part of a benchmark run.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--dtypes bfloat16] [--device cuda]

One JSON line a seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .run import cache_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache_env()
    from .core import Cell, run
    cell = Cell(args.workload)
    dtypes = [d for d in args.dtypes.split(",") if d]
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        s = run(cell, seed, args.seconds, False, t0, device=args.device,
                control_dtypes=dtypes)
        print(json.dumps(dict(
            workload=cell.name, seed=seed, steps=s["steps"],
            failed=s["failed"], setup_s=s["setup_s"],
            solves_per_s=s["batch"] * s["steps"] / s["window_s"],
            reference_s=s["reference_s"],
            program={k: v["value"] for k, v in s["compared"].items()},
            control=s["control"])), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
