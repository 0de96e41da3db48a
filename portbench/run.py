"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (the end-to-end
metrics, or with ``--trace 1`` the per-layer ones); an earlier line gives
the card's name, power limit and clocks.  The last lines of standard
error give each number compared with its limit.  Exits 2 without the
cards, 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CARD_QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
              "temperature.gpu")


def cache_env() -> None:
    """Every compiler cache at a fixed path inside the checkout (the port
    builds its own libraries into ``mahi_mpc_tpu_torch/_build``)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def card_line() -> dict:
    """nvidia-smi's reading of the cards, as close to the window as the
    run allows (just after it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={CARD_QUERY}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return {"query": CARD_QUERY, "cards": out.stdout.strip().splitlines()}
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"query": CARD_QUERY, "error": repr(e)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    import torch

    from .core import Cell, forbidden_modules, result, run
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    summary = run(cell, args.seed, args.seconds, trace, T_START)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=cell.chips)
    print(json.dumps({"card": card_line(), "steps": summary["steps"],
                      "window_s": summary["window_s"],
                      "reference_s": summary["reference_s"],
                      "reference_parts_s": summary["reference_parts_s"]}),
          flush=True)
    out = result(cell, summary, trace, info)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"loaded in the run's process: {bad}", file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
