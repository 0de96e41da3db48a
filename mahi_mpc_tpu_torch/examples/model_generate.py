"""Offline model generation, the reference's ``model_generate`` example
(``examples/ex_model_generate.cpp:8-73``): build an MPC model, build the
CUDA kernels its solves launch, and persist ``<name>.json`` and the
``<name>_torch.json`` manifest.

    python -m mahi_mpc_tpu_torch.examples.model_generate [--linear]
        [--name NAME] [--out DIR] [--model double_pendulum|pendulum|...]
        [--dt 0.002] [--nodes 25] [--integrator euler|midpoint|rk4]
        [--u-limit L] [--fixed-warm-iters K] [--device cuda|cpu]
"""

import argparse
import time

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.runtime import ModelGenerator


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--linear", action="store_true",
                    help="successive-linearization (LTV) mode")
    ap.add_argument("--name", default=None)
    ap.add_argument("--model", default="double_pendulum")
    ap.add_argument("--out", default=".")
    # The reference's configuration: 2 ms steps, 25 nodes
    # (ex_model_generate.cpp:56-57).
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--nodes", type=int, default=25)
    ap.add_argument("--integrator", default="euler",
                    choices=["euler", "midpoint", "rk4"])
    ap.add_argument("--u-limit", type=float, default=None,
                    help="symmetric control bound (default unbounded)")
    ap.add_argument("--fixed-warm-iters", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dyn = make_dynamics(args.model)
    name = args.name or (args.model + ("_linear" if args.linear else ""))
    lim = args.u_limit
    mp = ModelParameters(
        name, num_x=dyn.nx, num_u=dyn.nu, step_size=args.dt,
        num_shooting_nodes=args.nodes, is_linear=args.linear,
        u_min=[-lim] * dyn.nu if lim else [],
        u_max=[lim] * dyn.nu if lim else [],
        integrator=args.integrator, dynamics_name=args.model)
    print(f"generating model '{name}' ({args.model}, nx={dyn.nx}, "
          f"nu={dyn.nu}, N={args.nodes}, dt={args.dt * 1e3:.1f} ms, "
          f"{'LTV' if args.linear else 'nonlinear'}) for {args.device}")
    gen = ModelGenerator(mp, dyn, SolverOptions(
        fixed_warm_iters=args.fixed_warm_iters), device=args.device)
    gen.create_model()
    t0 = time.perf_counter()
    manifest = gen.compile_model(args.out)
    print(f"  kernels built and files written in "
          f"{time.perf_counter() - t0:.2f}s")
    print(f"  params file  {args.out}/{name}.json")
    print(f"  manifest     {manifest}")


if __name__ == "__main__":
    main()
