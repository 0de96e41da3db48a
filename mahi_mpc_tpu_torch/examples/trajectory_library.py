"""Offline trajectory-library generation, the counterpart of the JAX
package's ``examples/trajectory_library.py``: waypoint CSV in, batched
min-effort point-to-point solves, library CSV out.

    python -m mahi_mpc_tpu_torch.examples.trajectory_library \\
        --model pendulum --waypoints wps.csv --out lib.csv [--device cuda|cpu]

If --waypoints is omitted, a demo waypoint set is used.
"""

import argparse

import numpy as np

from mahi_mpc_tpu_torch import SolverOptions, TrajectoryParameters
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.trajgen import TrajectoryGenerator, write_library_csv

OPTS = SolverOptions(tol=1e-6, max_iter=100)


def make_generator(model, nodes, dt, u_limit, device, opts=OPTS):
    """The example's generator: ``model`` at ``nodes`` steps of ``dt``,
    |u| <= ``u_limit`` when given."""
    dyn = make_dynamics(model)
    tp = TrajectoryParameters("lib_" + model, num_x=dyn.nx, num_u=dyn.nu,
                              step_size=dt, num_shooting_nodes=nodes)
    lims = dict(u_min=[-u_limit] * dyn.nu,
                u_max=[u_limit] * dyn.nu) if u_limit else {}
    return TrajectoryGenerator(tp, dyn, opts=opts, device=device, **lims)


def demo_waypoints(nx):
    """Four rest states, the first coordinate at 0, 0.27, 0.53, 0.8."""
    qs = np.linspace(0.0, 0.8, 4)
    wps = np.zeros((len(qs), nx))
    wps[:, 0] = qs
    return wps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="pendulum")
    ap.add_argument("--waypoints", default=None, help="CSV of waypoint states")
    ap.add_argument("--out", default="trajectory_library.csv")
    ap.add_argument("--nodes", type=int, default=40)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--u-limit", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    gen = make_generator(args.model, args.nodes, args.dt, args.u_limit,
                         args.device)
    if args.waypoints:
        segs = gen.generate_from_csv(args.waypoints, args.out)
    else:
        wps = demo_waypoints(gen.mp.num_x)
        print(f"demo waypoints:\n{wps}")
        segs = gen.generate(wps)
        write_library_csv(args.out, segs, gen.mp)

    for i, s in enumerate(segs):
        print(f"segment {i}: status={s.status} endpoint_err={s.endpoint_err:.2e} "
              f"mean|u|={np.abs(s.U).mean():.3f}")
    print(f"library written to {args.out}")
    return segs


if __name__ == "__main__":
    main()
