"""Synchronous MPC simulation, the reference's ``model_control`` example
(``examples/model_control_example.cpp``): a simulation loop at the model's
step, a re-solve every Mth tick (``:74-76``), ZOH control between solves, an
RK4 plant distinct from the predictor (``:82-86``), and the results
exported with a solve-time report (``:95-152``).

    python -m mahi_mpc_tpu_torch.examples.model_generate --name dp \\
        --u-limit 60 --dt 0.01
    python -m mahi_mpc_tpu_torch.examples.model_control --name dp \\
        [--resolve-every 5] [--out results] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from mahi_mpc_tpu_torch import SolverOptions
from mahi_mpc_tpu_torch.models import rk4_step
from mahi_mpc_tpu_torch.runtime import ModelControl
from mahi_mpc_tpu_torch.utils import ControlLog


def reference_traj(mp, t, amp=0.3, freq=1.0):
    """A sinusoid per position coordinate and its rate, node by node."""
    N, nx = mp.num_shooting_nodes, mp.num_x
    tt = t + (1 + np.arange(N)) * mp.step_size
    half = nx // 2
    traj = np.zeros((N, nx))
    w = 2 * np.pi * freq
    for j in range(half):
        sgn = 1.0 if j % 2 == 0 else -1.0
        traj[:, j] = sgn * amp * np.sin(w * tt)
        traj[:, half + j] = sgn * amp * w * np.cos(w * tt)
    return traj


def plant_step(dyn, dt):
    """The RK4 plant on the host, in float64."""
    step = rk4_step(dyn.f, dt)
    return lambda x, u: step(torch.as_tensor(x, dtype=torch.float64),
                             torch.as_tensor(u, dtype=torch.float64)).numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="double_pendulum")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--resolve-every", type=int, default=5,
                    help="solve cadence in simulation ticks (reference: 5)")
    ap.add_argument("--out", default=None, help="export prefix (csv/npz/png)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mc = ModelControl(args.name, directory=args.dir, device=args.device,
                      opts=SolverOptions(tol=1e-4, max_iter=40))
    mp = mc.params
    qdef = [10.0, 1.0, 5.0, 5.0][:mp.num_x] + [1.0] * max(0, mp.num_x - 4)
    mc.update_weights(Q=qdef, R=[0.5] * mp.num_u, Rm=[0.0] * mp.num_u)
    plant = plant_step(mc.dynamics, mp.step_size)
    print(f"loaded '{mp.name}': nx={mp.num_x}, nu={mp.num_u}, "
          f"N={mp.num_shooting_nodes}, dt={mp.step_size * 1e3:.1f} ms, "
          f"warm solver {mc.warm_solver} on {mc.device}")
    mc.warmup()

    log = ControlLog()
    x = np.zeros(mp.num_x)
    x[0] = 0.3
    u = np.zeros(mp.num_u)
    for k in range(args.steps):
        t = k * mp.step_size
        traj = reference_traj(mp, t)
        solve_ms = np.nan
        if k % args.resolve_every == 0:
            t0 = time.perf_counter()
            mc.calc_u(t, x, u, traj)
            solve_ms = (time.perf_counter() - t0) * 1e3
        u = mc.control_at_time(t)
        x = plant(x, u)
        log.append(t, x, u, x_des=traj[0], solve_ms=solve_ms,
                   iters=mc.control_results().iters)

    rep = log.timing_report()
    _, x_arr, _, xd_arr = log.arrays()
    err = np.abs(x_arr[:, 0] - xd_arr[:, 0])
    print(f"avg solve time: {rep['mean_ms']:.2f} ms "
          f"(p50 {rep['p50_ms']:.2f}, p99 {rep['p99_ms']:.2f}) "
          f"over {rep['solves']} solves on {mc.device}")
    print(f"tracking |err| mean {err.mean():.4f} (first-50 "
          f"{err[:50].mean():.4f} -> last-50 {err[-50:].mean():.4f})")
    if args.out:
        print("exported:", log.to_csv(args.out + ".csv"),
              log.to_npz(args.out + ".npz"), log.to_png(args.out + ".png"))
    return rep, err


if __name__ == "__main__":
    main()
