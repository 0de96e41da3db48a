"""Asynchronous real-time MPC, the reference's ``thread_model_control``
example (``examples/thread_model_control_example.cpp``): a free-running
solver thread re-plans while a control loop at 1 kHz samples
``control_at_time`` and steps the plant.

    python -m mahi_mpc_tpu_torch.examples.model_generate --name dp \\
        --u-limit 60
    python -m mahi_mpc_tpu_torch.examples.thread_model_control --name dp \\
        [--seconds 2.0] [--warm-solver auto|fused|fixed|adaptive]
        [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from mahi_mpc_tpu_torch import SolverOptions
from mahi_mpc_tpu_torch.examples.model_control import plant_step
from mahi_mpc_tpu_torch.runtime import ModelControl


def reference_traj(mp, t):
    """A sinusoid per node (``thread_model_control_example.cpp:78-86``)."""
    N, nx = mp.num_shooting_nodes, mp.num_x
    tt = t + (1 + np.arange(N)) * mp.step_size
    half = nx // 2
    traj = np.zeros((N, nx))
    for j in range(half):
        sgn = 1.0 if j % 2 == 0 else -1.0
        traj[:, j] = sgn * 0.3 * np.sin(2 * np.pi * tt)
        traj[:, half + j] = sgn * 0.3 * 2 * np.pi * np.cos(2 * np.pi * tt)
    return traj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="double_pendulum")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rate", type=float, default=1000.0,
                    help="control loop rate in Hz (reference: 1 kHz)")
    # Reference weights Q=[10,1,5,5], R=[5,5]
    # (thread_model_control_example.cpp:24-25).
    ap.add_argument("-q", type=float, nargs="*", default=None)
    ap.add_argument("-r", type=float, nargs="*", default=None)
    ap.add_argument("--warm-solver", default="auto",
                    choices=["auto", "fused", "fixed", "adaptive"],
                    help="'fused' (the default on the card) serves warm "
                         "re-solves from one launch of the fused kernel")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    fixed = 3 if args.warm_solver in ("auto", "fused", "fixed") else 0
    mc = ModelControl(args.name, directory=args.dir, Q=args.q, R=args.r,
                      device=args.device,
                      opts=SolverOptions(tol=1e-4, max_iter=40,
                                         warm_solver=args.warm_solver,
                                         fixed_warm_iters=fixed))
    mp = mc.params
    print(f"loaded '{mp.name}': nx={mp.num_x}, nu={mp.num_u}, "
          f"N={mp.num_shooting_nodes}, warm solver {mc.warm_solver} on "
          f"{mc.device}")
    if args.q is None:
        qdef = [10.0, 1.0, 5.0, 5.0][:mp.num_x] + [1.0] * max(0, mp.num_x - 4)
        mc.update_weights(Q=qdef, R=[0.5] * mp.num_u, Rm=[0.0] * mp.num_u)
    dt_ctrl = 1.0 / args.rate
    plant = plant_step(mc.dynamics, dt_ctrl)
    print("warming up...")
    mc.warmup()

    x = np.zeros(mp.num_x)
    x[0] = 0.3
    u = np.zeros(mp.num_u)
    mc.set_state(0.0, x, u, reference_traj(mp, 0.0))
    mc.start_calc()
    # The reference's warm-start sleep: 100 ms
    # (thread_model_control_example.cpp:68).
    time.sleep(0.1)
    steps = int(args.seconds * args.rate)
    misses = 0
    errs = []
    t_wall0 = time.perf_counter()
    try:
        for k in range(steps):
            t = k * dt_ctrl
            u = mc.control_at_time(t)
            x = plant(x, u)
            mc.set_state(t + dt_ctrl, x, u, reference_traj(mp, t + dt_ctrl))
            errs.append(abs(x[0] - 0.3 * np.sin(2 * np.pi * (t + dt_ctrl))))
            slack = t_wall0 + (k + 1) * dt_ctrl - time.perf_counter()
            if slack > 0:
                time.sleep(slack)
            else:
                misses += 1
    finally:
        mc.stop_calc()

    s = mc.stats.summary()
    errs = np.asarray(errs)
    print(f"\ncontrol loop: {steps} ticks @ {args.rate:.0f} Hz, {misses} "
          f"deadline misses ({100 * misses / steps:.1f}%)")
    if s["solves"]:
        print(f"solver thread: {s['solves']} solves, mean {s['mean_ms']:.2f} "
              f"ms, p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, mean "
              f"iters {s['mean_iters']:.1f}, failures {s['failures']}, stale "
              f"serves {s['served_stale']}")
    else:
        print("solver thread: no solve finished")
    print(f"tracking |err| mean {errs.mean():.4f}, first-100 "
          f"{errs[:100].mean():.4f} -> last-100 {errs[-100:].mean():.4f}")
    return s, errs


if __name__ == "__main__":
    main()
