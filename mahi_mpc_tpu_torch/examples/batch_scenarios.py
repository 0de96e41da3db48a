"""Batched scenario MPC demo, the counterpart of the JAX package's
``examples/batch_scenarios.py``: thousands of randomized 4-DOF-arm
instances regulated to random goals in one closed loop on the card.

    python -m mahi_mpc_tpu_torch.examples.batch_scenarios [--batch 4096]
        [--steps 50] [--device cuda|cpu]

The plant is the model's RK4 step, on the device, in the solver's dtype.
Each step runs inside ``annotate("step_<k>")``, so a ``device_trace``
around ``run`` shows the steps as named regions.
"""

import argparse
import time

import numpy as np
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics, rk4_step
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.utils import annotate


def run(batch=4096, steps=50, model="mahi_arm", warm_solver="auto",
        device="cuda"):
    """The closed loop.  Returns the service's metrics after the cold and
    the last step, the share of instances within 0.05 rad of their goal,
    the median errors before and after, and the seconds taken."""
    dyn = make_dynamics(model)
    nq = dyn.nx // 2
    mp = ModelParameters(
        "batch_demo", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
        num_shooting_nodes=25, u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name=model)
    svc = BatchModelControl(
        mp, batch=batch, dynamics=dyn, device=device,
        opts=SolverOptions(tol=1e-4, max_iter=12, warm_solver=warm_solver),
        Q=[10.0] * nq + [1.0] * nq, R=[0.1] * dyn.nu, Rm=[0.01] * dyn.nu)

    rng = np.random.default_rng(0)
    B = batch
    x = np.zeros((B, dyn.nx))
    x[:, :nq] = rng.uniform(-0.5, 0.5, (B, nq))
    goals = rng.uniform(-0.5, 0.5, (B, nq))
    x_des = np.zeros((B, mp.num_shooting_nodes, dyn.nx))
    x_des[:, :, :nq] = goals[:, None, :]
    svc.set_references(x_des)

    kw = dict(dtype=getattr(torch, svc.opts.dtype), device=svc.device)
    x, goals_t = torch.as_tensor(x, **kw), torch.as_tensor(goals, **kw)
    step = rk4_step(dyn.f, mp.step_size)
    plant = lambda x, u: step(x.T, u.T).T
    print(f"batch={B} on {svc.device}, warm solver {svc.warm_solver}")
    err0 = cold = None
    t_all = time.perf_counter()
    for k in range(steps):
        with annotate(f"step_{k}"):
            svc.set_states(x)
            u = svc.step()
            x = plant(x, u)
            err = (x[:, :nq] - goals_t).abs().amax(dim=1).cpu().numpy()
        if err0 is None:
            err0, cold = err.copy(), svc.metrics()
            print(f"  step 0 (cold): {svc.solve_time_s:.1f}s")
        elif k % 10 == 0 or k == steps - 1:
            m = svc.metrics()
            print(f"  step {k}: solve {1e3 * m['solve_s']:.2f} ms, "
                  f"iters {m['mean_iters']:.1f}, conv {m['converged_frac']:.2f}, "
                  f"median err {np.median(err):.4f}")
    el = time.perf_counter() - t_all
    frac = float(np.mean(err < 0.05))
    print(f"\n{steps} steps x {B} instances in {el:.1f}s")
    print(f"instances within 0.05 rad of goal: {100*frac:.1f}% "
          f"(median err {np.median(err0):.3f} -> {np.median(err):.4f})")
    return dict(cold=cold, last=svc.metrics(), within_frac=frac,
                median_err0=float(np.median(err0)),
                median_err=float(np.median(err)), seconds=el)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--model", default="mahi_arm")
    ap.add_argument("--warm-solver", default="auto",
                    choices=["auto", "fused", "fixed", "adaptive"],
                    help="'fused' serves warm steps from the one-launch "
                         "SQP kernel (solver/fused.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.batch, args.steps, args.model, args.warm_solver,
               args.device)


if __name__ == "__main__":
    main()
