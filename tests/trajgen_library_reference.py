"""The trajectory library of ``chip_smoke.py``'s trajgen phase, run on the
CPU through the JAX package's ``TrajectoryGenerator`` (the reference) and,
with ``--port``, through the port's: what each package's solve ends at, and
the port's Riccati kernel (its g++ build, the card's arithmetic) against
the scan on the library's first KKT system and on the one at the iterate
the kernel's run ended at, as the smoke compares them on the card.

    JAX_PLATFORMS=cpu python tests/trajgen_library_reference.py \\
        [--dtype float32] [--waypoints 32] [--amplitude 0.8] [--port]

The waypoints are the smoke's: rest states, both joint angles uniform in
±amplitude rad from numpy seed 0; ``double_pendulum``, N=40, dt=0.05,
|u| <= 60, ``SolverOptions(tol=1e-6, max_iter=100)``.  Not a test: pytest
does not collect it.
"""

import argparse
import dataclasses
import time

import numpy as np


def waypoints(n, amplitude):
    rng = np.random.default_rng(0)
    wps = np.zeros((n, 4))
    wps[:, :2] = rng.uniform(-amplitude, amplitude, (n, 2))
    return wps


def summary(name, seconds, segs, residual):
    status = [int(s.status) for s in segs]
    print(f"{name}: {seconds:.1f} s, statuses "
          f"{ {c: status.count(c) for c in sorted(set(status))} }, worst "
          f"endpoint {max(s.endpoint_err for s in segs):.4g}, endpoints of "
          f"the first 3 {[float(f'{s.endpoint_err:.2g}') for s in segs[:3]]}"
          f", worst RK4 residual {residual:.4g}", flush=True)


def reference(wps, dtype):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from mahi_mpc_tpu import SolverOptions, TrajectoryParameters
    from mahi_mpc_tpu.models import make_dynamics
    from mahi_mpc_tpu.models.integrators import rk4_step
    from mahi_mpc_tpu.trajgen import TrajectoryGenerator

    dyn = make_dynamics("double_pendulum")
    tp = TrajectoryParameters("lib", num_x=4, num_u=2, step_size=0.05,
                              num_shooting_nodes=40)
    gen = TrajectoryGenerator(
        tp, dyn, opts=SolverOptions(tol=1e-6, max_iter=100, dtype=dtype),
        u_min=[-60.0] * 2, u_max=[60.0] * 2)
    t0 = time.perf_counter()
    segs = gen.generate(wps)
    seconds = time.perf_counter() - t0
    step = jax.vmap(rk4_step(dyn.f, 0.05))
    residual = max(float(np.abs(np.asarray(step(
        s.X[:-1].astype(np.float64), s.U.astype(np.float64))) - s.X[1:]).max())
        for s in segs)
    summary(f"JAX {dtype}", seconds, segs, residual)


def port(wps, dtype):
    import torch

    from mahi_mpc_tpu_torch.examples.trajectory_library import (
        OPTS, make_generator)
    from mahi_mpc_tpu_torch.models import make_step
    from mahi_mpc_tpu_torch.solver.riccati import solve_lqr
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_cpu_build
    from mahi_mpc_tpu_torch.solver.stage_qp import build_stage_qp

    opts = dataclasses.replace(OPTS, kkt_backend="pallas", dtype=dtype)
    gen = make_generator("double_pendulum", 40, 0.05, 60.0, "cpu", opts)
    t0 = time.perf_counter()
    segs = gen.generate(wps)
    seconds = time.perf_counter() - t0
    X = torch.as_tensor(np.stack([s.X for s in segs]), dtype=torch.float64)
    U = torch.as_tensor(np.stack([s.U for s in segs]), dtype=torch.float64)
    step = make_step(gen.dynamics.f, 0.05, gen.mp.integrator)
    xn = step(X[:, :-1].reshape(-1, 4).T, U.reshape(-1, 2).T)
    residual = float((xn.T.reshape(U.shape[:2] + (4,)) - X[:, 1:]).abs().max())
    summary(f"port {dtype}", seconds, segs, residual)
    if dtype != "float32":
        return
    pb, X0, U0 = gen.problem_batch(wps)
    full = lambda v: torch.full((X0.shape[0],), v)
    for at, Xa, Ua, mu in (("first", X0, U0, OPTS.mu_init),
                           ("last", X, U, max(OPTS.mu_min, 0.1 * OPTS.tol))):
        qp = build_stage_qp(gen.problem, Xa.float(), Ua.float(), pb,
                            full(mu), full(1e-8))
        k, ref = solve_lqr_kernel_cpu_build(qp), solve_lqr(qp, "riccati")
        rel = max(float(((a - b).abs().amax(dim=(1, 2))
                         / b.abs().amax(dim=(1, 2))).max())
                  for a, b in ((k.dz, ref.dz), (k.du, ref.du)))
        print(f"port: Riccati kernel (g++) vs scan, {at} KKT system: "
              f"{rel:.3g} of max|ref|", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--waypoints", type=int, default=32)
    ap.add_argument("--amplitude", type=float, default=0.8)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    wps = waypoints(args.waypoints, args.amplitude)
    reference(wps, args.dtype)
    if args.port:
        port(wps, args.dtype)


if __name__ == "__main__":
    main()
