"""Inside the port: the lanes SQP against the fused solve's plain version on
the 4-DOF arm (tests/test_fused_kernel.py:26-95's setup and bands, the
warm regime where full steps pass), float32 on the CPU."""

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver import solve_batch_fused, solve_batch_lanes
from mahi_mpc_tpu_torch.transcribe.shooting import (MPCParams, default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 8, 10


@pytest.fixture(scope="module")
def warm_start():
    """Problem, perturbed params and the lanes cold plan to warm from."""
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("t", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-20.0] * 4,
                         u_max=[20.0] * 4, dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    p = default_params(mp, device="cpu")._replace(
        q=f32([10.0] * 4 + [1.0] * 4), r=f32([0.1] * 4), rm=f32([0.01] * 4))
    p = MPCParams(*[type(f)(*[a.expand((B,) + a.shape).clone() for a in f])
                    if isinstance(f, tuple) else f.expand((B,) + f.shape)
                    .clone() for f in p])
    p = p._replace(x0=f32(0.2 * rng.standard_normal((B, 8))),
                   x_des=f32(0.2 * rng.standard_normal((B, N, 8))))
    opts = SolverOptions(tol=1e-4, max_iter=12)
    cold = solve_batch_lanes(prob, p, opts=opts, mu0=opts.mu_init)
    assert bool((cold.status == 0).all())
    return prob, p._replace(x0=p.x0 + 0.01), cold, opts


def test_single_iteration_matches_fused(warm_start):
    """One lanes iteration == one fused iteration from the same warm start
    at the warm barrier: X and U at atol 2e-5."""
    prob, p, cold, opts = warm_start
    mu = opts.warm_mu_factor * opts.tol
    ra = solve_batch_lanes(prob, p, cold.X, cold.U,
                           SolverOptions(tol=1e-4, max_iter=1), mu0=mu)
    rb = solve_batch_fused(prob, p, cold.X, cold.U, opts, mu0=mu, n_iter=1)
    assert bool((ra.iters == 1).all())
    np.testing.assert_allclose(rb.X.numpy(), ra.X.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(rb.U.numpy(), ra.U.numpy(), rtol=0, atol=2e-5)


def test_warm_solve_matches_fused_fixed3(warm_start):
    """The adaptive warm lanes solve (3 iterations in this regime) against
    fused fixed-3: statuses, X and U at atol 1e-5, obj at rtol 1e-5."""
    prob, p, cold, opts = warm_start
    mu = opts.warm_mu_factor * opts.tol
    rw = solve_batch_lanes(prob, p, cold.X, cold.U, opts, mu0=mu)
    rf = solve_batch_fused(prob, p, cold.X, cold.U, opts, mu0=mu, n_iter=3)
    assert bool((rw.status == 0).all()) and bool((rf.status == 0).all())
    assert bool((rw.iters == 3).all())
    np.testing.assert_allclose(rf.X.numpy(), rw.X.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rf.U.numpy(), rw.U.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rf.obj.numpy(), rw.obj.numpy(), rtol=1e-5)
    assert float(rf.feas.max()) < opts.tol
