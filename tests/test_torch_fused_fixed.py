"""The port's fused solve in fixed mode (plain PyTorch version, which the
CUDA kernel is held against on the card) against the JAX package's Pallas
kernel in interpret mode: warm re-solves of n_iter = 1 and 3 from one
shared warm start, mahi_arm, B=8, N=8; and the two-lane group body's g++
build on the reference's default example (double_pendulum under Euler)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver.fused import solve_batch_fused as jax_solve_fused
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver.fused import (card_body, solve_batch_fused,
                                             solve_batch_fused_cpu_kernel)
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

B, N = 8, 8
TOL = 1e-4


def _problems(seed=0):
    """The same bench-shaped problem in both packages, from one numpy seed:
    returns (jax problem, jax params, port problem, port params)."""
    kw = dict(num_x=8, num_u=4, step_size=0.002, num_shooting_nodes=N,
              u_min=[-20.0] * 4, u_max=[20.0] * 4, dynamics_name="mahi_arm")
    jprob = jax_make_problem(JaxModelParameters("t", **kw),
                             jax_make_dynamics("mahi_arm"))
    prob = make_problem(ModelParameters("t", **kw), make_dynamics("mahi_arm"))
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    p = jax_default_params(JaxModelParameters("t", **kw), dtype=f32)
    p = p._replace(q=jnp.asarray([10.0] * 4 + [1.0] * 4, f32),
                   r=jnp.full((4,), 0.1, f32), rm=jnp.full((4,), 0.01, f32))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, 8)), f32),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, N, 8)), f32))
    return jprob, pb, prob, params_from_numpy(jax.tree.map(np.asarray, pb), device="cpu")


@pytest.fixture(scope="module")
def warm_pair():
    """One warm start (the port's own cold solve) and a perturbed state;
    both packages then re-solve from exactly these arrays."""
    jprob, pb, prob, tp = _problems()
    opts = SolverOptions(tol=TOL, max_iter=30)
    cold = solve_batch_fused(prob, tp, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    X0, U0 = cold.X.numpy(), cold.U.numpy()
    pb2 = pb._replace(x0=pb.x0 + 0.01)
    tp2 = tp._replace(x0=tp.x0 + 0.01)
    jopts = JaxSolverOptions(tol=TOL, max_iter=12, dtype="float32")
    mu_warm = jopts.warm_mu_factor * jopts.tol
    out = {}
    for n in (1, 3):
        rj = jax_solve_fused(jprob, pb2, jnp.asarray(X0), jnp.asarray(U0),
                             jopts, mu0=jnp.asarray(mu_warm, jnp.float32),
                             n_iter=n, tile=(1, 8), interpret=True)
        rt = solve_batch_fused(prob, tp2, torch.tensor(X0), torch.tensor(U0),
                               SolverOptions(tol=TOL, max_iter=12),
                               mu0=mu_warm, n_iter=n)
        out[n] = (jax.tree.map(np.asarray, rj), rt)
    return out


@pytest.mark.parametrize("n_iter", [1, 3])
def test_fixed_iterate_matches_jax(warm_pair, n_iter):
    """X and U at atol 2e-5: the band within which the JAX tests pin the
    fused kernel to the lanes solver (tests/test_fused_kernel.py:56-95);
    float32 roundoff of two implementations of one iteration."""
    rj, rt = warm_pair[n_iter]
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=2e-5)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=2e-5)
    assert rt.X.dtype == torch.float32


@pytest.mark.parametrize("n_iter", [1, 3])
def test_fixed_status_and_stats_match_jax(warm_pair, n_iter):
    """Equal statuses; step norm and defect norm at atol 1e-5 (both are
    max-norms of float32 quantities of order 1e-4 or below)."""
    rj, rt = warm_pair[n_iter]
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    np.testing.assert_array_equal(rt.iters.numpy(), rj.iters)
    np.testing.assert_allclose(rt.kkt.numpy(), rj.kkt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.feas.numpy(), rj.feas, rtol=0, atol=1e-5)


def test_three_warm_iterations_converge(warm_pair):
    """The headline shape converges every instance of this warm regime."""
    _, rt = warm_pair[3]
    assert bool((rt.status == 0).all()), rt.status
    assert float(rt.feas.max()) < TOL


@pytest.fixture(scope="module")
def dp_warm_pair():
    """The reference's default example (examples/model_generate.py and
    model_control.py: double_pendulum under Euler, dt = 2 ms, no control
    bounds, Q = [10, 1, 5, 5], R = 0.5, Rm = 0) at N=8, B=8, numpy seed 0:
    one warm start (the port's cold solve), then warm re-solves of n_iter
    = 1 and 3 at x0 + 0.01 by the JAX Pallas kernel in interpret mode and
    by the port's group body (g++ build, two lanes)."""
    kw = dict(num_x=4, num_u=2, step_size=0.002, num_shooting_nodes=N,
              dynamics_name="double_pendulum")
    jmp = JaxModelParameters("dp", **kw)
    jprob = jax_make_problem(jmp, jax_make_dynamics("double_pendulum"))
    prob = make_problem(ModelParameters("dp", **kw),
                        make_dynamics("double_pendulum"))
    rng = np.random.default_rng(0)
    f32 = jnp.float32
    p = jax_default_params(jmp, dtype=f32)._replace(
        q=jnp.asarray([10.0, 1.0, 5.0, 5.0], f32), r=jnp.full((2,), 0.5, f32),
        rm=jnp.zeros((2,), f32))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, 4)), f32),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, N, 4)), f32))
    tp = params_from_numpy(jax.tree.map(np.asarray, pb), device="cpu")
    opts = SolverOptions(tol=TOL, max_iter=30)
    cold = solve_batch_fused(prob, tp, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    assert bool((cold.status == 0).all())
    X0, U0 = cold.X.numpy(), cold.U.numpy()
    pb2 = pb._replace(x0=pb.x0 + 0.01)
    tp2 = tp._replace(x0=tp.x0 + 0.01)
    jopts = JaxSolverOptions(tol=TOL, max_iter=12, dtype="float32")
    mu_warm = jopts.warm_mu_factor * jopts.tol
    out = {}
    for n in (1, 3):
        rj = jax_solve_fused(jprob, pb2, jnp.asarray(X0), jnp.asarray(U0),
                             jopts, mu0=jnp.asarray(mu_warm, jnp.float32),
                             n_iter=n, tile=(1, 8), interpret=True)
        rt = solve_batch_fused_cpu_kernel(
            prob, tp2, torch.tensor(X0), torch.tensor(U0),
            SolverOptions(tol=TOL, max_iter=12), mu0=mu_warm, n_iter=n,
            body="group")
        out[n] = (jax.tree.map(np.asarray, rj), rt)
    return prob, out


@pytest.mark.parametrize("n_iter", [1, 3])
def test_double_pendulum_group_body_matches_jax(dp_warm_pair, n_iter):
    """The two-lane group body of FastNq<DoublePendulum> (the body the
    card runs for the reference's default example) against the JAX Pallas
    kernel: X and U at atol 2e-5 (the band of
    tests/test_fused_kernel.py:56-95), equal statuses."""
    prob, pairs = dp_warm_pair
    assert card_body(prob) == ("group", 2)
    rj, rt = pairs[n_iter]
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=2e-5)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
