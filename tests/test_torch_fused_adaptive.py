"""The port's fused solve in adaptive mode (plain PyTorch version) against
the JAX package's Pallas kernel in interpret mode: a cold solve from zero
init through the whole barrier continuation, mahi_arm, B=8, N=8."""

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
from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

B, N = 8, 8
TOL = 1e-4


def _problems(seed=0):
    """The same bench-shaped problem in both packages, from one numpy seed."""
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
def cold_pair():
    jprob, pb, prob, tp = _problems()
    jopts = JaxSolverOptions(tol=TOL, max_iter=30, dtype="float32")
    rj = jax_solve_fused(jprob, pb, None, None, jopts,
                         mu0=jnp.asarray(jopts.mu_init, jnp.float32),
                         adaptive=True, tile=(1, 8), interpret=True)
    opts = SolverOptions(tol=TOL, max_iter=30)
    rt = solve_batch_fused(prob, tp, opts=opts, mu0=opts.mu_init,
                           adaptive=True)
    return jax.tree.map(np.asarray, rj), rt


def test_adaptive_status_matches_jax(cold_pair):
    rj, rt = cold_pair
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    assert bool((rt.status == 0).all())


def test_adaptive_iterations_match_jax(cold_pair):
    """Per-instance iteration counts within +-1: a line-search rung choice
    can flip on float32 roundoff and shift one barrier stage."""
    rj, rt = cold_pair
    assert np.abs(rt.iters.numpy() - rj.iters).max() <= 1
    assert rt.iters.min() >= 1 and rt.iters.max() < 30


def test_adaptive_solution_matches_jax(cold_pair):
    """X and U at atol 1e-3: over ~9 iterations a rung choice may flip on
    float32 roundoff, which moves the path (not the limit) by up to this."""
    rj, rt = cold_pair
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=1e-3)


def test_adaptive_converged_to_tolerance(cold_pair):
    """Converged in its own right: final step and defects below tol."""
    _, rt = cold_pair
    assert float(rt.kkt.max()) < TOL
    assert float(rt.feas.max()) < TOL
