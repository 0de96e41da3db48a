"""LTV (successive-linearization) mode of the port against the JAX package:
the exact discrete affine step ``_ltv_discrete``, the lanes solver in LTV
mode (tests/test_batched_lanes.py's LTV setup), and the fused solve in LTV
mode — its plain PyTorch version and the g++ builds of its kernel bodies,
one-thread and group — against the JAX lanes solver on
tests/test_fused_adaptive.py's LTV setup."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver import batched as jb
from mahi_mpc_tpu.transcribe.shooting import LinPoint as JaxLinPoint
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver import batched as tb
from mahi_mpc_tpu_torch.solver.fused import (solve_batch_fused,
                                             solve_batch_fused_cpu_kernel)
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)


def _problems(model, N, dt, lim, integrator="euler"):
    """The same LTV problem in both packages."""
    jdyn, dyn = jax_make_dynamics(model), make_dynamics(model)
    kw = dict(num_x=dyn.nx, num_u=dyn.nu, step_size=dt, num_shooting_nodes=N,
              dynamics_name=model, is_linear=True, integrator=integrator,
              u_min=[-lim] * dyn.nu, u_max=[lim] * dyn.nu)
    jmp = JaxModelParameters("ltv", **kw)
    return (jax_make_problem(jmp, jdyn), make_problem(
        ModelParameters("ltv", **kw), dyn), jmp, jdyn)


def _batch(jmp, jdyn, B, q, r, rm, x0, u0, x_des, dtype):
    """JAX params with a per-instance frozen linearization at (x0, u0), and
    the same params converted for the port."""
    jd = getattr(jnp, dtype)
    p = jax_default_params(jmp, dtype=jd)
    p = p._replace(q=jnp.asarray(q, jd), r=jnp.asarray(r, jd),
                   rm=jnp.asarray(rm, jd))
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    x0, u0 = jnp.asarray(x0, jd), jnp.asarray(u0, jd)
    A, Bm, xd0 = jax.jit(jax.vmap(jdyn.linearize))(x0, u0)
    p = p._replace(x0=x0, u_prev=u0, x_des=jnp.asarray(x_des, jd),
                   lin=JaxLinPoint(A.astype(jd), Bm.astype(jd),
                                   xd0.astype(jd), x0, u0))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu",
                                dtype=getattr(torch, dtype))


# ---------------------------------------------------------------------------
# _ltv_discrete: the exact affine step of the frozen linearization.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ltv_discrete_matches_jax(integrator, dtype):
    """(Ad, Bd, cd) from random frozen linearizations (A, B, x_dot0, x0,
    u0): float64 at 1e-10, float32 at 1e-5."""
    jprob, prob, jmp, _ = _problems("double_pendulum", 6, 0.05, 40.0,
                                    integrator)
    B, nx, nu = 5, prob.nx, prob.nu
    rng = np.random.default_rng(3)
    lin = [rng.standard_normal(s) for s in
           ((B, nx, nx), (B, nx, nu), (B, nx), (B, nx), (B, nu))]
    jd = getattr(jnp, dtype)
    p = jax_default_params(jmp, dtype=jd)
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    p = p._replace(lin=JaxLinPoint(*[jnp.asarray(a, jd) for a in lin]))
    ref = jb._ltv_discrete(jprob, p)
    got = tb._ltv_discrete(prob, params_from_numpy(
        jax.tree.map(np.asarray, p), device="cpu",
        dtype=getattr(torch, dtype)))
    tol = 1e-10 if dtype == "float64" else 1e-5
    for g, r in zip(got, ref):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=tol)


def test_ltv_discrete_checks_batch():
    """One frozen linearization per instance: an unbatched ``lin`` (the
    default params' single zero linearization) is refused."""
    _, prob, _, _ = _problems("pendulum", 4, 0.05, 4.0)
    from mahi_mpc_tpu_torch.transcribe.shooting import default_params
    p = default_params(ModelParameters(
        "ltv", num_x=2, num_u=1, step_size=0.05, num_shooting_nodes=4,
        dynamics_name="pendulum", is_linear=True), device="cpu")
    p = p._replace(x0=p.x0.expand(3, 2), u_prev=p.u_prev.expand(3, 1))
    with pytest.raises(ValueError, match="lin"):
        tb._ltv_discrete(prob, p)


# ---------------------------------------------------------------------------
# The lanes solver in LTV mode: tests/test_batched_lanes.py's LTV setup
# (double pendulum, B=8, N=12, dt=0.01, |u| <= 40, seed 5).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["float64", "float32"])
def lanes_pair(request):
    dtype = request.param
    jprob, prob, jmp, jdyn = _problems("double_pendulum", 12, 0.01, 40.0)
    B, nx, nu = 8, prob.nx, prob.nu
    rng = np.random.default_rng(5)
    x0 = 0.2 * rng.standard_normal((B, nx))
    u0 = 0.1 * rng.standard_normal((B, nu))
    x_des = 0.2 * rng.standard_normal((B, 12, nx))
    jp, tp = _batch(jmp, jdyn, B, [10.0] * nx, [0.5] * nu, [0.01] * nu, x0,
                    u0, x_des, dtype)
    okw = dict(tol=1e-5, max_iter=40, dtype=dtype, kkt_backend="riccati")
    rj = jb.solve_batch_lanes(jprob, jp, opts=JaxSolverOptions(**okw))
    rt = tb.solve_batch_lanes(prob, tp, opts=SolverOptions(**okw))
    return dtype, jax.tree.map(np.asarray, rj), rt


def test_lanes_ltv_matches_jax(lanes_pair):
    """float64: equal statuses and iterations, X and U at 1e-7; float32:
    equal statuses, iterations within +-1, X and U at 1e-3 (the lanes
    bands of tests/test_torch_batched_lanes.py); the objective at 1e-5."""
    dtype, rj, rt = lanes_pair
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    assert (rj.status == 0).all()
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iters.numpy(), rj.iters)
        tol = 1e-7
    else:
        assert np.abs(rt.iters.numpy() - rj.iters).max() <= 1
        tol = 1e-3
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=tol)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=tol)
    np.testing.assert_allclose(rt.obj.numpy(), rj.obj, rtol=1e-5)


def test_lanes_ltv_defects_are_affine(lanes_pair):
    """At the solution the LTV defects (the batched affine step minus the
    next state) are at roundoff, and they equal the defects of the frozen
    continuous model integrated by the problem's own step."""
    dtype, _, rt = lanes_pair
    _, prob, jmp, jdyn = _problems("double_pendulum", 12, 0.01, 40.0)
    rng = np.random.default_rng(5)
    nx, nu = prob.nx, prob.nu
    _, tp = _batch(jmp, jdyn, 8, [10.0] * nx, [0.5] * nu, [0.01] * nu,
                   0.2 * rng.standard_normal((8, nx)),
                   0.1 * rng.standard_normal((8, nu)),
                   0.2 * rng.standard_normal((8, 12, nx)), dtype)
    c = tb._defects_ltv(prob, rt.X, rt.U, tp)
    assert float(c.abs().max()) < (1e-9 if dtype == "float64" else 1e-4)
    lp = tp.lin
    xn = torch.stack([torch.stack([
        tb._ltv_step_one(prob, type(lp)(*[a[b] for a in lp]),
                         rt.X[b, k], rt.U[b, k]) for k in range(12)])
        for b in range(8)])
    np.testing.assert_allclose((xn - rt.X[:, 1:]).numpy(), c.numpy(),
                               rtol=0, atol=1e-9 if dtype == "float64"
                               else 1e-5)


# ---------------------------------------------------------------------------
# The fused solve in LTV mode (tests/test_fused_adaptive.py:113-133's pin:
# mahi_arm, B=8, N=8, dt=2 ms, |u| <= 20, float32, seed 0).
# ---------------------------------------------------------------------------

FUSED_BODIES = {"plain": solve_batch_fused,
                "kernel_body": solve_batch_fused_cpu_kernel,
                "group_body": functools.partial(solve_batch_fused_cpu_kernel,
                                                body="group")}


@pytest.fixture(scope="module")
def fused_ltv_case():
    jprob, prob, jmp, jdyn = _problems("mahi_arm", 8, 0.002, 20.0)
    B, nx, nu = 8, prob.nx, prob.nu
    rng = np.random.default_rng(0)
    x0 = 0.2 * rng.standard_normal((B, nx))
    x_des = 0.2 * rng.standard_normal((B, 8, nx))
    jp, tp = _batch(jmp, jdyn, B, [10.0] * 4 + [1.0] * 4, [0.1] * nu,
                    [0.01] * nu, x0, np.zeros((B, nu)), x_des, "float32")
    jopts = JaxSolverOptions(tol=1e-4, max_iter=30, dtype="float32")
    mu_cold = jnp.asarray(jopts.mu_init, jnp.float32)
    mu_warm = jnp.asarray(jopts.warm_mu_factor * jopts.tol, jnp.float32)
    rl = jb.solve_batch_lanes(jprob, jp, None, None, jopts, mu0=mu_cold)
    jp2 = jp._replace(x0=jp.x0 + 0.01)
    rl2 = jb.solve_batch_lanes(jprob, jp2, rl.X, rl.U, jopts, mu0=mu_warm)
    tp2 = tp._replace(x0=tp.x0 + 0.01)
    return (prob, tp, tp2, jax.tree.map(np.asarray, rl),
            jax.tree.map(np.asarray, rl2))


@pytest.mark.parametrize("body", list(FUSED_BODIES))
def test_fused_ltv_matches_jax_lanes(fused_ltv_case, body):
    """Cold adaptive: every instance converges, U at atol 5e-3 of the JAX
    lanes LTV solve; warm fixed-3 from the lanes plan at x0 + 0.01: U at
    atol 1e-3 of the JAX lanes warm solve."""
    prob, tp, tp2, rl, rl2 = fused_ltv_case
    solve = FUSED_BODIES[body]
    opts = SolverOptions(tol=1e-4, max_iter=30)
    rf = solve(prob, tp, opts=opts, mu0=opts.mu_init, adaptive=True)
    assert bool((rf.status == 0).all())
    np.testing.assert_allclose(rf.U.numpy(), rl.U, rtol=0, atol=5e-3)
    X0, U0 = torch.tensor(rl.X), torch.tensor(rl.U)
    rf2 = solve(prob, tp2, X0, U0, opts,
                mu0=opts.warm_mu_factor * opts.tol, n_iter=3)
    np.testing.assert_allclose(rf2.U.numpy(), rl2.U, rtol=0, atol=1e-3)


def test_fused_ltv_needs_no_dynamics(fused_ltv_case):
    """The fused LTV step is the streamed affine map alone: a problem whose
    dynamics cannot even be evaluated solves the same."""
    prob, tp, _, _, _ = fused_ltv_case

    def broken(x, u):
        raise AssertionError("LTV mode evaluated the nonlinear model")

    dyn = dataclasses.replace(prob.dynamics, f=broken)
    opts = SolverOptions(tol=1e-4, max_iter=30)
    ra = solve_batch_fused(prob, tp, opts=opts, mu0=opts.mu_init,
                           adaptive=True)
    rb = solve_batch_fused(dataclasses.replace(prob, dynamics=dyn), tp,
                           opts=opts, mu0=opts.mu_init, adaptive=True)
    np.testing.assert_array_equal(ra.U.numpy(), rb.U.numpy())
