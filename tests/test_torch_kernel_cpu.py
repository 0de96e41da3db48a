"""The fused kernel's own arithmetic on the CPU: ``csrc/fused_sqp.cuh`` (the
body nvcc compiles for the card) built with g++ and run against the plain
PyTorch version — the port's analogue of Pallas interpret mode.  float64
pins the math to roundoff; float32 holds the bands of the JAX parity
tests."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch._build import cpu_library
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver.fused import (_acc_jacobian, _arm_flat,
                                             solve_batch_fused,
                                             solve_batch_fused_cpu_kernel)
from mahi_mpc_tpu_torch.transcribe.shooting import (MPCParams, default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 8, 8
TOL = 1e-4


def _problem(dtype, name="mahi_arm", x_bounded=False, seed=0):
    dyn = make_dynamics(name)
    nx, nu = dyn.nx, dyn.nu
    kw = {}
    if x_bounded:
        kw = dict(x_min=[-0.3] * dyn.nq + [-30.0] * dyn.nq,
                  x_max=[0.3] * dyn.nq + [30.0] * dyn.nq)
    ulim = 20.0 if name == "mahi_arm" else 60.0
    mp = ModelParameters("t", num_x=nx, num_u=nu, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-ulim] * nu,
                         u_max=[ulim] * nu, dynamics_name=name, **kw)
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    p = default_params(mp, dtype=dtype)._replace(
        q=t([10.0] * dyn.nq + [1.0] * dyn.nq), r=t([0.1] * nu),
        rm=t([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    scale = 0.1 if x_bounded else 0.2
    return prob, p._replace(
        x0=t(scale * rng.standard_normal((B, nx))),
        x_des=t(scale * rng.standard_normal((B, N, nx))))


def _solve_both(prob, p, opts, **kw):
    return (solve_batch_fused_cpu_kernel(prob, p, opts=opts, **kw),
            solve_batch_fused(prob, p, opts=opts, **kw))


def _cold_then_warm(prob, p, opts):
    """Adaptive cold solve, then fixed-3 warm from the plain version's plan
    at a perturbed state, each by kernel and plain version."""
    cold = _solve_both(prob, p, opts, mu0=opts.mu_init, adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.01)
    X0, U0 = cold[1].X, cold[1].U
    warm = (solve_batch_fused_cpu_kernel(prob, p2, X0, U0, opts, n_iter=3),
            solve_batch_fused(prob, p2, X0, U0, opts, n_iter=3))
    return cold, warm


@pytest.fixture(scope="module")
def lib():
    return cpu_library()


@pytest.fixture(scope="module")
def f64_runs(lib):
    prob, p = _problem(torch.float64)
    return _cold_then_warm(prob, p, SolverOptions(tol=TOL, max_iter=30))


@pytest.fixture(scope="module")
def f32_runs(lib):
    prob, p = _problem(torch.float32)
    return _cold_then_warm(prob, p, SolverOptions(tol=TOL, max_iter=30))


@pytest.mark.parametrize("name", ["mahi_arm", "two_link_arm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_dynamics_and_jacobian_rows(lib, name, dtype):
    """The kernel's f (f_elem order) and its dual-number Jacobian rows
    against the tensor-form f and torch.func: float64 at 1e-9 (exact AD both
    sides), float32 at rtol/atol 1e-4 (accelerations and their
    derivatives reach ~1e2-1e3, where float32 keeps ~5 significant digits
    through the Cholesky solve)."""
    dyn = make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    M, dt = 32, 0.002
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((nx, M)), dtype=dtype)
    u = torch.tensor(rng.standard_normal((nu, M)), dtype=dtype)
    fval = torch.empty(nx, M, dtype=dtype)
    jrows = torch.empty(nq, nx + nu, M, dtype=dtype)
    arm = _arm_flat(dyn)
    f64 = dtype == torch.float64
    fn = lib.mpc_arm_eval_cpu_f64 if f64 else lib.mpc_arm_eval_cpu_f32
    rc = fn(M, nq, x.data_ptr(), u.data_ptr(), dt,
            (ctypes.c_double * len(arm))(*arm), fval.data_ptr(),
            jrows.data_ptr())
    assert rc == 0
    ref_f, ref_J = _acc_jacobian(dyn, x.T, u.T)
    tol = dict(rtol=0, atol=1e-9) if f64 else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fval.T.numpy(), ref_f.numpy(), **tol)
    np.testing.assert_allclose(jrows.permute(2, 0, 1).numpy(),
                               (dt * ref_J).numpy(), **tol)


@pytest.mark.parametrize("mode", ["cold_adaptive", "warm_fixed3"])
def test_kernel_matches_plain_f64(f64_runs, mode):
    """float64: X and U at 1e-8, equal statuses and iterations — the kernel
    body and the plain version are the same algorithm in the same order up
    to summation association."""
    cold, warm = f64_runs
    rk, rp = cold if mode == "cold_adaptive" else warm
    np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    np.testing.assert_array_equal(rk.iters.numpy(), rp.iters.numpy())
    assert bool((rk.status == 0).all())


def test_kernel_matches_plain_f32_fixed(f32_runs):
    """float32 fixed-3 warm: the band of the JAX fixed-mode parity (X, U at
    2e-5; kkt, feas at 1e-5; equal statuses)."""
    _, (rk, rp) = f32_runs
    np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    np.testing.assert_allclose(rk.kkt.numpy(), rp.kkt.numpy(), atol=1e-5)
    np.testing.assert_allclose(rk.feas.numpy(), rp.feas.numpy(), atol=1e-5)


def test_kernel_matches_plain_f32_adaptive(f32_runs):
    """float32 adaptive cold: the band of the JAX adaptive parity (equal
    statuses, iterations within +-1, X and U at 1e-3)."""
    (rk, rp), _ = f32_runs
    np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    assert np.abs(rk.iters.numpy() - rp.iters.numpy()).max() <= 1
    np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0, atol=1e-3)
    assert float(rk.kkt.max()) < TOL and float(rk.feas.max()) < TOL


@pytest.mark.parametrize("case", ["x_bounds", "head_pinning", "two_link_arm"])
def test_kernel_branches_match_plain_f64(lib, case):
    """The kernel's other branches against the plain version, float64 at
    1e-8: active state bounds (barrier and fraction-to-boundary on x), head
    pinning (num_control_inputs_saved=2: pinned controls stay exactly at
    the warm start), and the 2-joint arm instantiation."""
    opts = SolverOptions(tol=TOL, max_iter=30)
    if case == "x_bounds":
        prob, p = _problem(torch.float64, x_bounded=True, seed=1)
    elif case == "two_link_arm":
        prob, p = _problem(torch.float64, name="two_link_arm", seed=2)
    else:
        prob, p = _problem(torch.float64, seed=3)
    cold = solve_batch_fused(prob, p, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    if case == "head_pinning":
        opts = dataclasses.replace(opts, num_control_inputs_saved=2)
    p2 = p._replace(x0=p.x0 + 0.01)
    for kw in (dict(n_iter=3), dict(adaptive=True)):
        rk = solve_batch_fused_cpu_kernel(prob, p2, cold.X, cold.U, opts,
                                          **kw)
        rp = solve_batch_fused(prob, p2, cold.X, cold.U, opts, **kw)
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), atol=1e-8)
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), atol=1e-8)
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
        if case == "head_pinning":
            np.testing.assert_array_equal(rk.U[:, :2].numpy(),
                                          cold.U[:, :2].numpy())
        if case == "x_bounds":
            q = rk.X[:, 1:, :prob.dynamics.nq]
            assert bool((q.abs() < 0.3).all())
