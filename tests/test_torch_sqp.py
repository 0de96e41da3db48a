"""The port's single-instance SQP (``solve`` / ``solve_batch``), its
fixed-iteration variant (``solve_fixed``) and the shooting functions they
read, against the JAX package's on the same numpy inputs.

Float64: equal statuses and iterations, X and U within 1e-8 (the same
algorithm in the same order of operations; only roundoff differs).
Float32: iterations within one, X and U within 1e-3.  The cases are the
port's counterparts of ``test_state_bounds.py`` (x bounds that bind),
``test_pinning.py`` (head pinning) and ``test_solver_oracle.py``'s
warm-start test, at N = 8-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver import stage_qp as jsq
from mahi_mpc_tpu.solver.fixed import solve_fixed as jax_solve_fixed
from mahi_mpc_tpu.solver.sqp import solve as jax_solve
from mahi_mpc_tpu.solver.sqp import solve_batch as jax_solve_batch
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver import (CONVERGED, solve, solve_batch,
                                       solve_fixed)
from mahi_mpc_tpu_torch.solver.stage_qp import merit
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem, map_params

torch.set_num_threads(1)

INF = np.inf
# name -> (model, N, dt, bounds, weights (q, r, rm), solve options)
CASES = {
    "unbounded": ("double_pendulum", 10, 0.02, {},
                  ([10.0, 1.0, 5.0, 5.0], [0.5, 0.5], [0.0, 0.0]),
                  dict(tol=1e-8, max_iter=60)),
    "u_bounded": ("two_link_arm", 8, 0.01,
                  dict(u_min=[-4.0, -4.0], u_max=[4.0, 4.0]),
                  ([20.0, 20.0, 1.0, 1.0], [0.05, 0.05], [0.001, 0.001]),
                  dict(tol=1e-7, max_iter=60)),
    # Velocity limits that bind while tracking (test_state_bounds.py:30-58).
    "x_bounded": ("double_pendulum", 10, 0.02,
                  dict(x_min=[-INF, -INF, -1.0, -1.0],
                       x_max=[INF, INF, 1.0, 1.0]),
                  ([10.0, 1.0, 5.0, 5.0], [0.5, 0.5], [0.0, 0.0]),
                  dict(tol=1e-7, max_iter=150, mu_min=1e-10)),
    # The first three controls frozen at their warm start (test_pinning.py).
    "pinned": ("double_pendulum", 12, 0.02,
               dict(u_min=[-8.0, -8.0], u_max=[8.0, 8.0]),
               ([10.0, 1.0, 5.0, 5.0], [5.0, 5.0], [0.1, 0.1]),
               dict(tol=1e-8, max_iter=60, num_control_inputs_saved=3)),
    "pendulum": ("pendulum", 12, 0.05, dict(u_min=[-3.0], u_max=[3.0]),
                 ([20.0, 0.5], [0.05], [0.0]), dict(tol=1e-7, max_iter=60)),
}


def _case(name, dtype="float64", seed=0, batch=None):
    """The case in both packages from one numpy seed: (jax problem, jax
    params, port problem, port params, X0, U0, jax options, port options);
    params carry a leading batch when ``batch`` is given."""
    model, N, dt, bounds, (q, r, rm), opts = CASES[name]
    jdyn = jax_make_dynamics(model)
    kw = dict(num_x=jdyn.nx, num_u=jdyn.nu, step_size=dt,
              num_shooting_nodes=N, dynamics_name=model, **bounds)
    jmp = JaxModelParameters("t", **kw)
    jprob = jax_make_problem(jmp, jdyn)
    prob = make_problem(ModelParameters("t", **kw), make_dynamics(model))
    nx, nu = jdyn.nx, jdyn.nu
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    amp = 1.0 if name == "x_bounded" else 0.3
    tt = (1 + np.arange(N)) * dt
    x_des = np.zeros(lead + (N, nx))
    x_des[..., : nx // 2] = amp * np.sin(3.0 * tt)[:, None]
    x_des[..., nx // 2:] = amp * 3.0 * np.cos(3.0 * tt)[:, None]
    x0 = 0.2 * rng.standard_normal(lead + (nx,))
    x0[..., nx // 2:] = 0.0
    jd = jnp.dtype(dtype)
    p = jax_default_params(jmp, dtype=jnp.float64)
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, lead + a.shape), p)
    p = p._replace(q=jnp.broadcast_to(jnp.asarray(q), lead + (nx,)),
                   r=jnp.broadcast_to(jnp.asarray(r), lead + (nu,)),
                   rm=jnp.broadcast_to(jnp.asarray(rm), lead + (nu,)),
                   x_des=jnp.asarray(x_des), x0=jnp.asarray(x0))
    p = jax.tree.map(lambda a: a.astype(jd), p)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu",
                           dtype=getattr(torch, dtype))
    X0 = np.zeros(lead + (N + 1, nx))
    U0 = (np.full(lead + (N, nu), 0.7) if name == "pinned"
          else np.zeros(lead + (N, nu)))
    return (jprob, p, prob, tp, X0, U0,
            JaxSolverOptions(dtype=dtype, **opts),
            SolverOptions(dtype=dtype, **opts))


def _jax_solve(jprob, p, X0, U0, jopts, mu0=None):
    fn = jax.jit(lambda p, X0, U0: jax_solve(jprob, p, X0, U0, jopts,
                                             mu0=mu0))
    return jax.tree.map(np.asarray, fn(p, jnp.asarray(X0, p.x0.dtype),
                                       jnp.asarray(U0, p.x0.dtype)))


def _t(a, like):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype)


def _assert_same(rt, rj, atol, iter_slack=0):
    if iter_slack == 0:
        np.testing.assert_array_equal(rt.status.numpy(), rj.status)
        np.testing.assert_array_equal(rt.iters.numpy(), rj.iters)
    else:
        assert np.all(np.abs(rt.iters.numpy() - rj.iters) <= iter_slack), \
            (rt.iters, rj.iters)
        np.testing.assert_array_equal(rt.status.numpy() == CONVERGED,
                                      rj.status == CONVERGED)
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=atol)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=atol)


# ---- the shooting functions and the merit ---------------------------------

@pytest.mark.parametrize("name", ["u_bounded", "x_bounded", "pendulum"])
def test_shooting_functions_match_jax(name):
    """linearize_stages, cost_separable, the flat adapters (pack_v /
    unpack_v / bounds_v / pack_ref_params / unpack_ref_params, nonlinear and
    LTV) and the merit against the JAX package's, float64 at 1e-10."""
    jprob, p, prob, tp, _, _, _, _ = _case(name)
    nx, nu, N = prob.nx, prob.nu, prob.N
    rng = np.random.default_rng(1)
    X = 0.5 * rng.standard_normal((N + 1, nx))
    U = 0.5 * rng.standard_normal((N, nu))
    jX, jU, tX, tU = jnp.asarray(X), jnp.asarray(U), torch.tensor(X), \
        torch.tensor(U)
    tol = dict(rtol=0, atol=1e-10)
    for got, ref in zip(prob.linearize_stages(tX, tU, tp),
                        jprob.linearize_stages(jX, jU, p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(float(prob.cost_separable(tX, tU, tp)),
                               float(jprob.cost_separable(jX, jU, p)), **tol)
    v = prob.pack_v(tX, tU)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jprob.pack_v(jX, jU)))
    Xb, Ub = prob.unpack_v(v)
    np.testing.assert_array_equal(Xb.numpy(), X)
    np.testing.assert_array_equal(Ub.numpy(), U)
    for got, ref in zip(prob.bounds_v(tp), jprob.bounds_v(p)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    mu, nu_pen = 0.03, 7.5
    np.testing.assert_allclose(
        merit(prob, tX[None], tU[None], map_params(lambda a: a[None], tp),
              torch.tensor([mu], dtype=torch.float64),
              torch.tensor([nu_pen], dtype=torch.float64)).numpy(),
        [float(jsq.merit(jprob, jX, jU, p, mu, nu_pen))], **tol)
    for linear in (False, True):
        import dataclasses
        jpr = dataclasses.replace(jprob, is_linear=linear)
        pr = dataclasses.replace(prob, is_linear=linear)
        lin = (rng.standard_normal((nx, nx)), rng.standard_normal((nx, nu)),
               rng.standard_normal(nx), rng.standard_normal(nx))
        jp = p._replace(lin=p.lin._replace(
            **dict(zip(("A", "B", "x_dot0", "x0"), map(jnp.asarray, lin)))))
        tpl = tp._replace(lin=tp.lin._replace(
            **dict(zip(("A", "B", "x_dot0", "x0"), map(torch.tensor, lin)))))
        flat = pr.pack_ref_params(tpl)
        np.testing.assert_array_equal(flat.numpy(),
                                      np.asarray(jpr.pack_ref_params(jp)))
        base = map_params(torch.zeros_like, tpl)
        jbase = jax.tree.map(jnp.zeros_like, jp)
        got = pr.unpack_ref_params(flat, base)
        ref = jpr.unpack_ref_params(jnp.asarray(flat.numpy()), jbase)
        for g, r in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        if linear:
            # The LTV step through linearize_stages: affine, exact.
            for g, r in zip(pr.linearize_stages(tX, tU, tpl),
                            jpr.linearize_stages(jX, jU, jp)):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


def test_linearize_stages_keeps_float32():
    """A model written on 0-d components (no lanes support) hands
    torch.func float64 tangents; the stage Jacobians keep the iterate's
    float32, and agree with the float64 ones to float32 roundoff."""
    from mahi_mpc_tpu_torch.models.base import Dynamics
    mp = ModelParameters("t", num_x=2, num_u=1, step_size=0.05,
                         num_shooting_nodes=8)
    per_instance = Dynamics("pend_nl", nx=2, nu=1,
                            f=make_dynamics("pendulum").f)
    prob = make_problem(mp, per_instance)
    _, _, _, tp, _, _, _, _ = _case("pendulum", dtype="float32")
    rng = np.random.default_rng(2)
    X = torch.tensor(rng.standard_normal((9, 2)), dtype=torch.float32)
    U = torch.tensor(rng.standard_normal((8, 1)), dtype=torch.float32)
    tp = tp._replace(x_des=tp.x_des[:8])
    A, B, c = prob.linearize_stages(X, U, tp)
    assert A.dtype == B.dtype == c.dtype == torch.float32
    A64, B64, _ = prob.linearize_stages(X.double(), U.double(),
                                        map_params(torch.Tensor.double, tp))
    np.testing.assert_allclose(A.numpy(), A64.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), B64.numpy(), rtol=0, atol=1e-6)


# ---- solve ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax_f64(name):
    """Cold solve (warm-started at 0.7 in the pinned case): equal status
    and iterations, X and U within 1e-8; the pinned controls stay at their
    warm start exactly."""
    jprob, p, prob, tp, X0, U0, jopts, opts = _case(name)
    rj = _jax_solve(jprob, p, X0, U0, jopts)
    rt = solve(prob, tp, _t(X0, tp.x0), _t(U0, tp.x0), opts)
    assert int(rj.status) == CONVERGED
    _assert_same(rt, rj, atol=1e-8)
    np.testing.assert_allclose(float(rt.obj), float(rj.obj), rtol=1e-10)
    if name == "pinned":
        np.testing.assert_array_equal(rt.U[:3].numpy(), 0.7)
    if name == "x_bounded":
        # The bounds bind, and hold.
        v = np.abs(rt.X[1:, 2:].numpy())
        assert v.max() <= 1.0 and v.max() > 1.0 - 1e-3


def test_warm_start_matches_jax_f64():
    """test_solver_oracle.py:165-178 through both packages: a warm re-solve
    from the cold optimum with the barrier restarted at the warm value
    (the runtime's schedule) and the state moved; equal iterations, fewer
    than cold, X and U within 1e-8."""
    jprob, p, prob, tp, X0, U0, jopts, opts = _case("u_bounded")
    cold = _jax_solve(jprob, p, X0, U0, jopts)
    p2 = p._replace(x0=p.x0 + 0.01)
    tp2 = tp._replace(x0=tp.x0 + 0.01)
    mu_w = opts.warm_mu_factor * opts.tol
    rj = _jax_solve(jprob, p2, cold.X, cold.U, jopts, mu0=mu_w)
    rt = solve(prob, tp2, _t(cold.X, tp.x0), _t(cold.U, tp.x0), opts,
               mu0=mu_w)
    _assert_same(rt, rj, atol=1e-8)
    assert int(rt.iters) < int(cold.iters)


@pytest.mark.parametrize("name", ["unbounded", "x_bounded", "pinned",
                                  "u_bounded"])
def test_solve_matches_jax_f32(name):
    """Float32 at tol 1e-4: the same converged verdict, X and U within 1e-3
    of each other, and iterations within one.  The two-link arm (u_bounded)
    reaches the float32 floor before tol, where the Armijo test turns on
    roundoff: both packages then take a few more iterations, not the same
    number (14 and 16 here; up to 5 apart over other seeds), so that case
    is held instead to the float64 solve at the same tol, within 1e-3 in
    both."""
    jprob, p, prob, tp, X0, U0, jopts, opts = _case(name, "float32")
    jopts = JaxSolverOptions(**{**jopts.__dict__, "tol": 1e-4})
    opts = SolverOptions(**{**opts.__dict__, "tol": 1e-4})
    rj = _jax_solve(jprob, p, X0, U0, jopts)
    rt = solve(prob, tp, _t(X0, tp.x0), _t(U0, tp.x0), opts)
    assert rt.X.dtype == torch.float32
    if name != "u_bounded":
        _assert_same(rt, rj, atol=1e-3, iter_slack=1)
        return
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=1e-3)
    _, _, _, tp64, _, _, _, _ = _case(name)
    r64 = solve(prob, tp64, opts=SolverOptions(
        **{**opts.__dict__, "dtype": "float64"}))
    for r in (rt.U.numpy(), rj.U):
        np.testing.assert_allclose(r, r64.U.numpy(), rtol=0, atol=1e-3)


def test_solve_batch_matches_jax_vmap_f64():
    """solve_batch over B=4 instances whose iteration counts differ: an
    instance that converges first is frozen while the others iterate,
    exactly as under jax.vmap(solve)."""
    jprob, p, prob, tp, X0, U0, jopts, opts = _case("u_bounded", batch=4)
    rng = np.random.default_rng(7)
    x0 = 0.4 * rng.standard_normal((4, prob.nx))
    p = p._replace(x0=jnp.asarray(x0))
    tp = tp._replace(x0=torch.tensor(x0))
    rj = jax.tree.map(np.asarray, jax.jit(
        lambda p: jax_solve_batch(jprob, p, opts=jopts))(p))
    rt = solve_batch(prob, tp, opts=opts)
    assert len(set(rj.iters.tolist())) > 1, rj.iters
    _assert_same(rt, rj, atol=1e-8)
    np.testing.assert_allclose(rt.obj.numpy(), rj.obj, rtol=1e-10)


def test_riccati_kernel_backend_matches_scan():
    """kkt_backend="pallas" sends each Riccati step to the kernel's wrapper
    (its plain version on CPU tensors); the solve matches the scan's:
    equal iterations, X and U within 1e-8."""
    _, _, prob, tp, X0, U0, _, opts = _case("pinned")
    scan = solve(prob, tp, _t(X0, tp.x0), _t(U0, tp.x0), opts)
    kern = solve(prob, tp, _t(X0, tp.x0), _t(U0, tp.x0),
                 SolverOptions(**{**opts.__dict__, "kkt_backend": "pallas"}))
    assert int(kern.iters) == int(scan.iters)
    np.testing.assert_allclose(kern.U.numpy(), scan.U.numpy(), rtol=0,
                               atol=1e-8)


# ---- solve_fixed ----------------------------------------------------------

@pytest.mark.parametrize("n_iter", [1, 3])
def test_solve_fixed_matches_jax_f64(n_iter):
    """A warm fixed-iteration re-solve from the cold optimum, state moved:
    X, U, kkt and feas within 1e-8, the same status and iteration count."""
    jprob, p, prob, tp, X0, U0, jopts, opts = _case("x_bounded")
    cold = _jax_solve(jprob, p, X0, U0, jopts)
    p2 = p._replace(x0=p.x0 + 0.02)
    tp2 = tp._replace(x0=tp.x0 + 0.02)
    rj = jax.tree.map(np.asarray, jax.jit(lambda p, X, U: jax_solve_fixed(
        jprob, p, X, U, jopts, n_iter=n_iter))(
            p2, jnp.asarray(cold.X), jnp.asarray(cold.U)))
    rt = solve_fixed(prob, tp2, _t(cold.X, tp.x0), _t(cold.U, tp.x0), opts,
                     n_iter=n_iter)
    _assert_same(rt, rj, atol=1e-8)
    np.testing.assert_allclose([float(rt.kkt), float(rt.feas)],
                               [float(rj.kkt), float(rj.feas)], rtol=0,
                               atol=1e-8)
