"""The fused kernel's step modes beyond the serial arms under Euler: the
LTV mode, the nq-row path of the pendulum family under Euler, and the
generic nx-row path (midpoint, RK4) of every registered model.

- The models' closed forms and integrators in ``csrc/model_dynamics.cuh``
  (the code the kernel runs, built with g++) against the PyTorch models
  and ``torch.func.jacfwd``.
- The kernel bodies (g++ builds: the one-thread ``csrc/fused_sqp.cuh`` and
  the group body ``csrc/fused_sqp_group.cuh``, four lanes for LTV at (8,
  4) and the serial arms under midpoint and RK4, two lanes for the closed
  forms and the smaller LTV shapes) against the plain PyTorch version:
  float64 to roundoff, float32 at the bands of
  tests/test_torch_kernel_cpu.py; the two bodies against each other, bit
  for bit.
- The generic path against the JAX package's lanes solver
  (tests/test_fused_kernel.py:182-213's pin, float32, atol 2e-5).
"""

import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver.batched import solve_batch_lanes as jax_lanes
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch._build import cpu_library
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.integrators import make_step
from mahi_mpc_tpu_torch.solver.fused import (card_body, fused_supported,
                                             solve_batch_fused,
                                             solve_batch_fused_cpu_kernel)
from mahi_mpc_tpu_torch.solver.target import (INTEGRATORS, kernel_target,
                                              model_kernel)
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

torch.set_num_threads(1)

MODELS = ["mahi_arm", "two_link_arm", "pendulum", "cartpole",
          "double_pendulum", "acrobot"]
B, N = 8, 8
TOL = 1e-4


# ---------------------------------------------------------------------------
# The kernel's model dynamics (csrc/model_dynamics.cuh) on the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", MODELS)
def test_kernel_model_dynamics_match_torch(name, integrator):
    """float64 at 1e-9: f and the step F under the integrator, and their
    Jacobians d/d[x; u] from the kernel's dual numbers, against the
    PyTorch model and torch.func.jacfwd of f and of make_step(f)."""
    dyn = make_dynamics(name)
    nx, nu = dyn.nx, dyn.nu
    nz = nx + nu
    M, dt = 16, 0.01
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((nx, M)))
    u = torch.tensor(rng.standard_normal((nu, M)))
    out = [torch.empty(s, dtype=torch.float64)
           for s in ((nx, M), (nx, nz, M), (nx, M), (nx, nz, M))]
    model, consts, _ = model_kernel(dyn)
    rc = cpu_library().mpc_model_eval_cpu_f64(
        M, model, INTEGRATORS.index(integrator), x.data_ptr(), u.data_ptr(),
        dt, (ctypes.c_double * len(consts))(*consts),
        *[t.data_ptr() for t in out])
    assert rc == 0
    fval, fjac, sval, sjac = out
    step = make_step(dyn.f, dt, integrator)
    for fn, val, jac in ((dyn.f, fval, fjac), (step, sval, sjac)):
        one = lambda z: fn(z[:nx, None], z[nx:, None])[:, 0]
        Z = torch.cat([x, u]).T
        np.testing.assert_allclose(val.numpy(), fn(x, u).numpy(), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(jac.permute(2, 0, 1).numpy(),
                                   vmap(jacfwd(one))(Z).numpy(), rtol=0,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# The kernel body against the plain version, every new mode.
# ---------------------------------------------------------------------------

def _problem(name, integrator, ltv, dtype, seed=0, dt=0.005, **bounds):
    dyn = make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    ulim = 20.0 if name == "mahi_arm" else 60.0
    mp = ModelParameters("t", num_x=nx, num_u=nu, step_size=dt,
                         num_shooting_nodes=N, u_min=[-ulim] * nu,
                         u_max=[ulim] * nu, dynamics_name=name,
                         integrator=integrator, is_linear=ltv, **bounds)
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    p = default_params(mp, dtype=dtype, device="cpu")._replace(
        q=t([10.0] * nq + [1.0] * nq), r=t([0.1] * nu), rm=t([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=t(0.2 * rng.standard_normal((B, nx))),
                   u_prev=t(0.5 * rng.standard_normal((B, nu))),
                   x_des=t(0.2 * rng.standard_normal((B, N, nx))))
    if ltv:
        A, Bm, xd0 = vmap(dyn.linearize)(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return prob, p


def _cold_then_warm(prob, p, solve):
    opts = SolverOptions(tol=TOL, max_iter=30)
    cold = solve(prob, p, opts=opts, mu0=opts.mu_init, adaptive=True)
    return cold, solve(prob, p._replace(x0=p.x0 + 0.01), cold.X, cold.U,
                       opts, n_iter=3)


# (model, integrator, LTV): every LTV (nx, nu) of the registered models,
# the generic path of every model, the nq-row path of the pendulum family.
MODES = [
    ("mahi_arm", "euler", True), ("double_pendulum", "rk4", True),
    ("cartpole", "midpoint", True), ("acrobot", "euler", True),
    ("pendulum", "euler", True),
    ("mahi_arm", "rk4", False), ("two_link_arm", "midpoint", False),
    ("double_pendulum", "rk4", False), ("cartpole", "midpoint", False),
    ("acrobot", "rk4", False), ("pendulum", "midpoint", False),
    ("pendulum", "euler", False), ("cartpole", "euler", False),
    ("double_pendulum", "euler", False), ("acrobot", "euler", False),
]
_ids = lambda c: "-".join([c[0], c[1]] + (["ltv"] if c[2] else []))
# The cases of the group body: four lanes for LTV at (8, 4) and the arms
# under midpoint and RK4, two lanes for every closed-form mode of MODES and
# LTV at (4, 2), (4, 1) and (2, 1).
GROUP_MODES = MODES + [("mahi_arm", "midpoint", False),
                       ("two_link_arm", "rk4", False)]
_four_lanes = lambda case: case[0] == "mahi_arm" or (
    case[0] == "two_link_arm" and not case[2])
# The body the card runs for each case and its threads an instance
# (csrc/fused_sqp_group.cuh `GroupBody`, set by timing both bodies on the
# H100, PERF.md §6): two lanes where they were faster, one thread where
# they lost.
TWO_LANES = [("double_pendulum", "rk4", False), ("cartpole", "midpoint", False),
             ("acrobot", "rk4", False), ("double_pendulum", "euler", False)]
CARD_BODY = {case: ("group", 4) if _four_lanes(case) else ("group", 2)
             if case in TWO_LANES else ("thread", 1) for case in GROUP_MODES}
_with_body = lambda cases: [pytest.param(c, "thread", id=_ids(c))
                            for c in cases]
_group = lambda cases: [pytest.param(c, "group", id=_ids(c) + "-group")
                        for c in cases]


def _kernel(body):
    return functools.partial(solve_batch_fused_cpu_kernel, body=body)


@pytest.mark.parametrize("case, body",
                         _with_body(MODES) + _group(GROUP_MODES))
def test_kernel_body_matches_plain_f64(case, body):
    """float64: X and U at 1e-8, equal statuses and iterations, cold
    adaptive and warm fixed-3; every instance converges cold."""
    prob, p = _problem(*case, torch.float64)
    assert fused_supported(prob)
    assert kernel_target(prob).mode == ("ltv" if case[2] else
                           "fast" if case[1] == "euler" else "generic")
    assert card_body(prob) == CARD_BODY[case]
    kernel = _cold_then_warm(prob, p, _kernel(body))
    for rk, rp in zip(kernel, _cold_then_warm(prob, p, solve_batch_fused)):
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0,
                                   atol=1e-8)
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
        np.testing.assert_array_equal(rk.iters.numpy(), rp.iters.numpy())
    assert bool((kernel[0].status == 0).all())


@pytest.mark.parametrize("case, body",
                         _with_body([MODES[1], MODES[7], MODES[11]])
                         + _group(GROUP_MODES[:-2]))
def test_kernel_body_matches_plain_f32(case, body):
    """float32 at the bands of the JAX parity tests: adaptive cold equal
    statuses, iterations within +-1, X and U at 1e-3; fixed-3 warm X and U
    at 2e-5, kkt and feas at 1e-5, equal statuses."""
    prob, p = _problem(*case, torch.float32)
    (ck, wk) = _cold_then_warm(prob, p, _kernel(body))
    (cp, wp) = _cold_then_warm(prob, p, solve_batch_fused)
    np.testing.assert_array_equal(ck.status.numpy(), cp.status.numpy())
    assert np.abs(ck.iters.numpy() - cp.iters.numpy()).max() <= 1
    np.testing.assert_allclose(ck.X.numpy(), cp.X.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ck.U.numpy(), cp.U.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(wk.X.numpy(), wp.X.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(wk.U.numpy(), wp.U.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(wk.status.numpy(), wp.status.numpy())
    np.testing.assert_allclose(wk.kkt.numpy(), wp.kkt.numpy(), atol=1e-5)
    np.testing.assert_allclose(wk.feas.numpy(), wp.feas.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", GROUP_MODES, ids=_ids)
def test_group_body_matches_thread_body_bitwise(case, dtype):
    """The group body (g++ build, at its policy's width) against the
    one-thread body, bit for bit: X, U, statuses, iterations and stats of
    the adaptive cold and the fixed-3 warm solve.  Every sum of the group
    body keeps the one-thread body's order (lane 0 the merit's sums, each
    lane its rows' products with the dense A, B; the skipped zeros of the
    nq-row policy's A add nothing), and its linearization is the same dual
    passes: one tangent column a pass, as ``acc_rows`` and
    ``increment_rows`` form them.  Where it cannot hold: the serial arms
    under Euler, whose group body linearizes by the folded Jacobian, which
    rounds differently (tests/test_torch_kernel_cpu.py holds that body to
    its own earlier outputs)."""
    prob, p = _problem(*case, dtype)
    group = _cold_then_warm(prob, p, _kernel("group"))
    thread = _cold_then_warm(prob, p, _kernel("thread"))
    for rg, rt in zip(group, thread):
        for field in ("X", "U", "status", "iters", "kkt", "feas", "obj"):
            np.testing.assert_array_equal(getattr(rg, field).numpy(),
                                          getattr(rt, field).numpy(),
                                          err_msg=field)


# The policies whose group tile grew: at nx + nu = 5 and 3 the step's blocks
# in the tile are too few for the rollout's dx / du buffers and the results
# of all 8 rungs (csrc/fused_sqp_group.cuh `GroupTile`).
SMALL_TILES = [("cartpole", "euler", True), ("pendulum", "euler", True),
               ("cartpole", "euler", False), ("pendulum", "euler", False)]


@pytest.mark.parametrize("case", SMALL_TILES, ids=_ids)
def test_group_tile_holds_the_full_fan(case):
    """The two-lane group body at (4, 1) and (2, 1) with all 8 line-search
    rungs in fixed mode (each lane evaluates 4 and writes their pass flags,
    steps and reference costs to the tile) and in adaptive mode, against
    the plain version in float64 at 1e-8 with equal statuses; the g++
    build also fails (-2) if a write lands past the tile.  With the tile
    of the step's blocks only, the 8 rungs' results at (2, 1) run over the
    lanes' partial sums into A in LTV (wrong steps) and past the tile of
    the nq-row policy (the guard): both cases fail.  At (4, 1) they would
    reach only the lanes' partial sums, which are dead by then, so the
    outputs cannot show it; `GroupTile`'s static_assert guards that."""
    prob, p = _problem(*case, torch.float64)
    opts = SolverOptions(tol=TOL, max_iter=30)
    cold = solve_batch_fused(prob, p, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.05)
    fan = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
    for kw in (dict(n_iter=3, ls_fan=fan), dict(adaptive=True)):
        rk = solve_batch_fused_cpu_kernel(prob, p2, cold.X, cold.U, opts,
                                          body="group", **kw)
        rp = solve_batch_fused(prob, p2, cold.X, cold.U, opts, **kw)
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0,
                                   atol=1e-8)
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())


def test_ltv_state_bounds_and_pinning_f64():
    """LTV through the kernel's other branches, float64 at 1e-8: velocity
    bounds (barrier and fraction-to-boundary on x) and head pinning (the
    pinned controls stay at the warm start)."""
    prob, p = _problem("double_pendulum", "euler", True, torch.float64,
                       seed=4, dt=0.01, x_min=[-np.inf] * 2 + [-0.5] * 2,
                       x_max=[np.inf] * 2 + [0.5] * 2)
    p = p._replace(x0=p.x0.clamp(-0.3, 0.3), x_des=3.0 * p.x_des)
    opts = SolverOptions(tol=TOL, max_iter=40)
    cold = solve_batch_fused(prob, p, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    pin = dataclasses.replace(opts, num_control_inputs_saved=2)
    p2 = p._replace(x0=p.x0 + 0.01)
    for o in (opts, pin):
        for kw in (dict(n_iter=3), dict(adaptive=True)):
            rk = solve_batch_fused_cpu_kernel(prob, p2, cold.X, cold.U, o,
                                              **kw)
            rp = solve_batch_fused(prob, p2, cold.X, cold.U, o, **kw)
            np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), atol=1e-8)
            np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), atol=1e-8)
            np.testing.assert_array_equal(rk.status.numpy(),
                                          rp.status.numpy())
            assert float(rk.X[:, 1:, 2:].abs().max()) < 0.5
            if o is pin:
                np.testing.assert_array_equal(rk.U[:, :2].numpy(),
                                              cold.U[:, :2].numpy())


# ---------------------------------------------------------------------------
# The generic path against the JAX lanes solver.
# ---------------------------------------------------------------------------

def _jax_lanes_pair(name, dt, ulim, seed):
    """tests/test_fused_kernel.py:182-213's setup for ``name`` under RK4:
    the JAX lanes cold solve, then its warm solve at x0 + 0.01; and the
    same problem and params in the port."""
    jdyn, dyn = jax_make_dynamics(name), make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    kw = dict(num_x=nx, num_u=nu, step_size=dt, num_shooting_nodes=8,
              u_min=[-ulim] * nu, u_max=[ulim] * nu, dynamics_name=name,
              integrator="rk4")
    jmp = JaxModelParameters("t_rk4", **kw)
    jprob = jax_make_problem(jmp, jdyn)
    prob = make_problem(ModelParameters("t_rk4", **kw), dyn)
    jopts = JaxSolverOptions(tol=1e-4, max_iter=40, dtype="float32")
    f32 = jnp.float32
    rng = np.random.default_rng(seed)
    p = jax_default_params(jmp, dtype=f32)
    p = p._replace(q=jnp.asarray([10.0] * nq + [1.0] * nq, f32),
                   r=jnp.full((nu,), 0.1, f32), rm=jnp.full((nu,), 0.01, f32))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (8,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((8, nx)), f32),
        x_des=jnp.asarray(0.1 * rng.standard_normal((8, 8, nx)), f32))
    # One jitted program for both solves: the eager JAX lanes solve through
    # the RK4 arm dispatches op by op and takes minutes.
    solve = jax.jit(lambda pp, X, U, mu: jax_lanes(jprob, pp, X, U, jopts,
                                                   mu0=mu))
    zeros = lambda *s: jnp.zeros(s, f32)
    r0 = solve(pb, zeros(8, 9, nx), zeros(8, 8, nu),
               jnp.asarray(jopts.mu_init, f32))
    pb2 = pb._replace(x0=pb.x0 + 0.01)
    rw = solve(pb2, r0.X, r0.U, jnp.asarray(jopts.warm_mu_factor * jopts.tol,
                                            f32))
    tp2 = params_from_numpy(jax.tree.map(np.asarray, pb2), device="cpu")
    return prob, tp2, jax.tree.map(np.asarray, r0), jax.tree.map(np.asarray,
                                                                   rw)


def _check_generic_warm(prob, tp2, X0, U0, rw_U):
    """Fixed-3 warm solves through the generic nx-row path (plain version
    and both kernel bodies) from a lanes cold plan: U at atol 2e-5 of the
    lanes warm solve ``rw_U``, every instance converged."""
    assert kernel_target(prob).mode == "generic"
    opts = SolverOptions(tol=1e-4, max_iter=40)
    for solve in [solve_batch_fused] + [_kernel(b) for b in ("thread",
                                                             "group")]:
        rf = solve(prob, tp2, X0, U0, opts,
                   mu0=opts.warm_mu_factor * opts.tol, n_iter=3)
        np.testing.assert_allclose(rf.U.numpy(), rw_U, rtol=0, atol=2e-5)
        assert bool((rf.status == 0).all())


# two_link_arm runs the kernel's arm instantiation of the generic path
# (the same code as mahi_arm's, at nq = 2); mahi_arm itself is held below
# against the port's lanes solver: the JAX lanes solve through the 4-DOF
# RK4 arm takes ~5 min to compile on the CPU.
@pytest.mark.parametrize("name, ulim", [("double_pendulum", 60.0),
                                        ("two_link_arm", 25.0)])
def test_generic_path_matches_jax_lanes(name, ulim):
    """tests/test_fused_kernel.py:182-213 for ``name`` under RK4 (dt 5 ms,
    N=8, B=8, float32): the port's fixed-3 warm solve from the JAX lanes
    cold plan against the JAX lanes warm solve."""
    prob, tp2, r0, rw = _jax_lanes_pair(name, 0.005, ulim, seed=1)
    _check_generic_warm(prob, tp2, torch.tensor(r0.X), torch.tensor(r0.U),
                        rw.U)


def test_generic_path_matches_lanes_mahi_arm_rk4():
    """The same pin for ``mahi_arm`` under RK4 against the port's lanes
    solver (itself held against the JAX lanes solver in
    tests/test_torch_batched_lanes.py): cold lanes plan, then the lanes
    warm solve at x0 + 0.01 against fused fixed-3."""
    from mahi_mpc_tpu_torch.solver.batched import solve_batch_lanes
    prob, p = _problem("mahi_arm", "rk4", False, torch.float32, seed=1)
    p = p._replace(u_prev=torch.zeros_like(p.u_prev), x_des=0.5 * p.x_des)
    opts = SolverOptions(tol=1e-4, max_iter=40)
    r0 = solve_batch_lanes(prob, p, opts=opts, mu0=opts.mu_init)
    assert bool((r0.status == 0).all())
    p2 = p._replace(x0=p.x0 + 0.01)
    rw = solve_batch_lanes(prob, p2, r0.X, r0.U, opts,
                           mu0=opts.warm_mu_factor * opts.tol)
    _check_generic_warm(prob, p2, r0.X, r0.U, rw.U.numpy())
