"""The fused kernel's block body (``csrc/fused_sqp_block.cuh``: one
instance a thread block, the instance in shared memory, the linearization
and the line search across the block) on the CPU, through its g++ build
(``mpc_fused_solve_block_cpu_f32`` / ``_f64``), for the three step
policies the card runs on it at small batch: ``FastNq<ArmModel<4>>``
(``mahi_arm`` under Euler, the single robot's warm ``calc_u``),
``FastNq<DoublePendulum>`` (the reference's default example),
``Ltv<8, 4>`` (``mahi_arm_ltv``: the arm frozen at each instance's state,
the LTV single robot's warm ``calc_u``), and a user's own model under each
generated policy: ``FastNq<gen::Model>`` of a 4-DOF chain of pendulums
coupled by springs (``user_chain4``, nx = 8, nu = 4: a group lane owns two
controls) and ``Generic<gen::Model>`` of a Van der Pol oscillator under
RK4 (``user_vdp``).

- Against the group body's g++ build: bitwise, float32 and float64, fixed-3
  and adaptive, B = 1 and 3, N = 25 and 60 (the block body sums in the
  group body's order).
- Against the plain version in float64 (1e-8, equal statuses and
  iterations), and in the branches: active control and state bounds, head
  pinning, one NaN instance at B=3.
- Against the JAX package's Pallas kernel in interpret mode, float32 warm
  re-solves at B=3, N=25 and B=1, N=60: X, U within 2e-5 (the ROADMAP
  band), equal statuses (the registered models; the user models' are in
  tests/test_torch_fused_generated.py).
- The launcher's rule (``card_body``): the block body up to the measured
  threshold, the body at full occupancy (group or one thread) above it and
  where the instance does not fit in a block's shared memory.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver.fused import solve_batch_fused as jax_solve_fused
from mahi_mpc_tpu.transcribe.shooting import LinPoint as JaxLinPoint
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.solver.fused import (card_body, solve_batch_fused,
                                             solve_batch_fused_cpu_kernel,
                                             solve_batch_fused_plain)
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

TOL = 1e-4
# "mahi_arm_ltv": the LTV step of mahi_arm, frozen at each instance's
# (x0, u_prev); "user_*": a user's own model (below), served by a
# generated instantiation.
REGISTERED = ("mahi_arm", "double_pendulum", "mahi_arm_ltv")
MODELS = REGISTERED + ("user_chain4", "user_vdp")
SHAPES = ((1, 25), (3, 25), (1, 60), (3, 60))        # (B, N)
MODES = {"fixed3": dict(n_iter=3), "adaptive": dict(adaptive=True)}
FIELDS = ("X", "U", "status", "iters", "kkt", "feas", "obj")
# The launcher's threshold (csrc/fused_sqp_block.cuh `BlockBody`): the
# largest batch the block body serves, and the body at full occupancy.
BLOCK_MAX_BATCH = {"mahi_arm": 660, "double_pendulum": 396,
                   "mahi_arm_ltv": 264, "user_chain4": 396, "user_vdp": 792}
FULL_BODY = {"mahi_arm": ("group", 4), "double_pendulum": ("group", 2),
             "mahi_arm_ltv": ("group", 4), "user_chain4": ("thread", 1),
             "user_vdp": ("group", 2)}


def _chain4(x, u):
    """Four pendulums coupled by springs, each driven by its own torque."""
    q, qd = x[:4], x[4:]
    left, right = torch.cat([q[:1], q[:-1]]), torch.cat([q[1:], q[-1:]])
    return torch.cat([qd, u - torch.sin(q) - 0.1 * qd
                      + 0.5 * ((left - 2.0 * q) + right)])


def _vdp(x, u):
    return torch.stack([x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]])


# A user's own models (no hand-written instantiation) and their integrator
# and control bound.
USER = {"user_chain4": (Dynamics("user_chain4", 8, 4, _chain4,
                                 supports_lanes=True, nq=4), "euler", 20.0),
        "user_vdp": (Dynamics("user_vdp", 2, 1, _vdp, supports_lanes=True),
                     "rk4", 5.0)}


# Bounds that the branch tests' solutions reach: about half the largest
# |u| of the unbounded solutions (0.97 on the arm, 2.39 on the double
# pendulum, 0.85 on the chain, 0.75 on Van der Pol), and |q| <= 0.1
# against a reference of 0.1 N(0, 1).
U_TIGHT = {"mahi_arm": 0.5, "double_pendulum": 1.2, "mahi_arm_ltv": 0.5,
           "user_chain4": 0.4, "user_vdp": 0.35}
Q_BOUND = 0.1
# The state-bound case's start: q at this fraction of the bound, moving
# toward it at this speed (rad/s); faster, the double pendulum's cold plan
# crosses the bound by ~1e-9 before the barrier holds it.
X_START = {"mahi_arm": (0.8, 1.0), "double_pendulum": (0.6, 0.8),
           "mahi_arm_ltv": (0.8, 1.0), "user_chain4": (0.6, 0.6),
           "user_vdp": (0.6, 0.6)}


def _model(name):
    """(registered dynamics, is_linear) of a case of MODELS."""
    return name.removesuffix("_ltv"), name.endswith("_ltv")


def _dynamics(name):
    """The port's Dynamics of a case of MODELS."""
    return USER[name][0] if name in USER else make_dynamics(_model(name)[0])


def _kw(name, N, x_bounded=False, u_tight=False):
    """The model's bench-shaped parameters: |u| <= 20 on the arm, the
    default example's unbounded controls on the double pendulum, a user
    model's bound of ``USER``; with ``u_tight`` |u| <= ``U_TIGHT``, with
    ``x_bounded`` |q| <= ``Q_BOUND`` (both active)."""
    dyn, ltv = _model(name)
    d = _dynamics(name)
    nx, nu = d.nx, d.nu
    kw = dict(num_x=nx, num_u=nu, step_size=0.002, num_shooting_nodes=N,
              is_linear=ltv)
    if name in USER:
        kw.update(integrator=USER[name][1])
    else:
        kw.update(dynamics_name=dyn)
    if dyn == "mahi_arm" or name in USER or u_tight:
        ulim = U_TIGHT[name] if u_tight else (
            USER[name][2] if name in USER else 20.0)
        kw.update(u_min=[-ulim] * nu, u_max=[ulim] * nu)
    if x_bounded:
        nq = nx // 2
        kw.update(x_min=[-Q_BOUND] * nq + [-30.0] * nq,
                  x_max=[Q_BOUND] * nq + [30.0] * nq)
    return kw


def _problems(name, B, N, dtype=np.float32, seed=0, **bounds):
    """The same problem in both packages from one numpy seed: (jax problem,
    jax params, port problem, port params in ``dtype``); an LTV case frozen
    at each instance's (x0, u_prev), the same arrays in both.  A user
    model has no JAX problem here (None)."""
    kw = _kw(name, N, **bounds)
    nx, nu = kw["num_x"], kw["num_u"]
    dyn, ltv = _model(name)
    jmp = JaxModelParameters("t", **kw)
    jprob = None if name in USER else jax_make_problem(
        jmp, jax_make_dynamics(dyn))
    prob = make_problem(ModelParameters("t", **kw), _dynamics(name))
    rng = np.random.default_rng(seed)
    nq = nx // 2
    x0 = 0.2 * rng.standard_normal((B, nx))
    ref_scale = 0.2
    if bounds.get("x_bounded"):
        # inside the state bounds and moving toward them
        side = rng.choice([-1.0, 1.0], size=(B, nq))
        frac, speed = X_START[name]
        x0 = np.concatenate([frac * Q_BOUND * side, speed * side], axis=1)
        ref_scale = Q_BOUND
    f32 = jnp.float32
    p = jax_default_params(jmp, dtype=f32)._replace(
        q=jnp.asarray([10.0] * nq + [1.0] * nq, f32),
        r=jnp.full((nu,), 0.1, f32), rm=jnp.full((nu,), 0.01, f32))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(x0, f32),
        x_des=jnp.asarray(ref_scale * rng.standard_normal((B, N, nx)), f32))
    if ltv:
        # one linearization for both packages: the port's (the JAX model's
        # eager jacfwd of the arm takes tens of seconds a call)
        lin = vmap(make_dynamics(dyn).linearize)(
            *[torch.as_tensor(np.asarray(a)) for a in (pb.x0, pb.u_prev)])
        pb = pb._replace(lin=JaxLinPoint(
            *[jnp.asarray(a.numpy()) for a in lin], pb.x0, pb.u_prev))
    tp = params_from_numpy(jax.tree.map(np.asarray, pb), device="cpu")
    if dtype == np.float64:
        tp = type(tp)(*[type(f)(*[a.double() for a in f])
                        if isinstance(f, tuple) else f.double() for f in tp])
    return jprob, pb, prob, tp


def _warm_start(prob, tp):
    """The plain version's adaptive cold plan and the warm re-solve's
    params (x0 + 0.01)."""
    opts = SolverOptions(tol=TOL, max_iter=30)
    cold = solve_batch_fused(prob, tp, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    return cold.X, cold.U, tp._replace(x0=tp.x0 + 0.01)


def _solve(body, prob, tp, X0, U0, mode, opts=None):
    opts = opts or SolverOptions(tol=TOL, max_iter=30)
    mu = opts.warm_mu_factor * opts.tol
    if body == "plain":
        return solve_batch_fused_plain(prob, tp, X0, U0, opts, mu0=mu,
                                       **MODES[mode])
    return solve_batch_fused_cpu_kernel(prob, tp, X0, U0, opts, mu0=mu,
                                        body=body, **MODES[mode])


@functools.lru_cache(maxsize=None)
def _body_runs(name, dt):
    """{(B, N, mode): {body: result}} for the block and group bodies, the
    one-thread body where the card runs it at full occupancy, and the
    plain version in float64, from one warm start a shape."""
    out = {}
    for B, N in SHAPES:
        _, _, prob, tp = _problems(name, B, N, getattr(np, dt))
        X0, U0, tp2 = _warm_start(prob, tp)
        for mode in MODES:
            bodies = ("block", "group") + (
                ("thread",) if FULL_BODY[name][0] == "thread" else ()) + (
                ("plain",) if dt == "float64" else ())
            out[B, N, mode] = {b: _solve(b, prob, tp2, X0, U0, mode)
                               for b in bodies}
    return out


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_block_body_matches_group_body_bitwise(name, dt):
    """Every output of the block body is the group body's to the last bit,
    at every (B, N) and mode, float32 and float64: the same arithmetic in
    the same order, the sums over stages and rungs included; and the
    one-thread body's where that is the body the block replaces (the
    4-DOF chain: the same dual passes, the same sums)."""
    for key, r in _body_runs(name, dt).items():
        for body in ("group", "thread"):
            for field in FIELDS if body in r else ():
                np.testing.assert_array_equal(
                    getattr(r["block"], field).numpy(),
                    getattr(r[body], field).numpy(),
                    err_msg=f"{name} {dt} {key} {body} {field}")


@pytest.mark.parametrize("name", MODELS)
def test_block_body_matches_plain_f64(name):
    """float64: X, U within 1e-8 of the plain version, equal statuses and
    iterations, every instance converged, at every (B, N) and mode."""
    for key, r in _body_runs(name, "float64").items():
        rk, rp = r["block"], r["plain"]
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0,
                                   atol=1e-8, err_msg=f"{name} {key}")
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0,
                                   atol=1e-8, err_msg=f"{name} {key}")
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
        np.testing.assert_array_equal(rk.iters.numpy(), rp.iters.numpy())
        assert bool((rk.status == 0).all()), (key, rk.status)


@pytest.mark.parametrize("name", REGISTERED)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("B, N", [(3, 25), (1, 60)], ids=["B3-N25", "B1-N60"])
def test_block_body_matches_jax(name, mode, B, N):
    """float32 warm re-solves from one shared warm start (the port's cold
    plan, x0 + 0.01), B=3 at N=25 and B=1 at N=60: the block body against
    the JAX Pallas kernel in interpret mode, X and U within 2e-5 (the band
    of tests/test_fused_kernel.py:56-95), equal statuses."""
    jprob, pb, prob, tp = _problems(name, B, N)
    X0, U0, tp2 = _warm_start(prob, tp)
    jopts = JaxSolverOptions(tol=TOL, max_iter=30, dtype="float32")
    mu = jopts.warm_mu_factor * jopts.tol
    rj = jax_solve_fused(jprob, pb._replace(x0=pb.x0 + 0.01),
                         jnp.asarray(X0.numpy()), jnp.asarray(U0.numpy()),
                         jopts, mu0=jnp.asarray(mu, jnp.float32),
                         tile=(1, 8), interpret=True, **MODES[mode])
    rj = jax.tree.map(np.asarray, rj)
    rk = _solve("block", prob, tp2, X0, U0, mode)
    np.testing.assert_allclose(rk.X.numpy(), rj.X, rtol=0, atol=2e-5)
    np.testing.assert_allclose(rk.U.numpy(), rj.U, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(rk.status.numpy(), rj.status)


BRANCHES = ("u_bounds", "x_bounds", "head_pinning")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("case", BRANCHES)
def test_block_body_branches(name, case):
    """The block body's other branches in float64, fixed-3 and adaptive,
    B=3, N=25: against the plain version at 1e-8 with equal statuses, and
    bitwise the group body.  Active control bounds (``U_TIGHT``: the
    barrier and the fraction-to-boundary cap on u), active state bounds
    (``Q_BOUND``), head pinning (num_control_inputs_saved=2: the pinned
    controls stay exactly at the warm start)."""
    bounds = dict(u_tight=case == "u_bounds", x_bounded=case == "x_bounds")
    _, _, prob, tp = _problems(name, 3, 25, np.float64, seed=1, **bounds)
    X0, U0, tp2 = _warm_start(prob, tp)
    opts = SolverOptions(tol=TOL, max_iter=30)
    if case == "head_pinning":
        opts = dataclasses.replace(opts, num_control_inputs_saved=2)
    active = False
    for mode in MODES:
        r = {b: _solve(b, prob, tp2, X0, U0, mode, opts)
             for b in ("block", "group", "plain")}
        rk, rp = r["block"], r["plain"]
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), atol=1e-8)
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), atol=1e-8)
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(rk, field).numpy(),
                                          getattr(r["group"], field).numpy())
        if case == "head_pinning":
            np.testing.assert_array_equal(rk.U[:, :2].numpy(),
                                          U0[:, :2].numpy())
        if case == "u_bounds":
            ulim = U_TIGHT[name]
            assert bool((rk.U.abs() < ulim).all())
            active |= bool((rk.U.abs() > 0.95 * ulim).any())
        if case == "x_bounds":
            q = rk.X[:, 1:, :prob.nx // 2].abs()
            assert bool((q < Q_BOUND).all())
            active |= bool((q > 0.95 * Q_BOUND).any())
    assert active or case == "head_pinning", f"{case}: no bound came near"


@pytest.mark.parametrize("name", MODELS)
def test_nan_instance_leaves_the_others_untouched(name):
    """B=3 with a NaN in instance 1's x0: instance 1 ends DIVERGED, and
    instances 0 and 2 are bitwise what they are when instance 1 is sound
    (an instance's block shares nothing with another's)."""
    _, _, prob, tp = _problems(name, 3, 25)
    X0, U0, tp2 = _warm_start(prob, tp)
    x0 = tp2.x0.clone()
    x0[1, 0] = float("nan")
    for mode in MODES:
        good = _solve("block", prob, tp2, X0, U0, mode)
        bad = _solve("block", prob, tp2._replace(x0=x0), X0, U0, mode)
        assert int(bad.status[1]) == 2 and int(good.status[1]) != 2
        for field in FIELDS:
            a, b = getattr(good, field), getattr(bad, field)
            np.testing.assert_array_equal(a[[0, 2]].numpy(),
                                          b[[0, 2]].numpy())


@pytest.mark.parametrize("name", MODELS)
def test_rule_picks_the_block_body_at_small_batch(name):
    """``card_body`` asks the launcher's rule: the block body (256 threads
    an instance) from B=1 to the threshold, the body at full occupancy
    (the group body at its width, or one thread) above it and at B=None,
    and at a horizon whose instance does not fit in a block's 227 KB of
    shared memory, at any B."""
    prob = _problems(name, 1, 25)[2]
    long = _problems(name, 1, 1000)[2]
    block, group = ("block", 256), FULL_BODY[name]
    top = BLOCK_MAX_BATCH[name]
    assert [card_body(prob, B) for B in (1, 2, top)] == [block] * 3
    assert [card_body(prob, B) for B in (top + 1, 16384)] == [group] * 2
    assert card_body(prob) == group
    assert card_body(long, 1) == group
    assert card_body(_problems(name, 1, 200)[2], 1) == block
