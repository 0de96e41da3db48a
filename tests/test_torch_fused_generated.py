"""The fused kernel's generated instantiations (``solver/target.py``
``kernel_target``: a user's model emitted as C++ by
``models/codegen.py``, or an LTV shape outside the four hand-written
ones), run through their g++ builds, the kernel bodies' own arithmetic.

- Generated against hand-written: the four closed forms' own ``f``, given
  as user models without ``closed_form``, against the hand-written
  ``FastNq`` / ``Generic`` instantiations.
- Against JAX: a Van der Pol oscillator (RK4) and a kinematic unicycle
  (Euler), written once in ``jnp`` and once in torch, through the JAX
  Pallas kernel in interpret mode and the generated g++ build, on the
  body the card runs at full occupancy and at the case's batch (the block
  body where the policy has one); the spring-coupled chain at nq = 4
  (nx = 8, nu = 4: the nq-row step with more controls than its two
  lanes) at B=1, N=25 the same way, on the block body; LTV at (6, 3) and
  (12, 6) the same way, on the group body (more controls than lanes).
- The generated closed forms on the block body against the hand-written
  block body where one exists, else the body the hand-written
  instantiation runs, bit for bit; the body the rule picks for a user's
  model at B=1, at its block body's threshold and past it.
- LTV at (3, 2) and (12, 6) against the plain version; at (12, 6) and
  (6, 3) the group body bitwise the one-thread body; the body the rule
  picks.
- ``generate_model`` -> ``ModelControl`` with a user ``Dynamics`` on the
  CPU, and the library it names for the card.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models.base import Dynamics as JaxDynamics
from mahi_mpc_tpu.solver.fused import solve_batch_fused as jax_solve_fused
from mahi_mpc_tpu.transcribe.shooting import LinPoint as JaxLinPoint
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch._build import cpu_build_all
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.runtime import ModelControl, generate_model
from mahi_mpc_tpu_torch.runtime.generate import kernel_libraries
from mahi_mpc_tpu_torch.solver.fused import (card_body, fused_supported,
                                             solve_batch_fused,
                                             solve_batch_fused_cpu_kernel)
from mahi_mpc_tpu_torch.solver.target import kernel_target
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 8, 8
TOL = 1e-4
CLOSED_FORMS = ["pendulum", "cartpole", "double_pendulum", "acrobot"]


def _user(name):
    """A registered closed form's own f as a user model: the same
    Dynamics without ``closed_form``, so no hand-written instantiation
    serves it."""
    dyn = make_dynamics(name)
    return Dynamics(f"user_{name}", dyn.nx, dyn.nu, dyn.f,
                    supports_lanes=True, nq=dyn.nq)


def _vdp_torch(x, u):
    return torch.stack([x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]])


def _vdp_jax(x, u):
    return jnp.stack([x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]])


def _unicycle_torch(x, u):
    return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]),
                        u[1]])


def _unicycle_jax(x, u):
    return jnp.stack([u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]])


def _chain_torch(nq):
    """A chain of nq pendulums coupled by springs (the LTV cases' model)."""
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        left, right = torch.cat([q[:1], q[:-1]]), torch.cat([q[1:], q[-1:]])
        return torch.cat([qd, u[:nq] - torch.sin(q) - 0.1 * qd
                          + 0.5 * ((left - 2.0 * q) + right)])
    return f


def _chain_jax(nq):
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        left = jnp.concatenate([q[:1], q[:-1]])
        right = jnp.concatenate([q[1:], q[-1:]])
        return jnp.concatenate([qd, u[:nq] - jnp.sin(q) - 0.1 * qd
                                + 0.5 * ((left - 2.0 * q) + right)])
    return f


def _ltv_torch(nx, nu):
    """An LTV problem's model at (nx, nu): the chain at nq = nx / 2 with
    its first nu joints actuated (the rest zero), or at odd nx a chain of
    (nx - 1) / 2 pendulums and a first-order tail."""
    nq = nx // 2

    def f(x, u):
        q, qd = x[:nq], x[nq:2 * nq]
        act = torch.cat([u, torch.zeros_like(q[:nq - nu])]) if nu < nq \
            else u[:nq]
        rows = [qd, act - torch.sin(q) - 0.1 * qd]
        if nx % 2:
            rows.append((u[-1] - x[-1])[None])
        return torch.cat(rows)
    return Dynamics(f"ltv_{nx}x{nu}", nx, nu, f, supports_lanes=True)


def _params(mp, dyn, dtype, seed=0):
    """Bench-shaped inputs for B instances from one numpy seed (LTV frozen
    at each instance's (x0, u_prev))."""
    nx, nu = dyn.nx, dyn.nu
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    p = default_params(mp, dtype=dtype, device="cpu")._replace(
        q=t([10.0] * nx), r=t([0.1] * nu), rm=t([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=t(0.3 * rng.standard_normal((B, nx))),
                   u_prev=t(0.3 * rng.standard_normal((B, nu))),
                   x_des=t(0.3 * rng.standard_normal((B, N, nx))))
    if mp.is_linear:
        A, Bm, xd0 = vmap(dyn.linearize)(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return p


def _mp(dyn, integrator, is_linear=False, ulim=20.0, dt=0.02):
    return ModelParameters("t", num_x=dyn.nx, num_u=dyn.nu, step_size=dt,
                           num_shooting_nodes=N, u_min=[-ulim] * dyn.nu,
                           u_max=[ulim] * dyn.nu, integrator=integrator,
                           is_linear=is_linear)


# The generated instantiations of this file, by case.
HAND = [(name, integrator) for name in CLOSED_FORMS
        for integrator in ("euler", "rk4")]
LTV_PLAIN = [(3, 2), (12, 6)]
# LTV shapes with more controls than their group has lanes, and the body
# the card runs them on (csrc/fused_sqp_group.cuh `GroupBody<Ltv>`).
LTV_WIDE = [(12, 6), (6, 3)]
WIDE_BODY = {(12, 6): ("group", 4), (6, 3): ("thread", 1)}
# More shapes the rule decides: (8, 2) on four lanes (nx a multiple of 4
# from 8 up, whatever nu); (16, 8), whose 32 tiles a block would take 234
# KB of shared memory, on one thread.
LTV_RULE = {(8, 2): ("group", 4), (16, 8): ("thread", 1)}


@pytest.fixture(scope="module")
def builds():
    """Every generated unit this file runs, built by one concurrent g++
    call (the hand-written build beside them)."""
    probs = [make_problem(_mp(_user(n), i), _user(n)) for n, i in HAND]
    probs += [make_problem(_mp(_ltv_torch(*s), "euler", True),
                           _ltv_torch(*s))
              for s in LTV_PLAIN + LTV_WIDE + list(LTV_RULE)]
    probs += [make_problem(_mp(d, i), d) for d, i in (
        (Dynamics("vdp", 2, 1, _vdp_torch, supports_lanes=True), "rk4"),
        (Dynamics("unicycle", 3, 2, _unicycle_torch, supports_lanes=True),
         "euler"),
        (Dynamics("chain4", 8, 4, _chain_torch(4), supports_lanes=True,
                  nq=4), "euler"))]
    cpu_build_all(["fused_sqp"] + [kernel_target(p).cuda for p in probs])


def _cold_then_warm(prob, p, solve):
    opts = SolverOptions(tol=TOL, max_iter=30)
    cold = solve(prob, p, opts=opts, mu0=opts.mu_init, adaptive=True)
    return cold, solve(prob, p._replace(x0=p.x0 + 0.01), cold.X, cold.U,
                       opts, n_iter=3)


@pytest.mark.parametrize("body", ["thread", "group", "block"])
@pytest.mark.parametrize("name, integrator", HAND)
def test_generated_matches_hand_written(builds, name, integrator, body):
    """float32: a closed form's own f through its generated instantiation
    (FastNq over the generated acc under Euler, Generic under RK4) against
    the hand-written instantiation of the same model, each body (the
    generated block body against the hand-written block body where one
    exists, else against the body the card runs the hand-written one on):
    the adaptive cold solve and the fixed-3 warm solve from its plan, X
    and U within 2e-6 (the same expression trees in the traced order, up
    to commuted operands), equal statuses; on the block body bit for bit.
    Whether the others agree bit for bit is printed."""
    user = _user(name)
    mp = _mp(user, integrator, ulim=60.0, dt=0.005)
    prob_gen, prob_hand = make_problem(mp, user), make_problem(
        mp, make_dynamics(name))
    assert kernel_target(prob_gen).unit is not None
    assert kernel_target(prob_hand).unit is None
    assert card_body(prob_gen, 1) == ("block", 256)
    hand_body = body
    if body == "block" and card_body(prob_hand, 1)[0] != "block":
        hand_body = card_body(prob_hand)[0]
    p = _params(mp, user, torch.float32)
    gen = _cold_then_warm(prob_gen, p, functools.partial(
        solve_batch_fused_cpu_kernel, body=body))
    hand = _cold_then_warm(prob_hand, p, functools.partial(
        solve_batch_fused_cpu_kernel, body=hand_body))
    bitwise = True
    for rg, rh in zip(gen, hand):
        np.testing.assert_array_equal(rg.status.numpy(), rh.status.numpy())
        for field in ("X", "U"):
            a, b = getattr(rg, field).numpy(), getattr(rh, field).numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
            bitwise = bitwise and np.array_equal(a, b)
    assert bool((gen[0].status == 0).all())
    assert bitwise or body != "block"
    print(f"{name} {integrator} {body}: bitwise={bitwise}")


# ---- against the JAX Pallas kernel in interpret mode -----------------------

JAX_CASES = {
    "vdp": (2, 1, "rk4", _vdp_jax, _vdp_torch, 5.0),
    "unicycle": (3, 2, "euler", _unicycle_jax, _unicycle_torch, 2.0),
    "chain4": (8, 4, "euler", _chain_jax(4), _chain_torch(4), 20.0),
    "ltv_6x3": (6, 3, "euler", _chain_jax(3), _chain_torch(3), 20.0),
    "ltv_12x6": (12, 6, "euler", _chain_jax(6), _chain_torch(6), 20.0),
}
# (B, N) of a case where it is not (B, N) above: the 4-DOF chain as the
# single robot's warm calc_u runs it.
JAX_SHAPES = {"chain4": (1, 25)}


@pytest.fixture(scope="module")
def jax_pairs(builds):
    """For each case of JAX_CASES: one warm start (the port's plain cold
    solve) and warm re-solves of n_iter = 1 and 3 at x0 + 0.01 by the JAX
    Pallas kernel in interpret mode and by the port's generated g++ build
    (each body the card runs it on: at full occupancy and at the case's
    batch), from the same numpy arrays."""
    out = {}
    for key, (nx, nu, integrator, fj, ft, ulim) in JAX_CASES.items():
        ltv = key.startswith("ltv")
        nb, nn = JAX_SHAPES.get(key, (B, N))
        kw = dict(num_x=nx, num_u=nu, step_size=0.02, num_shooting_nodes=nn,
                  u_min=[-ulim] * nu, u_max=[ulim] * nu,
                  integrator=integrator, is_linear=ltv)
        nq = nx // 2 if ltv or key == "chain4" else None
        jdyn = JaxDynamics(key, nx, nu, fj, supports_lanes=True, nq=nq)
        dyn = Dynamics(key, nx, nu, ft, supports_lanes=True, nq=nq)
        jmp = JaxModelParameters("t", **kw)
        jprob, prob = jax_make_problem(jmp, jdyn), make_problem(
            ModelParameters("t", **kw), dyn)
        rng = np.random.default_rng(1)
        f32 = jnp.float32
        p = jax_default_params(jmp, dtype=f32)._replace(
            q=jnp.full((nx,), 10.0, f32), r=jnp.full((nu,), 0.1, f32),
            rm=jnp.full((nu,), 0.01, f32))
        pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (nb,) + a.shape), p)
        pb = pb._replace(
            x0=jnp.asarray(0.3 * rng.standard_normal((nb, nx)), f32),
            x_des=jnp.asarray(0.3 * rng.standard_normal((nb, nn, nx)), f32))
        if ltv:
            A, Bm, xd0 = jax.vmap(jdyn.linearize)(pb.x0, pb.u_prev)
            pb = pb._replace(lin=JaxLinPoint(A, Bm, xd0, pb.x0, pb.u_prev))
        tp = params_from_numpy(jax.tree.map(np.asarray, pb), device="cpu")
        opts = SolverOptions(tol=TOL, max_iter=30)
        cold = solve_batch_fused(prob, tp, opts=opts, mu0=opts.mu_init,
                                 adaptive=True)
        X0, U0 = cold.X.numpy(), cold.U.numpy()
        pb2, tp2 = pb._replace(x0=pb.x0 + 0.01), tp._replace(x0=tp.x0 + 0.01)
        jopts = JaxSolverOptions(tol=TOL, max_iter=12, dtype="float32")
        mu_warm = jopts.warm_mu_factor * jopts.tol
        for n in (1, 3):
            rj = jax_solve_fused(jprob, pb2, jnp.asarray(X0), jnp.asarray(U0),
                                 jopts, mu0=jnp.asarray(mu_warm, f32),
                                 n_iter=n, tile=(1, 8), interpret=True)
            rt = {body: solve_batch_fused_cpu_kernel(
                prob, tp2, torch.tensor(X0), torch.tensor(U0),
                SolverOptions(tol=TOL, max_iter=12), mu0=mu_warm, n_iter=n,
                body=body)
                for body in dict.fromkeys([card_body(prob)[0],
                                           card_body(prob, nb)[0]])}
            out[key, n] = (jax.tree.map(np.asarray, rj), rt, prob)
    return out


@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("key", list(JAX_CASES))
def test_generated_matches_jax(jax_pairs, key, n_iter):
    """X and U at atol 2e-5 (the band of tests/test_torch_fused_fixed.py:
    float32 roundoff of two implementations of one iteration), equal
    statuses: a user model the JAX kernel traces into its Pallas body, and
    the port's instantiation generated from the same model in torch, on
    each body the card runs it on (the block body for Van der Pol and the
    chain at their batch)."""
    rj, runs, prob = jax_pairs[key, n_iter]
    assert kernel_target(prob).unit is not None
    assert ("block" in runs) == (key in ("vdp", "chain4"))
    for body, rt in runs.items():
        np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=2e-5,
                                   err_msg=body)
        np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=2e-5,
                                   err_msg=body)
        np.testing.assert_array_equal(rt.status.numpy(), rj.status)


# The block body's threshold for a user's model, by step policy
# (csrc/fused_sqp_block.cuh `BlockBody<FastNq<gen::Model>>`,
# `BlockBody<Generic<gen::Model>>`).
GEN_BLOCK_MAX_BATCH = {"fast": 396, "generic": 792}
# A user's model: its step policy and the body the card runs it on at full
# occupancy; the unicycle (nx = 3) does not split over two lanes and has
# no block body.
GEN_RULE = {"vdp": ("generic", ("group", 2)),
            "cartpole": ("fast", ("thread", 1)),
            "chain4": ("fast", ("thread", 1)),
            "unicycle": (None, ("thread", 1))}


def _rule_problem(key):
    if key == "cartpole":
        return make_problem(_mp(_user("cartpole"), "euler"), _user("cartpole"))
    nx, nu, integrator, _, ft, _ = JAX_CASES[key]
    dyn = Dynamics(key, nx, nu, ft, supports_lanes=True,
                   nq=4 if key == "chain4" else None)
    return make_problem(_mp(dyn, integrator), dyn)


@pytest.mark.parametrize("key", list(GEN_RULE))
def test_generated_card_body_rule(builds, key):
    """The body the card runs a user's model on (``card_body``, the
    launcher's rule): the block body from B=1 to its policy's threshold
    (and at N=200), the body it ran before past the threshold, at full
    occupancy and where the instance does not fit in a block's shared
    memory (N=1000); the unicycle on one thread at every B."""
    prob = _rule_problem(key)
    policy, other = GEN_RULE[key]
    assert card_body(prob) == other
    if policy is None:
        assert card_body(prob, 1) == other
        return
    top = GEN_BLOCK_MAX_BATCH[policy]
    block = ("block", 256)
    assert [card_body(prob, b) for b in (1, 2, top)] == [block] * 3
    assert [card_body(prob, b) for b in (top + 1, 16384)] == [other] * 2
    long = lambda n: dataclasses.replace(prob, N=n)
    assert card_body(long(200), 1) == block
    assert card_body(long(1000), 1) == other


# ---- LTV shapes outside the hand-written four, against the plain version ----

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", LTV_PLAIN, ids=lambda s: f"{s[0]}x{s[1]}")
def test_generated_ltv_matches_plain(builds, shape, dtype):
    """The generated Ltv<S, NX, NU> on the body the card runs (one thread
    at (3, 2), whose odd NX does not split over a group; the four-lane
    group at (12, 6)) against the plain version: the adaptive cold and
    fixed-3 warm solves, X and U at 1e-8 in float64 and 2e-5 in float32,
    equal statuses; every instance converges cold."""
    dyn = _ltv_torch(*shape)
    mp = _mp(dyn, "euler", True)
    prob = make_problem(mp, dyn)
    assert fused_supported(prob) and kernel_target(prob).unit is not None
    assert card_body(prob) == WIDE_BODY.get(shape, ("thread", 1))
    p = _params(mp, dyn, dtype)
    atol = 1e-8 if dtype == torch.float64 else 2e-5
    kernel = _cold_then_warm(prob, p, functools.partial(
        solve_batch_fused_cpu_kernel, body=card_body(prob)[0]))
    for rk, rp in zip(kernel, _cold_then_warm(prob, p, solve_batch_fused)):
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    assert bool((kernel[0].status == 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", LTV_WIDE, ids=lambda s: f"{s[0]}x{s[1]}")
def test_generated_ltv_group_body_matches_thread_body_bitwise(builds, shape,
                                                              dtype):
    """LTV with more controls than lanes ((12, 6) on four lanes, the card's
    body; (6, 3) on two, which the card leaves on one thread, where two
    lanes lost: lane l owns controls l, l + W, ...), the group body against
    the one-thread body, both g++ builds: the adaptive cold and fixed-3 warm
    solves, every output bitwise equal (the group body keeps the one-thread
    body's order in every sum)."""
    dyn = _ltv_torch(*shape)
    mp = _mp(dyn, "euler", True)
    prob = make_problem(mp, dyn)
    assert card_body(prob) == WIDE_BODY[shape]
    assert card_body(prob, 1) == WIDE_BODY[shape]       # no block body
    p = _params(mp, dyn, dtype)
    runs = {body: _cold_then_warm(prob, p, functools.partial(
        solve_batch_fused_cpu_kernel, body=body))
        for body in ("group", "thread")}
    for rg, rt in zip(runs["group"], runs["thread"]):
        for field in ("X", "U", "status", "iters", "kkt", "feas", "obj"):
            np.testing.assert_array_equal(getattr(rg, field).numpy(),
                                          getattr(rt, field).numpy(),
                                          err_msg=f"{shape} {field}")
    assert bool((runs["group"][0].status == 0).all())


@pytest.mark.parametrize("shape", list(LTV_RULE),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ltv_card_body_rule(builds, shape):
    """The body the card runs a generated LTV shape on (``card_body``, the
    launcher's rule, at full occupancy and at B=1: no block body)."""
    dyn = _ltv_torch(*shape)
    prob = make_problem(_mp(dyn, "euler", True), dyn)
    assert card_body(prob) == LTV_RULE[shape] == card_body(prob, 1)


# ---- the runtime with a user Dynamics ----------------------------------------

def test_generate_model_then_model_control_with_user_dynamics(tmp_path):
    """generate_model with a user Dynamics writes the artifact on the
    CPU (no library: nothing is built off the card); the library it would
    build on the card is the problem's generated one; ModelControl loads
    the artifact with the same Dynamics, resolves its warm solves to the
    fused solve when asked (the plain version here) and plans: a converged
    cold calc_u and warm ones whose first control agrees with a solve of
    the same inputs."""
    dyn = Dynamics("user_vdp", 2, 1, _vdp_torch, supports_lanes=True)
    mp = dataclasses.replace(_mp(dyn, "rk4", ulim=5.0), name="user_vdp",
                             num_shooting_nodes=10)
    opts = SolverOptions(tol=1e-4, max_iter=30, fixed_warm_iters=3)
    man = json.loads(generate_model(mp, dynamics=dyn, directory=tmp_path,
                                    opts=opts, device="cpu").read_text())
    assert man["libraries"] == {} and man["warm_solver"] == "fixed"
    prob = make_problem(mp, dyn)
    lib = kernel_target(prob).cuda
    assert lib.startswith("gen-")
    assert kernel_libraries(prob, opts, "cuda") == [lib]
    mc = ModelControl("user_vdp", directory=tmp_path, dynamics=dyn,
                      Q=[10.0, 10.0], R=[0.1], Rm=[0.0], device="cpu",
                      opts=dataclasses.replace(opts, warm_solver="fused"))
    assert mc.warm_solver == "fused"
    traj = np.zeros((mp.num_shooting_nodes, 2))
    x, u = np.array([1.0, 0.0]), np.zeros(1)
    plan = mc.calc_u(0.0, x, u, traj)
    assert plan.status == 0
    for k in range(3):
        u = plan.U[0]
        x = x + mp.step_size * _vdp_torch(torch.tensor(x)[:, None],
                                          torch.tensor(u)[:, None])[:, 0].numpy()
        plan = mc.calc_u((k + 1) * mp.step_size, x, u, traj)
        assert np.isfinite(plan.U).all() and plan.status == 0
    assert mc.stats.summary()["failures"] == 0
