"""The LTV path's kernels on the CPU (``solver/linearize.py``): the
linearization and the affine discretization built by g++ from the sources
nvcc builds for the card (``csrc/model_linearize.cuh``: the card's blocks,
tile after tile, each phase's threads one after another), and their plain
versions, against the JAX package on the same numpy inputs; the blocks at
partial and full tiles against the plain version, and with their threads
in reverse order; the LTV service with the g++ bodies against the JAX
service; and the route a model takes.

Bands: relative to max|.| of the reference output, 1e-9 in float64 and
1e-5 in float32 (the arm's folded columns agree with ``jacfwd`` to
rounding; an RK4 step's rows are formed directly, not as Ad - I; the
largest float32 reading is 2.6e-6, the (6, 3) midpoint step's cd).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.models.base import Dynamics as JaxDynamics
from mahi_mpc_tpu.runtime import BatchModelControl as JaxBatchModelControl
from mahi_mpc_tpu.solver import batched as jb
from mahi_mpc_tpu.transcribe.shooting import LinPoint as JaxLinPoint
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch import _build
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics, rk4_step
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.runtime import batch_service
from mahi_mpc_tpu_torch.solver import fused, linearize as lz
from mahi_mpc_tpu_torch.solver.target import kernel_target, model_kernel
from mahi_mpc_tpu_torch.transcribe.shooting import LinPoint, MPCParams
from mahi_mpc_tpu_torch.transcribe.shooting import default_params
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

B = 3
TOLS = {"float64": 1e-9, "float32": 1e-5}
REGISTERED = ("mahi_arm", "two_link_arm", "pendulum", "cartpole",
              "double_pendulum", "acrobot")


def _chain_torch(nq):
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        left, right = torch.cat([q[:1], q[:-1]]), torch.cat([q[1:], q[-1:]])
        return torch.cat([qd, u - torch.sin(q) - 0.1 * qd
                          + 0.5 * ((left - 2.0 * q) + right)])
    return f


def _chain_jax(nq):
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        left = jnp.concatenate([q[:1], q[:-1]])
        right = jnp.concatenate([q[1:], q[-1:]])
        return jnp.concatenate([qd, u - jnp.sin(q) - 0.1 * qd
                                + 0.5 * ((left - 2.0 * q) + right)])
    return f


def _models(name):
    """(port Dynamics, JAX Dynamics): a registered model, or ``chain3``, a
    user's model (three pendulums coupled by springs, nx = 6, nu = 3) that
    the code generator lowers."""
    if name == "chain3":
        return (Dynamics("user_chain3", 6, 3, _chain_torch(3),
                         supports_lanes=True, nq=3),
                JaxDynamics("user_chain3", 6, 3, _chain_jax(3),
                            supports_lanes=True, nq=3))
    return make_dynamics(name), jax_make_dynamics(name)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _points(dyn, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, dyn.nx)),
            rng.standard_normal((B, dyn.nu)))


@functools.lru_cache(maxsize=None)
def _jax_linearize(name, dtype):
    _, jdyn = _models(name)
    dyn = _models(name)[0]
    x0, u0 = _points(dyn)
    jd = getattr(jnp, dtype)
    return [np.asarray(a) for a in jax.jit(jax.vmap(jdyn.linearize))(
        jnp.asarray(x0, jd), jnp.asarray(u0, jd))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", REGISTERED + ("chain3",))
def test_linearize_matches_jax(name, dtype):
    """The g++ build of the linearization's blocks and the plain version
    against the JAX package's jitted ``vmap(dynamics.linearize)`` on numpy
    seed 0's points: A, B and x_dot0, each within the dtype's band; both
    routes resolve to the kernel."""
    dyn, _ = _models(name)
    assert model_kernel(dyn) is not None
    x0, u0 = [torch.tensor(a, dtype=getattr(torch, dtype))
              for a in _points(dyn)]
    ref = _jax_linearize(name, dtype)
    for fn in (lz.linearize_batch_cpu_kernel, lz.linearize_batch):
        got = fn(dyn, x0, u0)
        for g, r in zip(got, ref):
            assert g.dtype == x0.dtype and tuple(g.shape) == r.shape
            assert _rel(g, r) <= TOLS[dtype], (fn.__name__, _rel(g, r))


def _ltv_case(shape, integrator, dtype):
    """An LTV problem at ``shape`` in both packages, frozen at numpy seed
    1's points: (8, 4) the 4-DOF arm, (4, 1) the cart-pole, (6, 3) the
    user chain (a generated instantiation)."""
    name = {(8, 4): "mahi_arm", (4, 1): "cartpole", (6, 3): "chain3"}[shape]
    dyn, jdyn = _models(name)
    kw = dict(num_x=dyn.nx, num_u=dyn.nu, step_size=0.02,
              num_shooting_nodes=5, is_linear=True, integrator=integrator)
    jprob = jax_make_problem(JaxModelParameters("ltv", **kw), jdyn)
    prob = make_problem(ModelParameters("ltv", **kw), dyn)
    jmp = JaxModelParameters("ltv", **kw)
    jd = getattr(jnp, dtype)
    p = jax_default_params(jmp, dtype=jd)
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    x0, u0 = [jnp.asarray(a, jd) for a in _points(dyn, seed=1)]
    A, Bm, xd0 = jax.jit(jax.vmap(jdyn.linearize))(x0, u0)
    p = p._replace(x0=x0, u_prev=u0, lin=JaxLinPoint(
        A.astype(jd), Bm.astype(jd), xd0.astype(jd), x0, u0))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu",
                           dtype=getattr(torch, dtype))
    Ad, Bd, cd = jb._ltv_discrete(jprob, p)
    ref = (np.asarray(Ad) - np.eye(dyn.nx), np.asarray(Bd), np.asarray(cd))
    return prob, tp, ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("shape", [(8, 4), (4, 1), (6, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ltv_discrete_matches_jax(shape, integrator, dtype):
    """The g++ build of the discretization's blocks and the plain version
    against the JAX package's ``_ltv_discrete`` minus I: (Ad - I, Bd, cd)
    within the dtype's band; the kernel's outputs are batch-leading views of
    batch-innermost storage (what the fused solve streams, uncopied)."""
    prob, p, ref = _ltv_case(shape, integrator, dtype)
    assert (kernel_target(prob).unit is None) == (shape != (6, 3))
    got = lz.ltv_discrete_cpu_kernel(prob, p)
    assert all(g.movedim(0, -1).is_contiguous() for g in got)
    for fn_got in (got, lz.ltv_discrete(prob, p)):
        for g, r in zip(fn_got, ref):
            assert g.dtype == p.x0.dtype and tuple(g.shape) == r.shape
            assert _rel(g, r) <= TOLS[dtype], _rel(g, r)


# ---- the blocks: partial and full tiles, threads in any order ----------------

# A tile holds 32 instances (64 where a block would have fewer than 128
# threads): one partial tile, a full one and a partial one, or partial ones.
TILE_BATCHES = (1, 33, 37)
SHAPES = {(8, 4): "mahi_arm", (4, 1): "cartpole", (6, 3): "chain3"}


def _unaligned(t):
    """``t`` copied to storage one element past a 16-byte boundary: the
    tile's spans then take their scalar copy."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    return out.copy_(t)


def _tile_points(dyn, B, dtype):
    rng = np.random.default_rng(B)
    x0, u0 = [torch.tensor(a, dtype=dtype) for a in (
        0.5 * rng.standard_normal((B, dyn.nx)),
        rng.standard_normal((B, dyn.nu)))]
    return (x0, u0) if B != 37 else (_unaligned(x0), _unaligned(u0))


def _tile_frozen(shape, integrator, B, dtype):
    """An LTV problem at ``shape`` and B frozen points drawn from numpy
    seed B (a frozen linearization of any values: the step is affine in
    it), unaligned at B=37."""
    dyn = _models(SHAPES[shape])[0]
    mp = ModelParameters("ltv", num_x=dyn.nx, num_u=dyn.nu, step_size=0.02,
                         num_shooting_nodes=5, is_linear=True,
                         integrator=integrator)
    p = default_params(mp, dtype=dtype, device="cpu")
    p = MPCParams(*[type(f)(*[a.expand((B,) + a.shape) for a in f])
                    if isinstance(f, tuple) else f.expand((B,) + f.shape)
                    for f in p])
    rng = np.random.default_rng(B)
    nx, nu = dyn.nx, dyn.nu
    lin = [torch.tensor(rng.standard_normal((B,) + s), dtype=dtype)
           for s in ((nx, nx), (nx, nu), (nx,), (nx,), (nu,))]
    if B == 37:
        lin = [_unaligned(t) for t in lin]
    return make_problem(mp, dyn), p._replace(
        x0=lin[3], u_prev=lin[4], lin=LinPoint(*lin))


def _rel_t(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B", TILE_BATCHES)
@pytest.mark.parametrize("name", REGISTERED + ("chain3",))
def test_linearize_tiles_match_plain(name, B):
    """The g++ blocks of the linearization at B = 1, 33, 37 (at 37 from
    unaligned inputs) against the plain version on the same points: A, B
    and x_dot0 within the dtype's band, float64 and float32."""
    dyn, _ = _models(name)
    for dtype in (torch.float64, torch.float32):
        x0, u0 = _tile_points(dyn, B, dtype)
        got = lz.linearize_batch_cpu_kernel(dyn, x0, u0)
        want = lz.linearize_batch_plain(dyn, x0, u0)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert _rel_t(g, w) <= TOLS[str(dtype)[6:]], (dtype, _rel_t(g, w))


@pytest.mark.parametrize("B", TILE_BATCHES)
@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_ltv_discrete_tiles_match_plain(shape, integrator, B):
    """The g++ blocks of the discretization at B = 1, 33, 37 (at 37 from
    unaligned frozen points) against the plain version: (Ad - I, Bd, cd)
    within the dtype's band, float64 and float32, batch-innermost under
    batch-leading views."""
    for dtype in (torch.float64, torch.float32):
        prob, p = _tile_frozen(shape, integrator, B, dtype)
        got = lz.ltv_discrete_cpu_kernel(prob, p)
        assert all(g.movedim(0, -1).is_contiguous() for g in got)
        for g, w in zip(got, lz.ltv_discrete_plain(prob, p)):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert _rel_t(g, w) <= TOLS[str(dtype)[6:]], (dtype, _rel_t(g, w))


@pytest.mark.parametrize("name", REGISTERED + ("chain3",))
def test_linearize_tasks_share_no_state(name):
    """Each phase's threads run last to first give bitwise the outputs of
    first to last, at B=37 in float64 and float32: no task reads what
    another writes."""
    dyn, _ = _models(name)
    for dtype in (torch.float64, torch.float32):
        x0, u0 = _tile_points(dyn, 37, dtype)
        fwd = lz.linearize_batch_cpu_kernel(dyn, x0, u0)
        back = lz.linearize_batch_cpu_kernel(dyn, x0, u0, reverse=True)
        assert all(torch.equal(f, b) for f, b in zip(fwd, back))


@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_ltv_discrete_tasks_share_no_state(shape, integrator):
    """As ``test_linearize_tasks_share_no_state``, for the
    discretization."""
    for dtype in (torch.float64, torch.float32):
        prob, p = _tile_frozen(shape, integrator, 37, dtype)
        fwd = lz.ltv_discrete_cpu_kernel(prob, p)
        back = lz.ltv_discrete_cpu_kernel(prob, p, reverse=True)
        assert all(torch.equal(f, b) for f, b in zip(fwd, back))


def test_ltv_operation_counts():
    """The operation counts the smoke's bounds divide: the arm's
    linearization does its q columns' chain passes and the user chain's
    (its generated build) a dual pass a column, each with the joint
    angles' sines (transcendental operations); the (8, 4) discretization
    under Euler one affine pass a column (no division, no transcendental)
    and RK4 about four times Euler's.  The tasks' own tallies are the
    one-thread kernels' (34,888 an instance for the arm, 7,500 for the
    (8, 4) Euler step: the tasks do each pass once); the minimum, the
    bounds' numerator, counts the value part once: 21,140 and 4,057."""
    minimum = {"mahi_arm": 21140, "chain3": 297}
    for name in ("mahi_arm", "chain3"):
        dyn = _models(name)[0]
        x0, u0 = [torch.tensor(a) for a in _points(dyn)]
        lin = lz.count_linearize_ops(dyn, x0, u0)
        assert lin["body"]["transcendental"] > 0 and lin["body"]["mul"] > 0
        assert 0 < lin["minimum"]["transcendental"] \
            < lin["body"]["transcendental"]
        assert sum(lin["minimum"].values()) == minimum[name] * B
        if name == "mahi_arm":
            assert sum(lin["body"].values()) == 34888 * B
    counts = {}
    for integrator in ("euler", "rk4"):
        prob, p, _ = _ltv_case((8, 4), integrator, "float64")
        counts[integrator] = lz.count_ltv_discrete_ops(prob, p)
    euler, rk4 = counts["euler"]["body"], counts["rk4"]["body"]
    assert euler["div_sqrt"] == euler["transcendental"] == 0
    assert sum(euler.values()) == 7500 * B
    assert sum(counts["euler"]["minimum"].values()) == 4057 * B
    assert 3.5 < (rk4["add"] + rk4["mul"]) / (euler["add"] + euler["mul"]) \
        < 4.5


def test_unlowerable_model_takes_the_eager_route(monkeypatch):
    """A model the generator cannot lower (``atan``, outside its ops) and a
    model without lanes support take the eager route, decided before
    anything is built: the plain version, counted, and no library."""
    def arctan(x, u):
        return torch.stack([x[1], u[0] - torch.atan(x[0])])
    built = []
    monkeypatch.setattr(_build, "cpu_library",
                        lambda *a, **k: built.append(a) or 1 / 0)
    monkeypatch.setattr(_build, "cuda_build",
                        lambda *a, **k: built.append(a) or 1 / 0)
    pend = make_dynamics("pendulum")
    for dyn in (Dynamics("user_atan", 2, 1, arctan, supports_lanes=True),
                Dynamics("per_instance", 2, 1, pend.f)):
        assert model_kernel(dyn) is None
        x0 = torch.tensor([[0.3, -0.1], [-0.2, 0.4]])
        u0 = torch.tensor([[0.5], [-0.5]])
        calls = lz.linearize_batch_plain.calls
        A, Bm, xd0 = lz.linearize_batch(dyn, x0, u0)
        assert lz.linearize_batch_plain.calls == calls + 1
        assert A.shape == (2, 2, 2) and Bm.shape == (2, 2, 1)
    assert built == []


# ---- the slice: the LTV service with the g++ bodies ----------------------------

PB, PN = 8, 20


def _pend_mp(cls):
    return cls("ltv_svc", num_x=2, num_u=1, step_size=0.05,
               num_shooting_nodes=PN, u_min=[-8.0], u_max=[8.0],
               dynamics_name="pendulum", is_linear=True)


def _gxx_fused(prob, p, X0=None, U0=None, opts=SolverOptions(), mu0=None,
               n_iter=None, ls_fan=None, adaptive=False):
    """``solve_batch_fused`` on the g++ bodies: the fused kernel's
    one-thread body fed by the discretization kernel's."""
    bits = "f32" if p.x0.dtype == torch.float32 else "f64"
    fn = getattr(_build.cpu_library(kernel_target(prob).generated
                                    or "fused_sqp"),
                 f"mpc_fused_solve_cpu_{bits}")
    return fused._solve(prob, p, X0, U0, opts, mu0, n_iter, ls_fan, adaptive,
                        fused._prepare_cpu,
                        functools.partial(fused._run_cpu, fn),
                        lz.ltv_discrete_cpu_kernel)


def test_ltv_service_on_gxx_bodies_matches_jax(monkeypatch):
    """The LTV service on the fused route with every kernel of its path
    built by g++ (the linearization, the discretization, the fused body)
    against the JAX LTV service, 1 cold + 1 warm step of the pendulum's
    closed loop (float64, tol 1e-6): statuses equal, controls within atol
    1e-3 (``test_ltv_service_matches_jax``'s band), each step frozen at its
    measured state; no plain version is called on the port's path."""
    monkeypatch.setattr(batch_service, "linearize_batch",
                        lz.linearize_batch_cpu_kernel)
    monkeypatch.setattr(batch_service, "solve_batch_fused", _gxx_fused)
    opts = dict(tol=1e-6, max_iter=60, dtype="float64")
    weights = dict(Q=[20.0, 0.5], R=[0.05], Rm=[0.0])
    svc = BatchModelControl(_pend_mp(ModelParameters), batch=PB,
                            device="cpu", **weights,
                            opts=SolverOptions(warm_solver="fused",
                                               fixed_warm_iters=0, **opts))
    jsvc = JaxBatchModelControl(_pend_mp(JaxModelParameters), batch=PB,
                                opts=JaxSolverOptions(**opts), **weights)
    assert svc.warm_solver == "fused"
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.5, 0.5, (PB, 2))
    x_des = np.zeros((PB, PN, 2))
    x_des[:, :, 0] = rng.uniform(-0.6, 0.6, PB)[:, None]
    plant = rk4_step(make_dynamics("pendulum").f, 0.05)
    calls = (lz.linearize_batch_plain.calls, lz.ltv_discrete_plain.calls)
    for s in (svc, jsvc):
        s.set_references(x_des)
    for _ in range(2):
        svc.set_states(x)
        jsvc.set_states(x)
        u, ju = svc.step().numpy(), np.asarray(jsvc.step())
        np.testing.assert_array_equal(np.asarray(svc.last.status),
                                      np.asarray(jsvc.last.status))
        assert (np.asarray(svc.last.status) == 0).all()
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(svc._p.lin.x0.numpy(), x)
        x = plant(torch.tensor(x).T, torch.tensor(u).T).T.numpy()
    assert (lz.linearize_batch_plain.calls,
            lz.ltv_discrete_plain.calls) == calls
