"""The port's lanes-batched SQP against the JAX package's: defects and
stage Jacobians (both linearize modes), and whole solves on the pendulum
(tests/test_pallas_riccati.py:60-91's setup) and on the double pendulum
with binding velocity bounds (tests/test_state_bounds.py's bounded
batch), in float64 and float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver import batched as jb
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver import batched as tb
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

VLIM = 1.0
SETUPS = {
    # name: (model, B, N, dt, ModelParameters bounds, q, r, rm, x0 scale,
    #        x_des scale, SolverOptions)
    "pendulum": ("pendulum", 3, 8, 0.05, dict(u_min=[-4.0], u_max=[4.0]),
                 1.0, 1.0, 1.0, 0.3, 0.3, dict(tol=1e-4, max_iter=20)),
    "double_pendulum_vbounds": (
        "double_pendulum", 8, 12, 0.01,
        dict(u_min=[-40.0] * 2, u_max=[40.0] * 2,
             x_min=[-np.inf, -np.inf, -VLIM, -VLIM],
             x_max=[np.inf, np.inf, VLIM, VLIM]),
        10.0, 0.5, 0.01, 0.2, 1.2, dict(tol=1e-4, max_iter=60)),
}


def _setup(name, dtype, seed=0):
    """The same problem and batch in both packages, from one numpy seed."""
    model, B, N, dt, bounds, q, r, rm, sx, sd, _ = SETUPS[name]
    kw = dict(num_x=None, num_u=None, step_size=dt, num_shooting_nodes=N,
              dynamics_name=model, **bounds)
    jdyn, dyn = jax_make_dynamics(model), make_dynamics(model)
    kw.update(num_x=dyn.nx, num_u=dyn.nu)
    jmp = JaxModelParameters(name, **kw)
    jprob = jax_make_problem(jmp, jdyn)
    prob = make_problem(ModelParameters(name, **kw), dyn)
    rng = np.random.default_rng(seed)
    jd = getattr(jnp, dtype)
    p = jax_default_params(jmp, dtype=jd)
    p = p._replace(q=jnp.full((dyn.nx,), q, jd), r=jnp.full((dyn.nu,), r, jd),
                   rm=jnp.full((dyn.nu,), rm, jd))
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    p = p._replace(
        x0=jnp.asarray(sx * rng.standard_normal((B, dyn.nx)), jd),
        x_des=jnp.asarray(sd * rng.standard_normal((B, N, dyn.nx)), jd))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu",
                           dtype=getattr(torch, dtype))
    return jprob, prob, p, tp


@pytest.mark.parametrize("model", ["pendulum", "double_pendulum"])
@pytest.mark.parametrize("mode", ["fan", "rev"])
def test_defects_and_linearize_match_jax(model, mode):
    """_defects_lanes and _linearize_lanes at random iterates, float64
    1e-10, for the unit-tangent fan and the second-order reverse rows."""
    name = "pendulum" if model == "pendulum" else "double_pendulum_vbounds"
    jprob, prob, _, _ = _setup(name, "float64")
    B, N = SETUPS[name][1], SETUPS[name][2]
    rng = np.random.default_rng(1)
    X = rng.standard_normal((B, N + 1, prob.nx)) * 0.5
    U = rng.standard_normal((B, N, prob.nu)) * 2.0
    tX, tU = torch.tensor(X), torch.tensor(U)
    np.testing.assert_allclose(
        tb._defects_lanes(prob, tX, tU).numpy(),
        np.asarray(jb._defects_lanes(jprob, jnp.asarray(X), jnp.asarray(U))),
        rtol=0, atol=1e-10)
    got = tb._linearize_lanes(prob, tX, tU, mode=mode)
    ref = jb._linearize_lanes(jprob, jnp.asarray(X), jnp.asarray(U),
                              mode=mode)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)


def test_linearize_mode_checks():
    _, prob, _, _ = _setup("pendulum", "float64")
    X, U = torch.zeros(3, 9, 2, dtype=torch.float64), \
        torch.zeros(3, 8, 1, dtype=torch.float64)
    with pytest.raises(ValueError):
        tb._linearize_lanes(prob, X, U, mode="sideways")
    rk4 = dataclasses.replace(prob, integrator="rk4")
    with pytest.raises(ValueError):
        tb._linearize_lanes(rk4, X, U, mode="rev")


@pytest.fixture(scope="module", params=[
    ("pendulum", "float64"), ("pendulum", "float32"),
    ("double_pendulum_vbounds", "float64"),
    ("double_pendulum_vbounds", "float32")], ids=lambda v: "-".join(v))
def solve_pair(request):
    """JAX and port cold solves of the same batch (scan KKT backend)."""
    name, dtype = request.param
    jprob, prob, p, tp = _setup(name, dtype)
    okw = SETUPS[name][-1]
    rj = jb.solve_batch_lanes(jprob, p, opts=JaxSolverOptions(
        dtype=dtype, kkt_backend="riccati", **okw))
    rt = tb.solve_batch_lanes(prob, tp, opts=SolverOptions(
        dtype=dtype, kkt_backend="riccati", **okw))
    return name, dtype, jax.tree.map(np.asarray, rj), rt


def test_solve_matches_jax(solve_pair):
    """float64: equal statuses and iterations, X and U at atol 1e-7.
    float32: equal statuses, iterations within +-1, X and U at atol 1e-3
    (the fused solve's adaptive band: a halving rung can flip on
    roundoff)."""
    name, dtype, rj, rt = solve_pair
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    tol = 1e-7 if dtype == "float64" else 1e-3
    if dtype == "float64":
        np.testing.assert_array_equal(rt.iters.numpy(), rj.iters)
    else:
        assert np.abs(rt.iters.numpy() - rj.iters).max() <= 1
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=tol)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=tol)
    np.testing.assert_allclose(rt.obj.numpy(), rj.obj, rtol=1e-5)
    assert (rj.status == 0).mean() >= 0.75
    if name.startswith("double"):
        # the velocity bounds hold and bind somewhere in the batch
        v = np.abs(rt.X.numpy()[:, 1:, 2:])
        assert v.max() <= VLIM + 1e-6 and v.max() > VLIM - 5e-2


@pytest.mark.parametrize("name", list(SETUPS))
def test_kernel_backend_matches_scan(name):
    """kkt_backend="pallas" (the Riccati kernel's plain version on CPU
    tensors) against the scan through the whole float32 SQP, at
    tests/test_pallas_riccati.py:89-91's bands."""
    _, prob, _, tp = _setup(name, "float32")
    okw = SETUPS[name][-1]
    a = tb.solve_batch_lanes(prob, tp, opts=SolverOptions(
        kkt_backend="riccati", **okw))
    b = tb.solve_batch_lanes(prob, tp, opts=SolverOptions(
        kkt_backend="pallas", **okw))
    np.testing.assert_array_equal(b.status.numpy(), a.status.numpy())
    ok = (a.status == 0).numpy()
    assert ok.mean() >= 0.75
    np.testing.assert_allclose(b.U.numpy()[ok], a.U.numpy()[ok], rtol=5e-3,
                               atol=5e-4)


@pytest.mark.parametrize("kkt_backend", ["riccati", "pallas"])
def test_ltv_mode_matches_jax(kkt_backend):
    """LTV mode on the pendulum setup, frozen at each instance's x0 and a
    random previous control: the port (scan, or the Riccati kernel's plain
    version) against the JAX lanes LTV solve with the scan, float32: equal
    statuses, iterations within +-1, X and U at atol 1e-3."""
    jprob, prob, p, tp = _setup("pendulum", "float32")
    jprob = dataclasses.replace(jprob, is_linear=True)
    prob = dataclasses.replace(prob, is_linear=True)
    u0 = jnp.asarray(np.random.default_rng(9).standard_normal((3, 1)),
                     jnp.float32)
    A, Bm, xd0 = jax.vmap(jprob.dynamics.linearize)(p.x0, u0)
    p = p._replace(u_prev=u0, lin=type(p.lin)(A, Bm, xd0, p.x0, u0))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    okw = SETUPS["pendulum"][-1]
    rj = jax.tree.map(np.asarray, jb.solve_batch_lanes(
        jprob, p, opts=JaxSolverOptions(kkt_backend="riccati", **okw)))
    rt = tb.solve_batch_lanes(prob, tp, opts=SolverOptions(
        kkt_backend=kkt_backend, **okw))
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    assert (rj.status == 0).all()
    assert np.abs(rt.iters.numpy() - rj.iters).max() <= 1
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=1e-3)
