"""The port's batched MPC service on the CPU (plain PyTorch fused solve):
closed loop, failure isolation, and checkpoints shared with the JAX
package's ``BatchModelControl``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.runtime import BatchModelControl as JaxBatchModelControl
from mahi_mpc_tpu.solver.fused import solve_batch_fused as jax_solve_fused
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics, rk4_step
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused

torch.set_num_threads(1)

B, N = 8, 8
TOL = 1e-4
Q, R, RM = [10.0] * 4 + [1.0] * 4, [0.1] * 4, [0.01] * 4


def _mp(cls, dt=0.002):
    return cls("bsvc", num_x=8, num_u=4, step_size=dt, num_shooting_nodes=N,
               u_min=[-20.0] * 4, u_max=[20.0] * 4, dynamics_name="mahi_arm")


def _service(dt=0.002, **opts):
    return BatchModelControl(
        _mp(ModelParameters, dt), batch=B, device="cpu",
        opts=SolverOptions(tol=TOL, max_iter=30, warm_solver="fused",
                           **opts), Q=Q, R=R, Rm=RM)


@pytest.mark.parametrize("fixed_warm_iters", [0, 3])
def test_closed_loop_converges(fixed_warm_iters):
    """10 receding-horizon steps against an RK4 plant: every solve
    converges and every instance moves toward its goal posture."""
    dt = 0.005
    svc = _service(dt, fixed_warm_iters=fixed_warm_iters)
    dyn = make_dynamics("mahi_arm")
    plant = rk4_step(dyn.f, dt)
    rng = np.random.default_rng(0)
    goals = rng.uniform(-0.3, 0.3, (B, 4))
    x_des = np.zeros((B, N, 8))
    x_des[:, :, :4] = goals[:, None]
    svc.set_references(x_des)
    x = torch.zeros(B, 8)
    err0 = np.abs(goals).max(axis=1)
    u = None
    for _ in range(10):
        svc.set_states(x, u_prev=u)
        u = svc.step()
        assert u.shape == (B, 4) and bool(torch.isfinite(u).all())
        assert svc.metrics()["converged_frac"] > 0.9, svc.metrics()
        x = plant(x.T, u.T).T
    err = np.abs(x[:, :4].numpy() - goals).max(axis=1)
    assert (err < err0).all(), (err, err0)
    m = svc.metrics()
    assert m["batch"] == B and m["solves_per_s"] > 0
    assert m["mean_iters"] == 3.0 if fixed_warm_iters else m["mean_iters"] >= 1


def test_failure_isolation_nan_instance():
    """A poisoned instance (NaN state) does not corrupt the others, keeps
    its previous plan as warm start, returns a zero control, and recovers
    once its state is healthy."""
    svc = _service()
    x = np.zeros((B, 8))
    x[3] = np.nan
    x_des = np.zeros((B, N, 8))
    x_des[:, :, 0] = 0.3
    svc.set_references(x_des)
    svc.set_states(x)
    u = svc.step()
    assert bool(torch.isfinite(u).all()), u
    assert bool((u[3] == 0).all())
    status = svc.last.status.numpy()
    assert status[3] == 2
    assert (status[[0, 1, 2, 4, 5, 6, 7]] == 0).all(), status
    assert bool((svc.state_dict()["X"][3] == 0).all())   # plan kept
    x[3] = 0.0
    svc.set_states(x)
    u = svc.step()
    assert bool(torch.isfinite(u).all())
    assert (svc.last.status.numpy() == 0).all()


def test_checkpoint_roundtrip():
    """state_dict -> load_state into a fresh service gives the identical
    next step."""
    svc = _service(fixed_warm_iters=3)
    rng = np.random.default_rng(1)
    svc.set_states(0.1 * rng.standard_normal((B, 8)))
    svc.set_references(0.1 * rng.standard_normal((B, N, 8)))
    svc.step()
    svc2 = _service(fixed_warm_iters=3)
    svc2.load_state(svc.state_dict())
    np.testing.assert_array_equal(svc.step().numpy(), svc2.step().numpy())


@pytest.fixture(scope="module")
def jax_service():
    """A JAX service configured (states, references, weights) but never
    stepped."""
    jsvc = JaxBatchModelControl(
        _mp(JaxModelParameters), batch=B,
        opts=JaxSolverOptions(tol=TOL, max_iter=30, dtype="float32"))
    rng = np.random.default_rng(2)
    jsvc.set_states(0.2 * rng.standard_normal((B, 8)))
    jsvc.set_references(0.2 * rng.standard_normal((B, N, 8)))
    jsvc.update_weights(Q=Q, R=R, Rm=RM)
    return jsvc


def test_load_jax_state_then_cold_step_matches_jax(jax_service):
    """The JAX service's state_dict loads as it is; the port's cold step
    from it matches the JAX fused kernel's adaptive cold solve (interpret
    mode) on the same params, at the adaptive band: equal statuses, X and U
    at atol 1e-3."""
    st = jax_service.state_dict()
    svc = _service()
    svc.load_state(st)
    svc.step()
    rt = svc.last
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), st["params"])
    jopts = JaxSolverOptions(tol=TOL, max_iter=30, dtype="float32")
    rj = jax_solve_fused(
        jax_service.problem, p, jnp.asarray(st["X"]), jnp.asarray(st["U"]),
        jopts, mu0=jnp.asarray(jopts.mu_init, jnp.float32), adaptive=True,
        tile=(1, 8), interpret=True)
    rj = jax.tree.map(np.asarray, rj)
    np.testing.assert_array_equal(rt.status.numpy(), rj.status)
    assert (rj.status == 0).all()
    np.testing.assert_allclose(rt.X.numpy(), rj.X, rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt.U.numpy(), rj.U, rtol=0, atol=1e-3)


def test_port_state_loads_in_jax(jax_service):
    """The other direction: the port's state_dict loads into the JAX
    service, field for field."""
    svc = _service()
    svc.load_state(jax_service.state_dict())
    svc.update_weights(Q=[5.0] * 8)
    st = svc.state_dict()
    jsvc = JaxBatchModelControl(
        _mp(JaxModelParameters), batch=B,
        opts=JaxSolverOptions(tol=TOL, max_iter=30, dtype="float32"))
    jsvc.load_state(st)
    back = jsvc.state_dict()
    for a, b in zip(jax.tree.leaves(back["params"]),
                    jax.tree.leaves(tuple(st["params"]))):
        np.testing.assert_array_equal(a, b)
    assert np.asarray(back["params"].q)[0, 0] == 5.0


def test_other_devices_raise():
    """No silent fallback: a device the solve has no path for raises, and
    the service refuses solvers that are not ported."""
    svc = _service()
    p = svc._p._replace(x0=svc._p.x0.to("meta"))
    with pytest.raises(ValueError):
        solve_batch_fused(svc.problem, p)
    with pytest.raises(NotImplementedError):
        BatchModelControl(_mp(ModelParameters), batch=B, device="cpu")
