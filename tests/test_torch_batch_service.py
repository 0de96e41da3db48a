"""The port's batched MPC service on the CPU: the fused route (plain
PyTorch fused solve) and the lanes route (lanes SQP), closed loop, failure
isolation, and checkpoints and steps against the JAX package's
``BatchModelControl``."""

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
from mahi_mpc_tpu.solver.fused import solve_batch_fused as jax_solve_fused
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics, rk4_step
from mahi_mpc_tpu_torch.models.base import Dynamics
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
    assert m["batch"] == B and m["solve_s"] > 0
    assert m["mean_iters"] == 3.0 if fixed_warm_iters else m["mean_iters"] >= 1


def test_failure_isolation_nan_instance():
    """A poisoned instance (NaN state) does not corrupt the others, returns
    a zero control, and recovers once its state is healthy."""
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


def test_default_device_is_the_card():
    """The service's entry point runs on the CUDA card unless the caller
    asks for the CPU: the default device is "cuda", which raises a clear
    error on a machine without a card instead of falling back to the CPU;
    device="cpu" runs the plain versions."""
    import inspect
    assert inspect.signature(BatchModelControl).parameters["device"] \
        .default == "cuda"
    mp = _mp(ModelParameters)
    if torch.cuda.is_available():
        assert BatchModelControl(mp, batch=B).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            BatchModelControl(mp, batch=B)
    svc = BatchModelControl(mp, batch=B, device="cpu",
                            opts=SolverOptions(tol=TOL, max_iter=30),
                            Q=Q, R=R, Rm=RM)
    assert svc.device.type == "cpu"
    svc.set_states(np.zeros((B, 8)))
    svc.set_references(np.full((B, N, 8), 0.1))
    u = svc.step()
    assert u.device.type == "cpu" and bool(torch.isfinite(u).all())


def test_other_devices_raise():
    """No silent fallback: a device the solve has no path for raises; the
    default options on the CPU resolve to the lanes route, for an LTV model
    as for a nonlinear one."""
    svc = _service()
    p = svc._p._replace(x0=svc._p.x0.to("meta"))
    with pytest.raises(ValueError):
        solve_batch_fused(svc.problem, p)
    lanes = BatchModelControl(_mp(ModelParameters), batch=B, device="cpu")
    assert lanes.warm_solver == "adaptive" and lanes.kkt_backend == "riccati"
    ltv = _mp(ModelParameters)
    ltv.is_linear = True
    lanes = BatchModelControl(ltv, batch=B, device="cpu")
    assert lanes.warm_solver == "adaptive" and lanes.kkt_backend == "riccati"


# ---------------------------------------------------------------------------
# The lanes route (solve_batch_lanes), on the JAX package's own service
# config: the pendulum of tests/test_batch_service.py:15-22.
# ---------------------------------------------------------------------------

PB, PN = 8, 20


def _pend_mp(cls):
    return cls("bsvc", num_x=2, num_u=1, step_size=0.05,
               num_shooting_nodes=PN, u_min=[-8.0], u_max=[8.0],
               dynamics_name="pendulum")


def _pend_service(batch=PB):
    return BatchModelControl(_pend_mp(ModelParameters), batch=batch,
                             device="cpu",
                             opts=SolverOptions(tol=1e-4, max_iter=40),
                             Q=[20.0, 0.5], R=[0.05], Rm=[0.0])


def _jax_pend_service(batch=PB):
    return JaxBatchModelControl(_pend_mp(JaxModelParameters), batch=batch,
                                opts=JaxSolverOptions(tol=1e-4, max_iter=40),
                                Q=[20.0, 0.5], R=[0.05], Rm=[0.0])


def _pend_goals(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (batch, 2))
    goals = rng.uniform(-0.6, 0.6, batch)
    x_des = np.zeros((batch, PN, 2))
    x_des[:, :, 0] = goals[:, None]
    return x, goals, x_des


def test_lanes_service_closed_loop():
    """tests/test_batch_service.py:25-44 through the port: 16 pendulums,
    200 receding-horizon steps against an RK4 plant; converged_frac > 0.9
    and every instance regulated to its own goal."""
    Bp = 16
    svc = _pend_service(Bp)
    assert svc.warm_solver == "adaptive" and svc.kkt_backend == "riccati"
    plant = rk4_step(make_dynamics("pendulum").f, 0.05)
    x, goals, x_des = _pend_goals(Bp)
    svc.set_references(x_des)
    x = torch.tensor(x, dtype=torch.float32)
    for _ in range(200):
        svc.set_states(x)
        u = svc.step()
        x = plant(x.T, u.T).T
    m = svc.metrics()
    assert m["converged_frac"] > 0.9, m
    err = np.abs(x[:, 0].numpy() - goals)
    assert err.max() < 0.15, err


def _repair_sequence(svc, x_des, to_u):
    """Step 1 healthy, step 2 with instance 3 NaN, step 3 healthy again;
    returns (state_dict, statuses, controls) after each step."""
    x = np.full((PB, 2), 0.1)
    x[:, 0] = np.linspace(-0.3, 0.3, PB)
    svc.set_references(x_des)
    out = []
    for poison in (False, True, False):
        xs = x.copy()
        if poison:
            xs[3] = np.nan
        svc.set_states(xs)
        u = to_u(svc.step())
        out.append((svc.state_dict(), np.asarray(svc.last.status), u))
    return out


def _port_sequence(svc):
    return _repair_sequence(svc, _pend_goals(PB)[2],
                            lambda u: u.numpy())


@pytest.fixture(scope="module")
def jax_repair():
    jsvc = _jax_pend_service()
    return _repair_sequence(jsvc, _pend_goals(PB)[2], np.asarray)


@pytest.mark.parametrize("route", ["fused", "lanes"])
def test_failed_instance_restarts_from_zero(route):
    """After a failure the instance's X and U warm start is zero (it
    re-solves from scratch, as in the JAX package) and its control is
    zero; the others keep their new plans; the next healthy step
    recovers it."""
    if route == "fused":
        svc = _service()
        x_des = np.zeros((B, N, 8))
        x_des[:, :, 0] = 0.3
        x = np.zeros((B, 8))
        steps = []
        svc.set_references(x_des)
        for poison in (False, True, False):
            xs = x.copy()
            if poison:
                xs[3] = np.nan
            svc.set_states(xs)
            u = svc.step().numpy()
            steps.append((svc.state_dict(), svc.last.status.numpy(), u,
                          svc.last))
    else:
        svc = _pend_service()
        steps = [s + (None,) for s in _port_sequence(svc)]
    st1, stat1, _, _ = steps[0]
    assert (stat1 == 0).all()
    assert np.abs(st1["X"][3]).max() > 0          # a real plan to lose
    st2, stat2, u2, _ = steps[1]
    assert stat2[3] == 2 and (np.delete(stat2, 3) == 0).all()
    assert (st2["X"][3] == 0).all() and (st2["U"][3] == 0).all()
    assert (u2[3] == 0).all() and np.isfinite(u2).all()
    healthy = np.arange(len(stat2)) != 3
    if route == "fused":
        np.testing.assert_array_equal(st2["X"][healthy],
                                      steps[1][3].X.numpy()[healthy])
    _, stat3, u3, _ = steps[2]
    assert (stat3 == 0).all() and np.isfinite(u3).all()


def test_repair_sequence_matches_jax(jax_repair):
    """The same three steps through the JAX service (lanes route on both
    sides): statuses equal and state_dict X, U at the float32 lanes band
    (atol 1e-3) after every step, the failed instance's zeros included."""
    ours = _port_sequence(_pend_service())
    for (st, stat, u), (jst, jstat, ju) in zip(ours, jax_repair):
        np.testing.assert_array_equal(stat, jstat)
        for k in ("X", "U"):
            np.testing.assert_allclose(st[k], jst[k], rtol=0, atol=1e-3)
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-3)
    assert (jax_repair[1][0]["X"][3] == 0).all()


def test_lanes_service_steps_match_jax():
    """The port's and the JAX service stepped side by side for 5 closed-loop
    steps on identical states: controls at atol 1e-3, statuses equal."""
    svc, jsvc = _pend_service(), _jax_pend_service()
    x, _, x_des = _pend_goals(PB, seed=4)
    for s in (svc, jsvc):
        s.set_references(x_des)
    plant = rk4_step(make_dynamics("pendulum").f, 0.05)
    for _ in range(5):
        svc.set_states(x)
        jsvc.set_states(x)
        u, ju = svc.step().numpy(), np.asarray(jsvc.step())
        np.testing.assert_array_equal(svc.last.status.numpy(),
                                      np.asarray(jsvc.last.status))
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-3)
        x = plant(torch.tensor(x).T, torch.tensor(ju).T).T.numpy()


def test_jax_pendulum_state_loads(jax_repair):
    """A JAX pendulum service's state_dict loads as it is (params, plan,
    warm flag), and the port steps on from it."""
    jst = jax_repair[-1][0]
    svc = _pend_service()
    svc.load_state(jst)
    st = svc.state_dict()
    for k in ("X", "U"):
        np.testing.assert_array_equal(st[k], jst[k])
    for a, b in zip(jax.tree.leaves(tuple(st["params"])),
                    jax.tree.leaves(jst["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert st["warm"] is True
    u = svc.step()
    assert bool(torch.isfinite(u).all()) and (svc.last.status == 0).all()


# ---------------------------------------------------------------------------
# LTV mode (reference C8): relinearize at every step, on both routes.
# ---------------------------------------------------------------------------

def _ltv_pend_mp(cls):
    mp = _pend_mp(cls)
    mp.is_linear = True
    return mp


def _ltv_closed_loop(svc, to_u, steps=3):
    """1 cold + (steps - 1) warm steps on the pendulum closed loop (RK4
    plant, the same states fed to any service); returns (statuses,
    controls, lin.x0) after each step."""
    x, _, x_des = _pend_goals(PB, seed=6)
    svc.set_references(x_des)
    plant = rk4_step(make_dynamics("pendulum").f, 0.05)
    out = []
    for _ in range(steps):
        svc.set_states(x)
        u = to_u(svc.step())
        out.append((np.asarray(svc.last.status), u,
                    np.asarray(svc._p.lin.x0)))
        x = plant(torch.tensor(x).T, torch.tensor(u).T).T.numpy()
    return out


def test_ltv_service_matches_jax():
    """The LTV service side by side with the JAX one over 1 cold and 2 warm
    steps (both on their CPU default, the lanes route): statuses equal,
    controls at the float32 lanes band (atol 1e-3), and each step's
    linearization frozen at that step's measured state."""
    svc = BatchModelControl(_ltv_pend_mp(ModelParameters), batch=PB,
                            device="cpu",
                            opts=SolverOptions(tol=1e-4, max_iter=40),
                            Q=[20.0, 0.5], R=[0.05], Rm=[0.0])
    jsvc = JaxBatchModelControl(_ltv_pend_mp(JaxModelParameters), batch=PB,
                                opts=JaxSolverOptions(tol=1e-4, max_iter=40),
                                Q=[20.0, 0.5], R=[0.05], Rm=[0.0])
    assert svc.warm_solver == "adaptive"
    ours = _ltv_closed_loop(svc, lambda u: u.numpy())
    theirs = _ltv_closed_loop(jsvc, np.asarray)
    for (stat, u, lx0), (jstat, ju, jlx0) in zip(ours, theirs):
        np.testing.assert_array_equal(stat, jstat)
        assert (stat == 0).all()
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-3)
        np.testing.assert_allclose(lx0, jlx0, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ours[-1][2], svc._p.x0.numpy())


def test_ltv_fused_route_closed_loop():
    """The fused route in LTV mode (warm_solver="fused": the plain version
    on the CPU) on the 4-DOF arm: a cold adaptive step and three fixed-3
    warm steps, each after a relinearization at the measured state, against
    the lanes route on the same states: every solve converges, controls at
    the fused-vs-lanes LTV bands of tests/test_fused_adaptive.py:113-133
    (cold atol 5e-3, warm atol 1e-3)."""
    def service(**kw):
        mp = _mp(ModelParameters)
        mp.is_linear = True
        return BatchModelControl(mp, batch=B, device="cpu", Q=Q, R=R, Rm=RM,
                                 opts=SolverOptions(tol=TOL, max_iter=30,
                                                    **kw))
    fused = service(warm_solver="fused", fixed_warm_iters=3)
    lanes = service()
    assert (fused.warm_solver, lanes.warm_solver) == ("fused", "adaptive")
    rng = np.random.default_rng(3)
    x = torch.tensor(0.2 * rng.standard_normal((B, 8)), dtype=torch.float32)
    x_des = 0.2 * rng.standard_normal((B, N, 8))
    plant = rk4_step(make_dynamics("mahi_arm").f, 0.002)
    u = None
    for step in range(4):
        for svc in (fused, lanes):
            svc.set_references(x_des)
            svc.set_states(x, u_prev=u)
        uf, ul = fused.step(), lanes.step()
        np.testing.assert_array_equal(fused._p.lin.x0.numpy(), x.numpy())
        assert (fused.last.status == 0).all() and (lanes.last.status == 0).all()
        np.testing.assert_allclose(uf.numpy(), ul.numpy(), rtol=0,
                                   atol=5e-3 if step == 0 else 1e-3)
        u = ul
        x = plant(x.T, u.T).T
    assert fused.last.iters.tolist() == [3] * B


def test_ltv_state_dict_round_trip_with_jax():
    """An LTV JAX service's state_dict (with its per-instance frozen
    linearization) loads into the port as it is, the port's loads back into
    the JAX service field for field, and the port steps on from it."""
    jsvc = JaxBatchModelControl(_ltv_pend_mp(JaxModelParameters), batch=PB,
                                opts=JaxSolverOptions(tol=1e-4, max_iter=40),
                                Q=[20.0, 0.5], R=[0.05], Rm=[0.0])
    x, _, x_des = _pend_goals(PB, seed=8)
    jsvc.set_references(x_des)
    jsvc.set_states(x)
    jsvc.step()
    jst = jsvc.state_dict()
    assert np.asarray(jst["params"].lin.A).shape == (PB, 2, 2)
    svc = BatchModelControl(_ltv_pend_mp(ModelParameters), batch=PB,
                            device="cpu",
                            opts=SolverOptions(tol=1e-4, max_iter=40))
    svc.load_state(jst)
    st = svc.state_dict()
    for a, b in zip(jax.tree.leaves(tuple(st["params"])),
                    jax.tree.leaves(jst["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    jsvc2 = JaxBatchModelControl(_ltv_pend_mp(JaxModelParameters), batch=PB,
                                 opts=JaxSolverOptions(tol=1e-4, max_iter=40))
    jsvc2.load_state(st)
    for a, b in zip(jax.tree.leaves(jsvc2.state_dict()["params"]),
                    jax.tree.leaves(jst["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    u = svc.step()
    assert bool(torch.isfinite(u).all()) and (svc.last.status == 0).all()


# ---------------------------------------------------------------------------
# Dynamics without lanes support: the JAX service serves them through
# jax.vmap(solve) (mahi_mpc_tpu/runtime/batch_service.py:74-82).
# ---------------------------------------------------------------------------

def test_non_lanes_dynamics_served_as_jax():
    """A user model written per instance (the pendulum's f in a Dynamics
    with supports_lanes=False) through 1 cold and 2 warm steps of the
    port's service and the JAX one, float64, on the same numpy inputs:
    statuses equal, controls and planned U within 1e-6."""
    opts = dict(tol=1e-6, max_iter=40, dtype="float64")
    weights = dict(Q=[20.0, 0.5], R=[0.05], Rm=[0.0])
    svc = BatchModelControl(
        _pend_mp(ModelParameters), batch=PB, device="cpu",
        dynamics=Dynamics("pend_nl", nx=2, nu=1,
                          f=make_dynamics("pendulum").f),
        opts=SolverOptions(**opts), **weights)
    jsvc = JaxBatchModelControl(
        _pend_mp(JaxModelParameters), batch=PB,
        dynamics=JaxDynamics("pend_nl", nx=2, nu=1,
                             f=jax_make_dynamics("pendulum").f),
        opts=JaxSolverOptions(**opts), **weights)
    assert svc.warm_solver == "adaptive" and svc.kkt_backend == "riccati"
    x, _, x_des = _pend_goals(PB, seed=10)
    plant = rk4_step(make_dynamics("pendulum").f, 0.05)
    for s in (svc, jsvc):
        s.set_references(x_des)
    for _ in range(3):
        svc.set_states(x)
        jsvc.set_states(x)
        u, ju = svc.step().numpy(), np.asarray(jsvc.step())
        stat = svc.last.status.numpy()
        np.testing.assert_array_equal(stat, np.asarray(jsvc.last.status))
        assert (stat == 0).all()
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-6)
        np.testing.assert_allclose(svc.last.U.numpy(),
                                   np.asarray(jsvc.last.U), rtol=0,
                                   atol=1e-6)
        x = plant(torch.tensor(x).T, torch.tensor(ju).T).T.numpy()
