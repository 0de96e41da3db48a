"""The port's single-instance runtime on the CPU: ``ModelControl`` beside
the JAX package's over the same cold and warm ``calc_u`` sequence, the
generator and its manifest (and a directory the JAX package generated),
the solver thread and its fallback counters, the plan, the native plan
server and the results log, and the example scripts."""

import json
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.runtime import ModelControl as JaxModelControl
from mahi_mpc_tpu.runtime import generate_model as jax_generate_model
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.runtime import (ModelControl, ModelGenerator, Plan,
                                        empty_plan, generate_model)
from mahi_mpc_tpu_torch.runtime.generate import (kernel_libraries,
                                                 read_manifest)
from mahi_mpc_tpu_torch.runtime.native import (NativePacer,
                                               NativePlanServer,
                                               native_available)
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem
from mahi_mpc_tpu_torch.utils import ControlLog

torch.set_num_threads(1)

N = 10
WEIGHTS = dict(Q=[20.0, 1.0], R=[0.5], Rm=[0.0])


def _mp(cls, name="pend", is_linear=False):
    return cls(name, num_x=2, num_u=1, step_size=0.02, num_shooting_nodes=N,
               u_min=[-8.0], u_max=[8.0], is_linear=is_linear,
               dynamics_name="pendulum")


def _traj(t):
    tt = t + (1 + np.arange(N)) * 0.02
    return np.stack([0.3 * np.sin(tt), 0.3 * np.cos(tt)], axis=1)


# One cold and three warm calc_u on a moving state, then (for the parity
# runs that ask) a weight update and a limit update, each followed by a
# cold-restarted solve.
SEQUENCE = [(0.0, [0.5, 0.0]), (0.02, [0.48, -0.1]), (0.04, [0.45, -0.2]),
            (0.06, [0.41, -0.25])]


def _drive(mc, mutate):
    plans = []
    for t, x in SEQUENCE:
        plans.append(mc.calc_u(t, x, [0.1], _traj(t)))
    if mutate:
        mc.update_weights(Q=[200.0, 1.0])
        plans.append(mc.calc_u(0.08, [0.38, -0.25], [0.1], _traj(0.08)))
        mc.update_control_limits([-2.0], [2.0])
        plans.append(mc.calc_u(0.1, [0.35, -0.25], [0.1], _traj(0.1)))
    return plans


# name -> (port/JAX options, linear flavour, mutate, X/U band, same iters)
PARITY = {
    "fixed": (dict(warm_solver="fixed", fixed_warm_iters=3,
                   dtype="float64", tol=1e-8), False, True, 1e-8, True),
    "adaptive": (dict(warm_solver="adaptive", dtype="float64", tol=1e-8),
                 False, True, 1e-8, True),
    "ltv": (dict(warm_solver="fixed", fixed_warm_iters=3, dtype="float64",
                 tol=1e-8), True, False, 1e-8, True),
    # The fused warm solve: the port's plain version against the JAX
    # Pallas kernel in interpret mode, float32, at the bands of
    # test_torch_fused_fixed.py (fixed-3) and test_torch_fused_adaptive.py
    # (adaptive); the cold solves before them at the float32 band.
    "fused_fixed3": (dict(warm_solver="fused", fixed_warm_iters=3,
                          tol=1e-4), False, False, 2e-5, False),
    "fused_adaptive": (dict(warm_solver="fused", tol=1e-4), False, False,
                       1e-3, False),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_model_control_matches_jax(case):
    """The port's ModelControl beside the JAX one over 1 cold and 3 warm
    calc_u (and, for "fixed" and "adaptive", a calc_u after update_weights
    and after update_control_limits): the same warm solver, equal
    statuses, equal iterations on the cold and warm sequence, and plans
    within the case's band.  The two solves after a mutation restart the
    barrier cold from a plan made for other weights or limits and finish
    at the float64 merit noise floor, where roundoff decides single
    line-search steps: their iteration counts may differ (15 and 17 for
    "fixed"), not their plans."""
    kw, linear, mutate, band, same_iters = PARITY[case]
    opts = dict(max_iter=40, **kw)
    mc = ModelControl(_mp(ModelParameters, is_linear=linear),
                      opts=SolverOptions(**opts), device="cpu", **WEIGHTS)
    jmc = JaxModelControl(_mp(JaxModelParameters, is_linear=linear),
                          opts=JaxSolverOptions(**opts), **WEIGHTS)
    assert mc.warm_solver == jmc.warm_solver
    ours, theirs = _drive(mc, mutate), _drive(jmc, mutate)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        # A fixed-iteration warm solve reports MAX_ITER (usable) unless its
        # last step already passed tol.
        assert a.status == b.status and a.status in (0, 1), \
            (k, a.status, b.status)
        if same_iters and k < len(SEQUENCE):
            assert a.iters == b.iters, (k, a.iters, b.iters)
        # Cold solves in float32 (the first) are held at the float32 band.
        tol = 1e-3 if (k == 0 and not same_iters) else band
        np.testing.assert_allclose(a.U, b.U, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(a.X, b.X, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(a.times, b.times, rtol=0, atol=1e-12)
    if kw.get("fixed_warm_iters"):
        assert [p.iters for p in ours[1:len(SEQUENCE)]] == [3] * 3
    if mutate:
        assert np.abs(ours[-1].U).max() <= 2.0 + 1e-9
        assert not np.allclose(ours[3].U, ours[4].U)
    s = mc.stats.summary()
    assert s["solves"] == len(ours) and s["failures"] == 0


def test_fused_warm_is_one_launch_at_batch_one(monkeypatch):
    """Warm solves with the fused warm solver go through solve_batch_fused
    once each, with a batch of one, n_iter = fixed_warm_iters; cold solves
    never do."""
    import mahi_mpc_tpu_torch.runtime.control as control
    calls = []
    real = control.solve_batch_fused

    def spy(prob, p, X0, U0, opts, **kw):
        calls.append((tuple(X0.shape), kw))
        return real(prob, p, X0, U0, opts, **kw)

    monkeypatch.setattr(control, "solve_batch_fused", spy)
    mc = ModelControl(_mp(ModelParameters), device="cpu", **WEIGHTS,
                      opts=SolverOptions(tol=1e-4, max_iter=40,
                                         warm_solver="fused",
                                         fixed_warm_iters=3))
    _drive(mc, mutate=False)
    assert calls == [((1, N + 1, 2), dict(mu0=mc._mu_warm, n_iter=3))] * 3


# ---- generator, manifest, loading ------------------------------------------

def test_generate_load_round_trip(tmp_path):
    """generate -> load by name with no dynamics in scope: the JSON (same
    schema as the JAX package's), the manifest of the options it was
    generated for, and a ModelControl that takes those options and plans
    as one built directly with them."""
    opts = SolverOptions(tol=1e-5, max_iter=40, warm_solver="fixed",
                         fixed_warm_iters=3)
    man = generate_model(_mp(ModelParameters, "gen_rt"), directory=tmp_path,
                         opts=opts, device="cpu")
    assert man == tmp_path / "gen_rt_torch.json"
    j = json.loads((tmp_path / "gen_rt.json").read_text())
    assert j["model"]["dynamics_name"] == "pendulum"
    assert j["model"]["dll_filepath"] == ""
    jmp = JaxModelParameters.load("gen_rt", tmp_path)
    assert jmp.num_shooting_nodes == N and jmp.u_max == [8.0]
    m = read_manifest("gen_rt", tmp_path)
    assert m["solver_options"] == opts and m["libraries"] == {}
    mc = ModelControl("gen_rt", directory=tmp_path, device="cpu", **WEIGHTS)
    assert mc.opts == opts and mc.warm_solver == "fixed"
    direct = ModelControl(_mp(ModelParameters, "gen_rt"), opts=opts,
                          device="cpu", **WEIGHTS)
    for a, b in zip(_drive(mc, False), _drive(direct, False)):
        np.testing.assert_array_equal(a.U, b.U)
        assert a.status == 0


def test_stale_options_gate(tmp_path, monkeypatch):
    """A model generated for the fused warm solve does not impose it: the
    options given at load time decide the warm solver (the JAX package's
    fault, control.py:181-201, not copied), and the manifest's options
    apply only when none are given.  On the card the generator builds the
    fused library the model launches, and the Riccati kernel's when asked
    for."""
    gen = ModelGenerator(_mp(ModelParameters, "gate"), device="cpu",
                         opts=SolverOptions(tol=1e-4, max_iter=40,
                                            warm_solver="fused",
                                            fixed_warm_iters=3))
    gen.compile_model(tmp_path)
    import mahi_mpc_tpu_torch.runtime.control as control
    real, calls = control.solve_batch_fused, []
    monkeypatch.setattr(control, "solve_batch_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    loaded = ModelControl("gate", directory=tmp_path, device="cpu",
                          **WEIGHTS)
    assert loaded.warm_solver == "fused"
    _drive(loaded, mutate=False)
    assert len(calls) == 3
    mc = ModelControl("gate", directory=tmp_path, device="cpu", **WEIGHTS,
                      opts=SolverOptions(tol=1e-4, max_iter=40))
    assert mc.warm_solver == "adaptive"
    plans = _drive(mc, mutate=False)
    assert all(p.status == 0 for p in plans) and len(calls) == 3
    prob = make_problem(_mp(ModelParameters), make_dynamics("pendulum"))
    auto = SolverOptions()
    assert kernel_libraries(prob, auto, "cuda") == ["fused_sqp_models"]
    assert kernel_libraries(prob, auto, "cpu") == []
    assert kernel_libraries(prob, SolverOptions(warm_solver="adaptive",
                                                kkt_backend="pallas"),
                            "cuda") == ["riccati"]


def test_jax_generated_directory_loads(tmp_path):
    """A directory the JAX package's generate_model wrote (JSON + .mpcx):
    the port ignores the .mpcx, rebuilds the model from its dynamics_name,
    and plans as the JAX ModelControl loaded from the same directory, to
    the float32 band."""
    jopts = JaxSolverOptions(tol=1e-5, max_iter=40)
    jax_generate_model(_mp(JaxModelParameters, "jgen"), directory=tmp_path,
                       opts=jopts)
    assert (tmp_path / "jgen.mpcx").is_file()
    assert read_manifest("jgen", tmp_path) is None
    mc = ModelControl("jgen", directory=tmp_path, device="cpu", **WEIGHTS,
                      opts=SolverOptions(tol=1e-5, max_iter=40))
    jmc = JaxModelControl("jgen", directory=tmp_path, **WEIGHTS)
    assert mc.warm_solver == jmc.warm_solver == "adaptive"
    for a, b in zip(_drive(mc, False), _drive(jmc, False)):
        assert a.status == b.status == 0
        np.testing.assert_allclose(a.U, b.U, rtol=0, atol=1e-3)


def test_card_by_default():
    """ModelControl and the generator run on the card unless the caller
    asks for the CPU: without one they raise, naming device="cpu"."""
    import inspect
    for fn in (ModelControl, ModelGenerator, generate_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ModelControl(_mp(ModelParameters))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        generate_model(_mp(ModelParameters))


# ---- the solver thread, fallback counters, the plan ------------------------

def test_solver_thread_and_zoh(tmp_path):
    """start_calc: the solver thread re-plans from the latest set_state
    while this thread reads control_at_time at ~1 kHz through the native
    server; every read after the first solve is the ZOH control of a
    published plan, and none is a placeholder or stale serve."""
    mc = ModelControl(_mp(ModelParameters), device="cpu", **WEIGHTS,
                      opts=SolverOptions(tol=1e-4, max_iter=40),
                      use_native_server=True)
    dyn = make_dynamics("pendulum")
    x = np.array([0.5, 0.0])
    mc.set_state(0.0, x, [0.0], _traj(0.0))
    mc.start_calc()
    try:
        deadline = time.time() + 30.0
        while mc.control_results().status == -1 and time.time() < deadline:
            time.sleep(0.005)
        assert mc.control_results().status != -1, "no solve in 30 s"
        reads = 0
        for k in range(200):
            t = k * 0.001
            u = mc.control_at_time(t)
            assert u.shape == (1,) and np.isfinite(u).all()
            xt = torch.tensor(x)
            x = (xt + 0.001 * dyn.f(xt, torch.tensor(u))).numpy()
            mc.set_state(t, x, u, _traj(t))
            reads += 1
            time.sleep(0.001)
    finally:
        mc.stop_calc()
    assert mc._calc_thread is None
    s = mc.stats.summary()
    assert s["solves"] >= 2 and s["failures"] == 0, s
    assert s["served_placeholder"] == 0 and s["served_stale"] == 0, s
    plan = mc.control_results()
    for t in (plan.times[0], plan.times[3] + 1e-3, plan.times[-1] + 1.0):
        np.testing.assert_array_equal(mc.control_at_time(t),
                                      plan.control_at_time(t))


def test_fallback_serves_are_counted():
    """Before the first solve control_at_time serves the placeholder
    (counted); a solve that fails (a NaN state) keeps the last plan served
    and counts stale serves; the next good solve clears it."""
    mc = ModelControl(_mp(ModelParameters), device="cpu", **WEIGHTS,
                      opts=SolverOptions(tol=1e-4, max_iter=40))
    assert mc.control_at_time(0.0).shape == (1,)
    mc.control_at_time(0.001)
    good = mc.calc_u(0.0, [0.5, 0.0], [0.0], _traj(0.0))
    bad = mc.calc_u(0.02, [np.nan, 0.0], [0.0], _traj(0.0))
    assert bad is good
    mc.control_at_time(0.03)
    s = mc.stats.summary()
    assert (s["served_placeholder"], s["served_stale"], s["failures"]) == \
        (2, 1, 1)
    mc.calc_u(0.04, [0.45, 0.0], [0.0], _traj(0.04))
    mc.control_at_time(0.05)
    assert mc.stats.summary()["served_stale"] == 1


def test_plan_zoh_and_empty_plan():
    """The port's Plan: ZOH lookup clamped at both ends, linear state
    interpolation, and a safe pre-first-solve placeholder."""
    plan = Plan(times=np.array([0.0, 0.1, 0.2]), X=np.array([[0.0], [1.0],
                                                             [3.0]]),
                U=np.array([[1.0], [2.0]]))
    assert plan.control_at_time(-5.0) == 1.0
    assert plan.control_at_time(0.05) == 1.0
    assert plan.control_at_time(0.15) == 2.0
    assert plan.control_at_time(9.0) == 2.0
    np.testing.assert_allclose(plan.state_at_time(0.15), [2.0])
    ep = empty_plan(2, 1, u_fallback=np.array([0.7]))
    assert ep.control_at_time(0.0) == 0.7 and ep.status == -1


# ---- the native plan server ------------------------------------------------

def test_native_zoh_parity_with_plan():
    assert native_available()
    nx, nu, Nn = 3, 2, 8
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.01, 0.1, Nn + 1))
    X = rng.standard_normal((Nn + 1, nx))
    U = rng.standard_normal((Nn, nu))
    plan = Plan(times=times, X=X, U=U)
    ps = NativePlanServer(nx, nu, Nn)
    assert ps.sample(0.0) is None
    ps.publish(times, X, U)
    for t in [times[0] - 1, times[0], (times[2] + times[3]) / 2, times[-1],
              times[-1] + 5]:
        np.testing.assert_array_equal(ps.sample(t), plan.control_at_time(t))
    with pytest.raises(ValueError):
        ps.publish(times[:-1], X, U)


def test_native_no_torn_reads():
    """Plans whose controls are all one value, published in a loop while
    this thread samples: a torn read would mix two values."""
    nx, nu, Nn = 2, 3, 5
    ps = NativePlanServer(nx, nu, Nn)
    times = np.arange(Nn + 1) * 0.1
    X = np.zeros((Nn + 1, nx))
    stop = threading.Event()

    def publisher():
        k = 0
        while not stop.is_set():
            ps.publish(times, X, np.full((Nn, nu), float(k)))
            k += 1

    th = threading.Thread(target=publisher)
    th.start()
    try:
        deadline = time.time() + 1.0
        while time.time() < deadline:
            u = ps.sample(0.25)
            if u is not None:
                assert (u == u[0]).all() and u[0] == int(u[0]), u
    finally:
        stop.set()
        th.join(5.0)
    assert not th.is_alive()
    assert ps.published_count > 100


def test_native_pacer():
    pc = NativePacer(0.002)
    t0 = time.perf_counter()
    for _ in range(50):
        pc.wait()
    el = time.perf_counter() - t0
    assert 0.09 <= el <= 0.4, el
    assert pc.misses <= 50 and pc.worst_late_s >= 0.0


# ---- results log and examples ----------------------------------------------

def test_control_log_exports(tmp_path):
    log = ControlLog()
    for k in range(5):
        log.append(0.01 * k, [k, -k], [0.5 * k], x_des=[1.0, 0.0],
                   solve_ms=1.0 + k, iters=3)
    csv = log.to_csv(tmp_path / "r.csv").read_text().splitlines()
    assert csv[0] == "t,x0,x1,u0,xdes0,xdes1,solve_ms,iters"
    assert len(csv) == 6
    d = np.load(log.to_npz(tmp_path / "r.npz"))
    np.testing.assert_array_equal(d["u"][:, 0], 0.5 * np.arange(5))
    rep = log.timing_report()
    assert rep["solves"] == 5 and rep["p50_ms"] == 3.0


def test_examples_run_on_cpu(tmp_path, capsys):
    """The examples, in-process with --device cpu: generate a double
    pendulum, run the synchronous loop (its tracking error stays bounded)
    and the threaded 1 kHz loop for 0.3 s."""
    from mahi_mpc_tpu_torch.examples import (model_control, model_generate,
                                             thread_model_control)
    d = str(tmp_path)
    model_generate.main(["--name", "dp", "--u-limit", "60", "--dt", "0.01",
                         "--nodes", "8", "--out", d, "--device", "cpu"])
    rep, err = model_control.main(["--name", "dp", "--dir", d, "--steps",
                                   "30", "--device", "cpu"])
    assert rep["solves"] == 6 and np.isfinite(err).all() and err.max() < 1.0
    s, _ = thread_model_control.main(["--name", "dp", "--dir", d,
                                      "--seconds", "0.3", "--device", "cpu",
                                      "--warm-solver", "fixed"])
    assert s["solves"] >= 1 and s["failures"] == 0
    assert "deadline misses" in capsys.readouterr().out


def test_runtime_imports_leave_jax_out():
    """The runtime, the native binding and the examples import neither jax
    nor mahi_mpc_tpu (a fresh interpreter)."""
    code = ("import sys, mahi_mpc_tpu_torch.runtime, "
            "mahi_mpc_tpu_torch.runtime.native, mahi_mpc_tpu_torch.utils, "
            "mahi_mpc_tpu_torch.examples.model_generate, "
            "mahi_mpc_tpu_torch.examples.model_control, "
            "mahi_mpc_tpu_torch.examples.thread_model_control; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mahi_mpc_tpu.')) or m == 'mahi_mpc_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
