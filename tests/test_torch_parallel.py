"""Scenario-batch meshes in the port (``mahi_mpc_tpu_torch/parallel/mesh.py``
and ``BatchModelControl(mesh=...)``), the counterparts of
tests/test_parallel.py: the JAX package runs on its 8-device CPU mesh, the
port on 8 logical shards of the one CPU; per-instance results must not
depend on how the batch is split."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.parallel import make_mesh as jax_make_mesh
from mahi_mpc_tpu.parallel import make_sharded_solver as jax_sharded_solver
from mahi_mpc_tpu.parallel import shard_params as jax_shard_params
from mahi_mpc_tpu.runtime import BatchModelControl as JaxBatchModelControl
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions, parallel
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.parallel import (make_fused_sharded_solver, make_mesh,
                                         make_sharded_solver, scaling_report,
                                         shard_params)
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.solver import solve_batch_fused, solve_batch_lanes
from mahi_mpc_tpu_torch.solver import fused as fused_mod
from mahi_mpc_tpu_torch.solver import riccati_kernel
from mahi_mpc_tpu_torch.solver.stage_qp import StageQP
from mahi_mpc_tpu_torch.transcribe.shooting import (default_params,
                                                    make_problem, map_params)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _np_batch(B, N, seed=0):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((B, 4)),
            0.2 * rng.standard_normal((B, N, 4)))


def _batch_problem(B=16, N=10):
    """tests/test_parallel.py:18-33's double-pendulum batch (float32)."""
    kw = dict(num_x=4, num_u=2, step_size=0.01, num_shooting_nodes=N,
              u_min=[-50.0] * 2, u_max=[50.0] * 2,
              dynamics_name="double_pendulum")
    x0, x_des = _np_batch(B, N)
    mp = ModelParameters("shard_dp", **kw)
    prob = make_problem(mp, make_dynamics("double_pendulum"))
    f = lambda a: torch.tensor(np.asarray(a, dtype=np.float32))
    p = default_params(mp, device="cpu")._replace(
        q=f([10.0, 1.0, 5.0, 5.0]), r=f([0.5, 0.5]), rm=f([0.01, 0.01]))
    pb = map_params(lambda a: a.expand((B,) + a.shape).clone(), p)
    return prob, pb._replace(x0=f(x0), x_des=f(x_des))


def _jax_batch_problem(B=16, N=10):
    kw = dict(num_x=4, num_u=2, step_size=0.01, num_shooting_nodes=N,
              u_min=[-50.0] * 2, u_max=[50.0] * 2,
              dynamics_name="double_pendulum")
    x0, x_des = _np_batch(B, N)
    mp = JaxModelParameters("shard_dp", **kw)
    prob = jax_make_problem(mp, jax_make_dynamics("double_pendulum"))
    f32 = jnp.float32
    p = jax_default_params(mp, dtype=f32)._replace(
        q=jnp.asarray([10.0, 1.0, 5.0, 5.0], f32),
        r=jnp.asarray([0.5, 0.5], f32), rm=jnp.asarray([0.01, 0.01], f32))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape).copy(), p)
    return prob, pb._replace(x0=jnp.asarray(x0, f32),
                             x_des=jnp.asarray(x_des, f32))


def test_exports_the_jax_names():
    import mahi_mpc_tpu.parallel as jax_parallel
    assert set(jax_parallel.__all__) <= set(parallel.__all__)
    mesh = make_mesh(n_batch=4, n_time=2, devices=CPU8)
    assert mesh.shape == {"batch": 4, "time": 2} and mesh.size == 8
    with pytest.raises(ValueError):
        make_mesh(n_batch=5, n_time=2, devices=CPU8)


def test_sharded_lanes_matches_jax_sharded():
    """tests/test_parallel.py:36-62: the lanes solve over 8 shards against
    JAX's sharded solver on 8 devices (U 2e-4, statuses equal) and against
    the port's unsharded solve (the same tolerance)."""
    opts = SolverOptions(tol=1e-5, max_iter=40)
    prob, pb = _batch_problem(B=16)
    fn = make_sharded_solver(prob, make_mesh(n_batch=8, devices=CPU8), opts,
                             donate_warm_start=False)
    got = fn(shard_params(pb, make_mesh(n_batch=8, devices=CPU8)))
    assert got.U.shape == (16, 10, 2)

    jprob, jpb = _jax_batch_problem(B=16)
    jmesh = jax_make_mesh(n_batch=8, n_time=1)
    jfn = jax_sharded_solver(jprob, jmesh, JaxSolverOptions(tol=1e-5,
                                                            max_iter=40),
                             donate_warm_start=False)
    X0 = jnp.zeros((16, 11, 4), jnp.float32)
    U0 = jnp.zeros((16, 10, 2), jnp.float32)
    ref = jfn(jax_shard_params(jpb, jmesh), X0, U0)
    np.testing.assert_allclose(got.U, np.asarray(ref.U), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(got.status, np.asarray(ref.status))

    one = solve_batch_lanes(prob, pb, opts=opts)
    np.testing.assert_allclose(got.U, one.U, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.status, one.status)


def test_uneven_batch_not_divisible_by_mesh():
    """B=12 over 8 shards: padded by repeating the last instance, sliced
    back to 12; equal to the unsharded solve (U 2e-4, statuses equal)."""
    prob, pb = _batch_problem(B=12)
    opts = SolverOptions(tol=1e-4, max_iter=20)
    mesh = make_mesh(n_batch=8, devices=CPU8)
    shards = shard_params(pb, mesh)
    assert [s.x0.shape[0] for s in shards] == [2] * 8
    for pad in range(12, 16):          # the padding repeats instance 11
        assert torch.equal(shards[pad // 2].x0[pad % 2], pb.x0[11])
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    res = fn(pb, torch.zeros(12, 11, 4), torch.zeros(12, 10, 2))
    assert res.X.shape[0] == 12 and bool(torch.isfinite(res.X).all())
    one = solve_batch_lanes(prob, pb, opts=opts)
    np.testing.assert_allclose(res.U, one.U, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(res.status, one.status)


def test_scaling_report_runs():
    prob, pb = _batch_problem(B=16, N=8)
    rep = scaling_report(prob, pb, make_mesh(n_batch=8, devices=CPU8),
                         SolverOptions(tol=1e-4, max_iter=10), iters=1)
    assert rep["batch"] == 16 and rep["devices"] == 8
    assert rep["solves_per_s"] > 0 and rep["device_kind"] == "cpu"
    assert 0.0 <= rep["converged_frac"] <= 1.0 and rep["mean_iters"] >= 1


def _warm_loop(donate):
    prob, pb = _batch_problem(B=8)
    opts = SolverOptions(tol=1e-4, max_iter=25)
    mesh = make_mesh(n_batch=8, devices=CPU8)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=donate)
    X, U = torch.zeros(8, 11, 4), torch.zeros(8, 10, 2)
    pb = shard_params(pb, mesh)
    iters, plans = [], []
    for _ in range(3):
        given = (X, U)
        res = fn(pb, X, U)
        assert (res.X is given[0]) == donate and (res.U is given[1]) == donate
        X, U = res.X, res.U
        iters.append(float(res.iters.float().mean()))
        plans.append(res.U.clone())
    return iters, plans


def test_donated_warm_start_loop():
    """tests/test_parallel.py:79-95: the receding-horizon loop re-solves
    from its own plan and its iterations do not rise; with donation the
    solver writes the plan into the caller's warm-start tensors, and the
    results equal those without donation."""
    iters, plans = _warm_loop(donate=True)
    assert iters[-1] <= iters[0]
    iters0, plans0 = _warm_loop(donate=False)
    assert iters == iters0
    for a, b in zip(plans, plans0):
        assert torch.equal(a, b)


def _arm_batch(B=16, N=8):
    """tests/test_parallel.py:98-146's mahi_arm batch (float32)."""
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("fshard", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=0.002, num_shooting_nodes=N,
                         u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
                         dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(0)
    p = map_params(lambda a: a.expand((B,) + a.shape).clone(),
                   default_params(mp, device="cpu"))
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    return prob, p._replace(
        x0=f(0.2 * rng.standard_normal((B, dyn.nx))),
        x_des=f(0.1 * rng.standard_normal((B, N, dyn.nx))))


def test_fused_sharded_matches_unsharded():
    """tests/test_parallel.py:98-146 (the plain version of the fused kernel
    on the CPU): fixed-3 warm solves over 8 shards equal the unsharded
    solve (X, U 2e-6), all CONVERGED; ``make_sharded_solver`` with
    ``warm_solver="fused"`` takes the fused adaptive route, pads B=13 and
    honours donation."""
    prob, pb = _arm_batch()
    opts = SolverOptions(tol=1e-4, max_iter=30)
    res0 = solve_batch_lanes(prob, pb, opts=opts)
    pb2 = pb._replace(x0=pb.x0 + 0.01)
    mu_w = opts.warm_mu_factor * opts.tol
    ref = solve_batch_fused(prob, pb2, res0.X, res0.U, opts, mu0=mu_w,
                            n_iter=3)
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape["batch"] == 8
    fn = make_fused_sharded_solver(prob, mesh, opts, n_iter=3)
    res = fn(shard_params(pb2, mesh), res0.X, res0.U, mu_w)
    np.testing.assert_allclose(res.U, ref.U, atol=2e-6, rtol=0)
    np.testing.assert_allclose(res.X, ref.X, atol=2e-6, rtol=0)
    assert bool((res.status == 0).all())
    with pytest.raises(ValueError, match="divisible"):
        fn(map_params(lambda a: a[:13], pb2), res0.X[:13], res0.U[:13],
           mu_w)

    fopts = SolverOptions(tol=1e-4, max_iter=30, warm_solver="fused")
    head = lambda t: t[:13]
    X, U = head(res0.X).clone(), head(res0.U).clone()
    got = make_sharded_solver(prob, mesh, fopts)(map_params(head, pb2), X, U)
    want = solve_batch_fused(prob, map_params(head, pb2), head(res0.X),
                             head(res0.U), fopts, mu0=fopts.mu_init,
                             adaptive=True)
    assert got.U is U and got.X is X
    np.testing.assert_allclose(got.U, want.U, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(got.status, want.status)


# ---------------------------------------------------------------------------
# BatchModelControl(mesh=...)
# ---------------------------------------------------------------------------

SB, SN = 8, 8
SQ, SR, SRM = [10.0] * 4 + [1.0] * 4, [0.1] * 4, [0.01] * 4


def _svc_mp(cls):
    return cls("bsvc", num_x=8, num_u=4, step_size=0.002,
               num_shooting_nodes=SN, u_min=[-20.0] * 4, u_max=[20.0] * 4,
               dynamics_name="mahi_arm")


def _service(mesh=None, batch=SB, warm_solver="fused"):
    return BatchModelControl(
        _svc_mp(ModelParameters), batch=batch, device="cpu", mesh=mesh,
        opts=SolverOptions(tol=1e-4, max_iter=30, warm_solver=warm_solver,
                           fixed_warm_iters=3),
        Q=SQ, R=SR, Rm=SRM)


def _drive(svc, batch=SB, steps=3):
    rng = np.random.default_rng(3)
    x0 = 0.2 * rng.standard_normal((batch, 8))
    svc.set_references(0.2 * rng.standard_normal((batch, SN, 8)))
    out = []
    for k in range(steps):
        svc.set_states(x0 + 0.01 * k)
        out.append((svc.step().clone(), svc.last.status.clone()))
    return out


@pytest.mark.parametrize("warm_solver,batch,n_shards", [
    ("fused", SB, 8), ("fused", 12, 8), ("adaptive", SB, 3)])
def test_service_mesh_matches_meshless(warm_solver, batch, n_shards):
    """A service on a mesh of logical CPU shards (B divisible or padded)
    against the meshless one, 1 cold + 2 warm steps: the same statuses and
    controls within 2e-6 (fused: per instance; lanes: 2e-4, whose loop
    runs to the slowest instance of its shard); the gathered state equals
    the meshless one's to the same tolerance."""
    mesh = make_mesh(n_batch=n_shards, devices=["cpu"] * n_shards)
    sharded = _service(mesh, batch, warm_solver)
    plain = _service(None, batch, warm_solver)
    assert sharded.mesh.shape["batch"] == n_shards
    assert plain.mesh.shape["batch"] == 1
    tol = 2e-6 if warm_solver == "fused" else 2e-4
    for (u, st), (u0, st0) in zip(_drive(sharded, batch),
                                  _drive(plain, batch)):
        assert u.shape == (batch, 4)
        np.testing.assert_array_equal(st, st0)
        np.testing.assert_allclose(u, u0, atol=tol, rtol=0)
    a, b = sharded.state_dict(), plain.state_dict()
    assert a["X"].shape == (batch, SN + 1, 8)
    np.testing.assert_allclose(a["U"], b["U"], atol=tol, rtol=0)
    assert sharded.metrics()["batch"] == batch


def test_one_device_mesh_is_the_meshless_path():
    """A mesh of one device splits nothing: the shard is the whole batch's
    tensor, and the service's steps equal the meshless ones bitwise."""
    one = _service(make_mesh(n_batch=1, devices=["cpu"]))
    plain = _service()
    assert len(one._ps) == 1 and one._p is one._ps[0]
    for (u, st), (u0, st0) in zip(_drive(one), _drive(plain)):
        assert torch.equal(u, u0) and torch.equal(st, st0)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX service on the 8-device CPU mesh, its states and references
    set from numpy seed 5 (no solve: its state is the parameters and the
    zero plan)."""
    jsvc = JaxBatchModelControl(_svc_mp(JaxModelParameters), batch=SB,
                                mesh=jax_make_mesh(n_batch=8),
                                opts=JaxSolverOptions(tol=1e-4, max_iter=30),
                                Q=SQ, R=SR, Rm=SRM)
    rng = np.random.default_rng(5)
    jsvc.set_states(0.2 * rng.standard_normal((SB, 8)).astype(np.float32))
    jsvc.set_references(
        0.2 * rng.standard_normal((SB, SN, 8)).astype(np.float32))
    return jsvc


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_state_dict_round_trip_with_jax(jax_state, n_shards):
    """A state saved by JAX's service on its 8-device mesh loads into the
    port's service on a mesh of 1, 3 (padded) or 8 shards, which steps
    from it; the port's state then loads back into JAX's service and
    reads back equal."""
    st = jax_state.state_dict()
    svc = _service(make_mesh(n_batch=n_shards,
                             devices=["cpu"] * n_shards))
    svc.load_state(st)
    back = svc.state_dict()
    for a, b in zip(back["params"], st["params"]):
        if isinstance(b, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, np.asarray(y))
        else:
            np.testing.assert_array_equal(a, np.asarray(b))
    u = svc.step()
    assert u.shape == (SB, 4) and bool(torch.isfinite(u).all())
    assert svc.metrics()["converged_frac"] >= 0.9
    mine = svc.state_dict()
    jax_state.load_state(mine)
    again = jax_state.state_dict()
    np.testing.assert_array_equal(np.asarray(again["U"]), mine["U"])
    np.testing.assert_array_equal(np.asarray(again["X"]), mine["X"])
    np.testing.assert_array_equal(np.asarray(again["params"].x0),
                                  mine["params"].x0)


# ---------------------------------------------------------------------------
# The kernel launchers under a device guard
# ---------------------------------------------------------------------------

class _Guard:
    """A stand-in for ``torch.cuda.device``: records the device entered
    and which device is current while the launch runs."""

    def __init__(self, log):
        self.log, self.current = log, ["cuda:0"]

    def __call__(self, dev):
        guard = self

        class _Ctx:
            def __enter__(self):
                guard.log.append(("enter", str(dev)))
                guard.current.append(str(dev))

            def __exit__(self, *exc):
                guard.current.pop()
                guard.log.append(("exit", str(dev)))
        return _Ctx()


def _fake_cuda(monkeypatch, module, library):
    """Patch ``module``'s view of torch.cuda and the build so that a launch
    helper runs its host code without a card; returns the guard's log."""
    log = []
    guard = _Guard(log)
    stream = lambda dev: types.SimpleNamespace(
        cuda_stream=f"stream of {dev} with {guard.current[-1]} current")
    fake = types.SimpleNamespace(device=guard, current_stream=stream)
    monkeypatch.setattr(module.torch, "cuda", fake)
    lib = types.SimpleNamespace(**{library: object()})
    import mahi_mpc_tpu_torch._build as build
    monkeypatch.setattr(build, "cuda_build", lambda name: (lib, "", 0.0))
    return log


def test_fused_launch_enters_the_device_guard(monkeypatch):
    """``solver/fused.py``'s launch helper, called for cuda:1 while cuda:0
    is current, takes the stream and launches inside cuda:1's guard (a
    kernel launch goes to the current device)."""
    prob, _ = _arm_batch(B=1)
    launched = []
    monkeypatch.setattr(fused_mod, "_run_library", lambda fn, stream, *a:
                        launched.append(stream) or (None, None, None))
    monkeypatch.setattr(solve_batch_fused, "launches", 0)
    monkeypatch.setattr(solve_batch_fused, "mode_launches",
                        dict(fast=0, generic=0, ltv=0))
    log = _fake_cuda(monkeypatch, fused_mod, "mpc_fused_launch_f32")
    X = types.SimpleNamespace(device=torch.device("cuda", 1),
                              dtype=torch.float32)
    ws = fused_mod._Workspace([], [X], [], [None] * 3)
    p = types.SimpleNamespace(x0=X)
    fused_mod._launch_cuda(prob, None, p, ("fused_sqp", ws), 3, (1.0,),
                           False, None)
    assert launched == ["stream of cuda:1 with cuda:1 current"]
    assert log == [("enter", "cuda:1"), ("exit", "cuda:1")]
    assert solve_batch_fused.launches == 1


class _CardTensor:
    """A stand-in for a float32 tensor on cuda:1, batch of one."""
    device, dtype, shape = torch.device("cuda", 1), torch.float32, (1,)

    def to(self, *a):
        return self

    def contiguous(self):
        return self

    def data_ptr(self):
        return 0


def test_fused_prepare_enters_the_device_guard(monkeypatch):
    """The card route's preparation (``_prepare_cuda``), called for cuda:1
    while cuda:0 is current, launches its kernel on cuda:1's stream inside
    cuda:1's guard and counts the preparation."""
    prob, pb = _arm_batch(B=1)
    log = _fake_cuda(monkeypatch, fused_mod, "mpc_fused_prepare_f32")
    streams = []
    lib = types.SimpleNamespace(mpc_fused_prepare_f32=lambda *a:
                                streams.append(a[-1]) or 0)
    import mahi_mpc_tpu_torch._build as build
    monkeypatch.setattr(build, "cuda_build", lambda name: (lib, "", 0.0))
    t = _CardTensor()
    monkeypatch.setattr(fused_mod, "_workspace", lambda *a: fused_mod
                        ._Workspace([t] * 14, [t] * 3, [t] * 7, [None] * 3))
    monkeypatch.setattr(solve_batch_fused, "prepare_launches", 0)
    p = pb._replace(**{k: t for k in pb._fields if k != "lin"})
    (name, ws), mu = fused_mod._prepare_cuda(prob, SolverOptions(), p, t, t,
                                             1e-5, fused_mod.LS_FAN_FIXED)
    assert name == "fused_sqp" and ws.ins == [t] * 14 and mu is t
    assert streams == ["stream of cuda:1 with cuda:1 current"]
    assert log == [("enter", "cuda:1"), ("exit", "cuda:1")]
    assert solve_batch_fused.prepare_launches == 1


def test_riccati_launch_enters_the_device_guard(monkeypatch):
    """The Riccati kernel's launch helper, likewise for cuda:1."""
    launched = []
    monkeypatch.setattr(riccati_kernel, "_run_library", lambda fn, stream, qp:
                        launched.append(stream) or (None, None))
    log = _fake_cuda(monkeypatch, riccati_kernel, "mpc_riccati_launch_f32")
    dev = torch.device("cuda", 1)
    shape = types.SimpleNamespace
    qp = StageQP(*[shape(device=dev, dtype=torch.float32,
                         shape=(1, 25, 12, s)) for s in (12, 4)] +
                 [None] * 8)
    monkeypatch.setattr(riccati_kernel.solve_lqr_kernel_batch, "launches", 0)
    riccati_kernel._launch_cuda(qp)
    assert launched == ["stream of cuda:1 with cuda:1 current"]
    assert log == [("enter", "cuda:1"), ("exit", "cuda:1")]
    assert riccati_kernel.solve_lqr_kernel_batch.launches == 1
