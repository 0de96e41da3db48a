"""Horizon (time-axis) sharding in the port
(``mahi_mpc_tpu_torch/parallel/time_shard.py``), the counterpart of
tests/test_time_shard.py: the horizon split over T = 2 and 4 logical CPU
shards against the JAX package's ``solve_lqr_time_sharded`` on its
8-device CPU mesh and against the sequential scan, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu.models import make_double_pendulum as jax_double_pendulum
from mahi_mpc_tpu.parallel.time_shard import \
    solve_lqr_time_sharded as jax_time_sharded
from mahi_mpc_tpu.solver.stage_qp import build_stage_qp as jax_build_stage_qp
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_double_pendulum
from mahi_mpc_tpu_torch.parallel import (enable_time_shard_backend, make_mesh,
                                         solve_lqr_time_sharded)
from mahi_mpc_tpu_torch.solver import solve, solve_batch, solve_batch_lanes
from mahi_mpc_tpu_torch.solver.riccati import solve_lqr_scan
from mahi_mpc_tpu_torch.solver.stage_qp import StageQP
from mahi_mpc_tpu_torch.transcribe.shooting import (default_params,
                                                    make_problem, map_params)

torch.set_num_threads(1)


def _qp(N=24, seed=0):
    """tests/test_time_shard.py:22-37's stage QP (double pendulum, float64)
    from JAX's build_stage_qp, in both packages."""
    mp = JaxModelParameters("ts", num_x=4, num_u=2, step_size=0.02,
                            num_shooting_nodes=N,
                            u_min=[-5.0, -5.0], u_max=[5.0, 5.0])
    prob = jax_make_problem(mp, jax_double_pendulum())
    rng = np.random.default_rng(seed)
    p = jax_default_params(mp, dtype=jnp.float64)
    p = p._replace(q=jnp.array([10.0, 1.0, 5.0, 5.0]),
                   r=jnp.array([5.0, 5.0]), rm=jnp.array([0.1, 0.1]),
                   x_des=jnp.asarray(0.3 * rng.standard_normal((N, 4))),
                   x0=jnp.asarray(0.2 * rng.standard_normal(4)))
    X = jnp.asarray(0.1 * rng.standard_normal((N + 1, 4)))
    U = jnp.asarray(0.5 * rng.standard_normal((N, 2)))
    jqp = jax_build_stage_qp(prob, X, U, p, jnp.asarray(1e-2),
                             jnp.asarray(1e-8))
    return StageQP(*[torch.tensor(np.asarray(a)) for a in jqp]), jqp


def _time_mesh(T):
    return make_mesh(n_batch=1, n_time=T, devices=["cpu"] * T)


@pytest.mark.parametrize("n_time", [2, 4])
def test_time_sharded_equals_jax_and_scan(n_time):
    """du, dz within 1e-9 (lam 1e-8) of the scan and of JAX's sharded
    solve on a ``time`` mesh of as many CPU devices."""
    qp, jqp = _qp(N=24)
    got = solve_lqr_time_sharded(qp, _time_mesh(n_time))
    assert got.dz.shape == (25, 6) and got.du.shape == (24, 2)
    jmesh = JaxMesh(np.asarray(jax.devices()[:n_time]), axis_names=("time",))
    for ref in (solve_lqr_scan(qp),
                jax.jit(lambda q: jax_time_sharded(q, jmesh))(jqp)):
        np.testing.assert_allclose(got.du, np.asarray(ref.du), atol=1e-9,
                                   rtol=1e-9)
        np.testing.assert_allclose(got.dz, np.asarray(ref.dz), atol=1e-9,
                                   rtol=1e-9)
        np.testing.assert_allclose(got.lam, np.asarray(ref.lam), atol=1e-8,
                                   rtol=1e-8)


def test_time_sharded_leading_batch():
    """A batch of 3 QPs at T=4 equals the scan on the batch (1e-9)."""
    qps = [_qp(N=24, seed=s)[0] for s in range(3)]
    qp = StageQP(*[torch.stack(f) for f in zip(*qps)])
    got = solve_lqr_time_sharded(qp, _time_mesh(4))
    ref = solve_lqr_scan(qp)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-9, rtol=1e-9)


def test_time_shard_requires_divisible_horizon():
    qp, _ = _qp(N=24)
    bad = StageQP(*[a[:-1] if a.dim() and a.shape[0] == 24 else a
                    for a in qp])
    with pytest.raises(AssertionError):
        solve_lqr_time_sharded(bad, _time_mesh(2))


def test_time_shard_backend_reachable_from_solver_options():
    """tests/test_time_shard.py:65-94: ``enable_time_shard_backend`` makes
    ``SolverOptions(kkt_backend=name)`` route the SQP's KKT solves through
    the sharded path (T=4): ``solve`` matches ``"riccati"`` (U 1e-7, both
    converged), and so do ``solve_batch`` and ``solve_batch_lanes``."""
    name = enable_time_shard_backend(_time_mesh(4))
    N = 24
    mp = ModelParameters("ts_e2e", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=N,
                         u_min=[-5.0, -5.0], u_max=[5.0, 5.0])
    prob = make_problem(mp, make_double_pendulum())
    rng = np.random.default_rng(1)
    t = lambda v: torch.tensor(np.asarray(v, dtype=np.float64))
    p = default_params(mp, dtype=torch.float64, device="cpu")._replace(
        q=t([10.0, 1.0, 5.0, 5.0]), r=t([5.0, 5.0]), rm=t([0.1, 0.1]),
        x_des=t(0.3 * rng.standard_normal((N, 4))),
        x0=t([0.1, -0.05, 0.0, 0.0]))
    kw = dict(tol=1e-8, max_iter=60, dtype="float64")
    ref = solve(prob, p, opts=SolverOptions(kkt_backend="riccati", **kw))
    got = solve(prob, p, opts=SolverOptions(kkt_backend=name, **kw))
    assert int(ref.status) == 0 and int(got.status) == 0
    np.testing.assert_allclose(got.U, ref.U, atol=1e-7, rtol=1e-7)

    pb = map_params(lambda a: a.expand((2,) + a.shape).clone(), p)
    pb = pb._replace(x0=pb.x0 * torch.tensor([[1.0], [-1.0]]))
    for fn in (solve_batch, solve_batch_lanes):
        ref = fn(prob, pb, opts=SolverOptions(kkt_backend="riccati", **kw))
        got = fn(prob, pb, opts=SolverOptions(kkt_backend=name, **kw))
        assert (got.status == 0).all() and (ref.status == 0).all()
        np.testing.assert_allclose(got.U, ref.U, atol=1e-7, rtol=1e-7)
