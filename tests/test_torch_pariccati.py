"""The port's parallel-in-time Riccati (``kkt_backend="pariccati"``,
``mahi_mpc_tpu_torch/solver/pariccati.py``) against the JAX package's
``solve_lqr_parallel``, the port's dense oracle and its scan, in float64
(the bands of tests/test_riccati.py:86-108, tightened to 1e-9 against
JAX: the same algebra in the same dtype)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_double_pendulum as jax_double_pendulum
from mahi_mpc_tpu.solver.pariccati import \
    solve_lqr_parallel as jax_solve_parallel
from mahi_mpc_tpu.solver.sqp import solve as jax_solve
from mahi_mpc_tpu.solver.stage_qp import StageQP as JaxStageQP
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_double_pendulum
from mahi_mpc_tpu_torch.solver import (solve, solve_batch, solve_batch_lanes,
                                       solve_fixed, solve_lqr)
from mahi_mpc_tpu_torch.solver.pariccati import (Affine, affine_combine,
                                                 combine, eliminate,
                                                 inclusive_scan,
                                                 solve_lqr_parallel,
                                                 stage_leading)
from mahi_mpc_tpu_torch.solver.riccati import solve_lqr_dense, solve_lqr_scan
from mahi_mpc_tpu_torch.solver.stage_qp import StageQP
from mahi_mpc_tpu_torch.transcribe.shooting import (default_params,
                                                    make_problem, map_params)
from test_torch_riccati import random_qp_np

torch.set_num_threads(1)

_jax_parallel = jax.jit(jax_solve_parallel)   # eager op by op is ~80 s


def _qp(N, seed, nz=6, nu=2):
    a = random_qp_np(N=N, nz=nz, nu=nu, seed=seed)
    return (StageQP(*[torch.tensor(x) for x in a]),
            JaxStageQP(*[jnp.asarray(x, jnp.float64) for x in a]))


def _close(got, ref, tol):
    """Every field of an LQRSolution within ``tol`` (rtol and atol)."""
    for name, g, r in zip(("dz", "du", "lam"), got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_and_dense(seed):
    """N=16: 1e-9 to JAX's solve_lqr_parallel; the dense oracle's band of
    tests/test_riccati.py:86-99 (du, dz 1e-7; lam 1e-6 past node 0)."""
    qp, jqp = _qp(16, seed)
    got = solve_lqr_parallel(qp)
    _close(got, _jax_parallel(jqp), 1e-9)
    dense = solve_lqr_dense(qp)
    np.testing.assert_allclose(got.du, dense.du, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(got.dz, dense.dz, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(got.lam[1:], dense.lam[1:], rtol=1e-6,
                               atol=1e-6)


def test_long_horizon():
    """N=128 (tests/test_riccati.py:101-108): 1e-9 to JAX, du 1e-6 to the
    scan."""
    qp, jqp = _qp(128, 3)
    got = solve_lqr_parallel(qp)
    _close(got, _jax_parallel(jqp), 1e-9)
    np.testing.assert_allclose(got.du, solve_lqr_scan(qp).du, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("N", [1, 2, 3, 7, 8, 15, 16, 31, 32])
def test_horizons_against_scan(N):
    """N+1 a power of two (N = 1, 3, 7, 15, 31), one past it (N = 2, 8, 16,
    32) and between: the scan's solution within 1e-9 relative.  A wrong
    operand order in the scans still passes at N = 1."""
    qp, _ = _qp(N, 10 + N)
    got, ref = solve_lqr_parallel(qp), solve_lqr_scan(qp)
    for name, g, r in zip(("dz", "du", "lam"), got, ref):
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-9 * scale, name


def test_scan_order_on_a_non_commuting_product():
    """``inclusive_scan`` against a loop of combines, forward and reverse,
    on affine maps whose composition does not commute, at 11 elements."""
    rng = np.random.default_rng(0)
    m = Affine(torch.tensor(rng.standard_normal((11, 3, 3))),
               torch.tensor(rng.standard_normal((11, 3))))
    at = lambda k: Affine(m.F[k], m.g[k])
    fwd = inclusive_scan(affine_combine, m)
    rev = inclusive_scan(affine_combine, m, reverse=True)
    acc = at(0)
    for k in range(11):
        acc = at(0) if k == 0 else affine_combine(acc, at(k))
        np.testing.assert_allclose(fwd.F[k], acc.F, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(fwd.g[k], acc.g, rtol=1e-12, atol=1e-12)
    acc = at(10)
    for k in reversed(range(11)):
        acc = at(10) if k == 10 else affine_combine(at(k), acc)
        np.testing.assert_allclose(rev.F[k], acc.F, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(rev.g[k], acc.g, rtol=1e-12, atol=1e-12)


def test_combine_is_associative():
    """The star product of three random LQR-shaped elements, both ways,
    within 1e-12."""
    qp, _ = _qp(3, 5)
    el = eliminate(stage_leading(qp)).elems
    e = [type(el)(*[a[k] for a in el]) for k in range(3)]
    left = combine(combine(e[0], e[1]), e[2])
    right = combine(e[0], combine(e[1], e[2]))
    for a, b in zip(left, right):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_leading_batch_dims():
    """A (2, 3) batch of QPs through ``solve_lqr(qp, "pariccati")`` equals
    a loop of single solves (1e-12)."""
    qs = [random_qp_np(N=9, seed=s) for s in range(6)]
    qp = StageQP(*[torch.tensor(np.stack([q[i] for q in qs])).reshape(
        (2, 3) + np.shape(qs[0][i])) for i in range(10)])
    got = solve_lqr(qp, "pariccati")
    assert got.dz.shape == (2, 3, 10, 6) and got.du.shape == (2, 3, 9, 2)
    for s in range(6):
        one = solve_lqr_parallel(StageQP(*[torch.tensor(a) for a in qs[s]]))
        for g, r in zip(got, one):
            np.testing.assert_allclose(g.reshape((6,) + r.shape)[s], r,
                                       rtol=1e-12, atol=1e-12)


def test_float32_against_the_scan():
    """float32 at N=25 (the benchmark's horizon): within 1e-4 relative of
    the float64 scan (the scan in float32 lies in the same band)."""
    qp, _ = _qp(25, 4)
    got = solve_lqr_parallel(StageQP(*[a.float() for a in qp]))
    ref = solve_lqr_scan(qp)
    for name, g, r in zip(("dz", "du", "lam"), got, ref):
        assert float((g.double() - r).abs().max()) <= \
            1e-4 * float(r.abs().max()), name


def _dp(N=24, seed=1):
    """tests/test_time_shard.py:65-94's SQP, float64, in both packages."""
    rng = np.random.default_rng(seed)
    x_des = 0.3 * rng.standard_normal((N, 4))
    kw = dict(num_x=4, num_u=2, step_size=0.02, num_shooting_nodes=N,
              u_min=[-5.0, -5.0], u_max=[5.0, 5.0])
    mp = ModelParameters("pr_e2e", **kw)
    prob = make_problem(mp, make_double_pendulum())
    t = lambda v: torch.tensor(np.asarray(v, dtype=np.float64))
    p = default_params(mp, dtype=torch.float64, device="cpu")._replace(
        q=t([10.0, 1.0, 5.0, 5.0]), r=t([5.0, 5.0]), rm=t([0.1, 0.1]),
        x_des=t(x_des), x0=t([0.1, -0.05, 0.0, 0.0]))
    jmp = JaxModelParameters("pr_e2e", **kw)
    jprob = jax_make_problem(jmp, jax_double_pendulum())
    jp = jax_default_params(jmp, dtype=jnp.float64)._replace(
        q=jnp.array([10.0, 1.0, 5.0, 5.0]), r=jnp.array([5.0, 5.0]),
        rm=jnp.array([0.1, 0.1]), x_des=jnp.asarray(x_des),
        x0=jnp.asarray([0.1, -0.05, 0.0, 0.0]))
    return prob, p, jprob, jp


def test_backend_reaches_solve_and_matches_jax():
    """``SolverOptions(kkt_backend="pariccati")``: the port's ``solve``
    equals JAX's ``solve`` on the same backend (status, iterations, U
    1e-8) and its own ``"riccati"`` solve (U 1e-7)."""
    prob, p, jprob, jp = _dp()
    kw = dict(tol=1e-8, max_iter=60, dtype="float64")
    got = solve(prob, p, opts=SolverOptions(kkt_backend="pariccati", **kw))
    ref = solve(prob, p, opts=SolverOptions(kkt_backend="riccati", **kw))
    jref = jax_solve(jprob, jp, opts=JaxSolverOptions(kkt_backend="pariccati",
                                                      **kw))
    assert int(got.status) == 0 and int(got.status) == int(jref.status)
    assert int(got.iters) == int(jref.iters)
    np.testing.assert_allclose(got.U, np.asarray(jref.U), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.U, ref.U, rtol=1e-7, atol=1e-7)


def test_backend_reaches_the_batched_solvers():
    """``solve_batch``, ``solve_fixed`` and ``solve_batch_lanes`` with
    ``kkt_backend="pariccati"`` agree with their ``"riccati"`` runs (X, U
    1e-7), three instances at once."""
    prob, p, _, _ = _dp(N=12)
    rng = np.random.default_rng(2)
    pb = map_params(lambda a: a.expand((3,) + a.shape).clone(), p)
    pb = pb._replace(x0=pb.x0 + torch.tensor(0.05 * rng.standard_normal(
        (3, 4))))
    kw = dict(tol=1e-8, max_iter=40, dtype="float64")
    for fn in (solve_batch, solve_batch_lanes):
        got = fn(prob, pb, opts=SolverOptions(kkt_backend="pariccati", **kw))
        ref = fn(prob, pb, opts=SolverOptions(kkt_backend="riccati", **kw))
        assert (got.status == ref.status).all()
        np.testing.assert_allclose(got.U, ref.U, rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(got.X, ref.X, rtol=1e-7, atol=1e-7)
    got = solve_fixed(prob, p, opts=SolverOptions(kkt_backend="pariccati",
                                                  **kw), n_iter=3)
    ref = solve_fixed(prob, p, opts=SolverOptions(kkt_backend="riccati",
                                                  **kw), n_iter=3)
    np.testing.assert_allclose(got.U, ref.U, rtol=1e-7, atol=1e-7)
