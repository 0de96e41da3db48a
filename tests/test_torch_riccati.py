"""The port's small SPD solves and Riccati KKT backends against the JAX
package's, and the port's scan against its own dense oracle (the bands of
tests/test_riccati.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu.ops.linalg import cho_solve_small as jax_cho_solve_small
from mahi_mpc_tpu.ops.linalg import chol_small as jax_chol_small
from mahi_mpc_tpu.solver.riccati import _multipliers as jax_multipliers
from mahi_mpc_tpu.solver.riccati import solve_lqr_dense as jax_solve_dense
from mahi_mpc_tpu.solver.riccati import solve_lqr_scan as jax_solve_scan
from mahi_mpc_tpu.solver.stage_qp import StageQP as JaxStageQP
from mahi_mpc_tpu_torch.ops.linalg import (cho_solve_small, chol_small,
                                           spd_solve_small)
from mahi_mpc_tpu_torch.solver import (LQRSolution, resolve_kkt_backend,
                                       solve_lqr)
from mahi_mpc_tpu_torch.solver.riccati import (_multipliers,
                                               solve_lqr_dense,
                                               solve_lqr_scan)
from mahi_mpc_tpu_torch.solver.stage_qp import StageQP

torch.set_num_threads(1)


def random_qp_np(N=12, nz=6, nu=2, seed=0):
    """tests/test_riccati.py:15-33's QP, as float64 numpy arrays."""
    rng = np.random.default_rng(seed)

    def pd(n, scale=1.0):
        M = rng.normal(size=(n, n)) * scale
        return M @ M.T + n * np.eye(n) * 0.5
    Az = rng.normal(size=(N, nz, nz)) * 0.4
    Bz = rng.normal(size=(N, nz, nu))
    r = rng.normal(size=(N, nz))
    Hzz = np.stack([pd(nz) for _ in range(N)])
    Huu = np.stack([pd(nu) for _ in range(N)])
    Hzu = rng.normal(size=(N, nz, nu)) * 0.3
    gz = rng.normal(size=(N, nz))
    gu = rng.normal(size=(N, nu))
    Hf = pd(nz)
    gf = rng.normal(size=nz)
    return (Az, Bz, r, Hzz, Hzu, Huu, gz, gu, Hf, gf)


def _both(seed):
    a = random_qp_np(seed=seed)
    return (StageQP(*[torch.tensor(x) for x in a]),
            JaxStageQP(*[jnp.asarray(x, jnp.float64) for x in a]))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_chol_and_cho_solve_match_jax():
    """Batch-leading unrolled Cholesky and its solve (vector and matrix
    right-hand sides) against the JAX package's, float64 1e-12."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 4, 6):
        M = rng.normal(size=(5, n, n))
        A = M @ np.swapaxes(M, 1, 2) + n * np.eye(n)
        b = rng.normal(size=(5, n))
        Bm = rng.normal(size=(5, n, 3))
        L = chol_small(torch.tensor(A))
        Lj = jax.vmap(jax_chol_small)(jnp.asarray(A))
        _close(L, Lj, 1e-12)
        _close(cho_solve_small(L, torch.tensor(b)),
               jax.vmap(jax_cho_solve_small)(Lj, jnp.asarray(b)), 1e-12)
        _close(cho_solve_small(L, torch.tensor(Bm)),
               jax.vmap(jax_cho_solve_small)(Lj, jnp.asarray(Bm)), 1e-12)
        np.testing.assert_allclose(
            (torch.tensor(A) @ spd_solve_small(torch.tensor(A),
                                               torch.tensor(b))[..., None]
             )[..., 0].numpy(), b, atol=1e-10)


def test_chol_indefinite_gives_nan():
    """A pivot that is not positive gives NaN (no clamp), as in JAX."""
    A = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=torch.float64)
    assert bool(torch.isnan(chol_small(A)[0, 1, 1]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_and_multipliers_match_jax(seed):
    """solve_lqr_scan (dz, du, lam) and _multipliers against the JAX
    package's, float64 1e-10."""
    qp, jqp = _both(seed)
    got, ref = solve_lqr_scan(qp), jax_solve_scan(jqp)
    for g, r in zip(got, ref):
        _close(g, r, 1e-10)
    lam = _multipliers(qp, got.dz, got.du)
    _close(lam, jax_multipliers(jqp, jnp.asarray(got.dz.numpy()),
                                jnp.asarray(got.du.numpy())), 1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_matches_jax(seed):
    qp, jqp = _both(seed)
    got, ref = solve_lqr_dense(qp), jax_solve_dense(jqp)
    for g, r in zip(got, ref):
        _close(g, r, 1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_matches_dense(seed):
    """The port's scan against the port's dense oracle, at
    tests/test_riccati.py:41-47's bands."""
    qp, _ = _both(seed)
    a, b = solve_lqr_scan(qp), solve_lqr_dense(qp)
    np.testing.assert_allclose(a.du.numpy(), b.du.numpy(), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(a.dz.numpy(), b.dz.numpy(), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(a.lam[1:].numpy(), b.lam[1:].numpy(),
                               rtol=1e-7, atol=1e-7)


def test_batched_scan_and_dense_match_single():
    """Leading batch dims: each instance of a stacked batch solves as it
    does alone, for the scan, the dense oracle and solve_lqr."""
    qps = [_both(s)[0] for s in range(3)]
    batch = StageQP(*[torch.stack(f) for f in zip(*qps)])
    for solve in (solve_lqr_scan, solve_lqr_dense,
                  lambda q: solve_lqr(q, "dense")):
        sol = solve(batch)
        assert isinstance(sol, LQRSolution)
        for i, q in enumerate(qps):
            ref = solve_lqr_scan(q)
            np.testing.assert_allclose(sol.du[i].numpy(), ref.du.numpy(),
                                       rtol=1e-8, atol=1e-8)


def test_resolve_kkt_backend():
    """"auto" is the scan on the CPU and for single solves, and the kernel
    ("pallas") for batched solves on a CUDA device at a built stage shape
    (the device is only named: no card is needed)."""
    assert resolve_kkt_backend("auto", batched=True, device="cpu") == "riccati"
    assert resolve_kkt_backend("auto", batched=False,
                               device="cuda") == "riccati"
    for nz, nu in ((12, 4), (6, 2), (5, 1), (3, 1)):
        assert resolve_kkt_backend("auto", batched=True, dims=(25, nz, nu),
                                   device="cuda") == "pallas"
    assert resolve_kkt_backend("auto", batched=True, dims=(25, 7, 3),
                               device=torch.device("cuda", 0)) == "riccati"
    assert resolve_kkt_backend("dense", batched=True, device="cuda") == "dense"
    with pytest.raises(ValueError):
        solve_lqr(_both(0)[0], "no_such_backend")
