"""The LTV path's kernels on the card (``solver/linearize.py``): the
linearization and the affine discretization, each against its plain
PyTorch version on the same inputs, at the shapes the LTV paths launch them
at, at the service's batch, a partial last tile, B=1 and around one tile
(T - 1, T, T + 1 instances, T the kernel's own), in float32 and float64,
and the LTV service counted through them.

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture decides, so every pytest worker collects the same tests).  On the
card, with the rest of the tier::

    python -m pytest tests/ -m gpu -q

Band: 1e-5 of max|.| of the plain version's output, float32 (the arm's
folded columns agree with ``jacfwd`` to rounding, not bit for bit); 1e-12
in float64.
"""

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.solver.fused import (_launch_cuda, _prepare_cuda,
                                             _solve)
from mahi_mpc_tpu_torch.solver.linearize import (linearize_batch,
                                                 linearize_batch_plain,
                                                 linearize_tile,
                                                 ltv_discrete,
                                                 ltv_discrete_plain,
                                                 ltv_discrete_tile)
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

pytestmark = pytest.mark.gpu

BAND = 1e-5
BAND64 = 1e-12
# the service's batch, a partial last tile, one instance, and around one
# tile of the kernel (resolved in the test: the tile is the card's)
BATCHES = [16384, 16383, 1, "T-1", "T", "T+1"]
MODELS = ("mahi_arm", "two_link_arm", "pendulum", "cartpole",
          "double_pendulum", "acrobot", "user_chain3")
# (model, integrator) of the discretization: every integrator at (8, 4),
# the double pendulum's (4, 2) under RK4, the generated (6, 3) and (12, 6)
DISCRETE = (("mahi_arm", "euler"), ("mahi_arm", "midpoint"),
            ("mahi_arm", "rk4"), ("double_pendulum", "rk4"),
            ("user_chain3", "euler"), ("user_chain6", "rk4"))


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    return torch.device("cuda", 0)


def _chain(nq):
    """A user's model: nq pendulums coupled by springs (chip_smoke.py's)."""
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        left = torch.cat([q[:1], q[:-1]])
        right = torch.cat([q[1:], q[-1:]])
        return torch.cat([qd, u - torch.sin(q) - 0.1 * qd
                          + 0.5 * ((left - 2.0 * q) + right)])
    return Dynamics(f"user_chain{nq}", 2 * nq, nq, f, supports_lanes=True,
                    nq=nq)


def _dynamics(name):
    return _chain(int(name[-1])) if name.startswith("user_chain") \
        else make_dynamics(name)


def _batch(B, tile):
    """B, or around the tile's T instances."""
    if isinstance(B, int):
        return B
    return tile["instances"] + {"T-1": -1, "T": 0, "T+1": 1}[B]


def _points(dev, dyn, B, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    real = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return (real(0.3 * rng.standard_normal((B, dyn.nx))),
            real(rng.standard_normal((B, dyn.nu))))


def _err(got, want):
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def _linearize_held(dyn, x0, u0, band):
    before = linearize_batch.launches
    got = linearize_batch(dyn, x0, u0)
    assert linearize_batch.launches == before + 1
    want = linearize_batch_plain(dyn, x0, u0)
    torch.cuda.synchronize()
    assert all(tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype
               and g.is_contiguous() for g, w in zip(got, want))
    assert _err(got, want) <= band


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", MODELS)
def test_linearize_kernel_matches_plain(cuda, name, B):
    """The linearization kernel against the vmapped ``jacfwd`` at B points:
    A, B and x_dot0 within 1e-5 of max|.|, float32, batch-leading and
    contiguous; float64 launcher at a few points to 1e-12."""
    dyn = _dynamics(name)
    B = _batch(B, linearize_tile(dyn))
    x0, u0 = _points(cuda, dyn, B, seed=B)
    _linearize_held(dyn, x0, u0, BAND)
    _linearize_held(dyn, x0[:8].double(), u0[:8].double(), BAND64)


@pytest.mark.parametrize("name", MODELS)
def test_linearize_kernel_float64(cuda, name):
    """The float64 linearization kernel at B=16384 and around its own tile
    against the plain version, to 1e-12."""
    dyn = _dynamics(name)
    tile = linearize_tile(dyn, torch.float64)
    for B in (16384, tile["instances"] - 1, tile["instances"] + 1):
        x0, u0 = _points(cuda, dyn, B, seed=B, dtype=torch.float64)
        _linearize_held(dyn, x0, u0, BAND64)


def _frozen(dev, name, integrator, B, dtype=torch.float32):
    dyn = _dynamics(name)
    mp = ModelParameters(f"t_{name}", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=0.02, num_shooting_nodes=25,
                         integrator=integrator, is_linear=True)
    prob = make_problem(mp, dyn)
    p = default_params(mp, dtype=dtype, device=dev)
    p = MPCParams(*[type(f)(*[a.expand((B,) + a.shape).clone() for a in f])
                    if isinstance(f, tuple) else f.expand((B,) + f.shape)
                    .clone() for f in p])
    x0, u0 = _points(dev, dyn, B, seed=B + 1, dtype=dtype)
    A, Bm, xd0 = linearize_batch_plain(dyn, x0, u0)
    return prob, p._replace(x0=x0, u_prev=u0,
                            lin=LinPoint(A, Bm, xd0, x0, u0))


def _discrete_held(prob, p, band):
    before = ltv_discrete.launches
    got = ltv_discrete(prob, p)
    assert ltv_discrete.launches == before + 1
    want = ltv_discrete_plain(prob, p)
    torch.cuda.synchronize()
    assert all(g.movedim(0, -1).is_contiguous() and g.dtype == w.dtype
               for g, w in zip(got, want))
    assert all(tuple(g.shape) == tuple(w.shape) for g, w in zip(got, want))
    assert _err(got, want) <= band


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name,integrator", DISCRETE)
def test_ltv_discrete_kernel_matches_plain(cuda, name, integrator, B):
    """The discretization kernel against ``_ltv_discrete`` and Ad - I on
    the same frozen points: (Ad - I, Bd, cd) within 1e-5 of max|.|,
    float32, at B=16384, at B=16383 (a partial last tile), B=1 and around
    one tile; its outputs batch-innermost under batch-leading views."""
    prob0, _ = _frozen(cuda, name, integrator, 1)
    B = _batch(B, ltv_discrete_tile(prob0))
    prob, p = _frozen(cuda, name, integrator, B)
    _discrete_held(prob, p, BAND)


@pytest.mark.parametrize("name,integrator", DISCRETE)
def test_ltv_discrete_kernel_float64(cuda, name, integrator):
    """The float64 discretization kernel at B=16384 and around its own
    tile against the plain version, to 1e-12 ((12, 6): 18 tasks, a tile of
    16 instances)."""
    prob0, _ = _frozen(cuda, name, integrator, 1, torch.float64)
    tile = ltv_discrete_tile(prob0, torch.float64)
    for B in (16384, tile["instances"] - 1, tile["instances"] + 1):
        prob, p = _frozen(cuda, name, integrator, B, torch.float64)
        _discrete_held(prob, p, BAND64)


def test_ltv_tiles(cuda):
    """The tiles the kernels launch: 32 or 64 instances for the registered
    models, every block within 384 threads and 227 KB; and the (16, 8)
    float64 discretization (a user's chain of 8, 24 tasks), whose tile
    passes the 48 KB of static shared memory, launched (the launcher lets
    it take more) and held to the plain version to 1e-12 at B=16384 and
    one past its tile."""
    prob, _ = _frozen(cuda, "user_chain8", "euler", 1, torch.float64)
    big = ltv_discrete_tile(prob, torch.float64)
    assert big["smem_bytes"] > 48 * 1024 and big["blocks_per_sm"] >= 1
    for B in (16384, big["instances"] + 1):
        _discrete_held(*_frozen(cuda, "user_chain8", "euler", B,
                                torch.float64), BAND64)
    for name in MODELS:
        tile = linearize_tile(_dynamics(name))
        assert tile["instances"] in (32, 64)
        assert tile["threads"] == tile["instances"] * \
            tile["threads_per_instance"] <= 384
        assert tile["smem_bytes"] <= 232448 and tile["blocks_per_sm"] >= 1


def test_ltv_paths_launch_the_kernels(cuda):
    """The LTV service (B=1024, fused route, 1 cold + 1 warm step) and an
    LTV fused solve launch the linearization once a step and the
    discretization once a solve, and call neither plain version; the
    controls agree with a step whose frozen point and discretization come
    from the plain versions, within 1e-4."""
    mp = ModelParameters("svc_ltv", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=25, u_min=[-20.0] * 4,
                         u_max=[20.0] * 4, dynamics_name="mahi_arm",
                         is_linear=True)
    svc = BatchModelControl(mp, batch=1024, device=cuda,
                            opts=SolverOptions(tol=1e-4, max_iter=30,
                                               fixed_warm_iters=3),
                            Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
                            Rm=[0.01] * 4)
    assert svc.warm_solver == "fused"
    rng = np.random.default_rng(0)
    svc.set_states(0.2 * rng.standard_normal((1024, 8)))
    svc.set_references(0.2 * rng.standard_normal((1024, 25, 8)))
    counts = lambda: (linearize_batch.launches, ltv_discrete.launches,
                      linearize_batch_plain.calls, ltv_discrete_plain.calls)
    c0 = counts()
    u = svc.step()
    svc.set_states(0.2 * rng.standard_normal((1024, 8)), u_prev=u)
    p, X, U = svc._p, svc._X, svc._U
    u = svc.step()
    torch.cuda.synchronize()
    assert tuple(np.subtract(counts(), c0)) == (2, 2, 0, 0)
    assert svc.metrics()["converged_frac"] >= 0.9
    # the same warm step, the fused kernel fed by the plain versions
    lin = linearize_batch_plain(svc.dynamics, p.x0, p.u_prev)
    pp = p._replace(lin=LinPoint(*lin, p.x0, p.u_prev))
    opts = svc.opts
    ref = _solve(svc.problem, pp, X, U, opts,
                 max(opts.warm_mu_factor * opts.tol, opts.mu_min), 3, None,
                 False, _prepare_cuda, _launch_cuda, ltv_discrete_plain)
    ok = ref.status != 2
    assert (u - torch.where(ok[:, None], ref.U[:, 0], 0.0)).abs().max() \
        .item() <= 1e-4
