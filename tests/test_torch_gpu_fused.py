"""The fused kernel's pins on the card: the port's counterpart of
``tests_tpu/test_fused_on_tpu.py``, and the bodies the kernel runs at their
launch shapes.

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture decides, so every pytest worker collects the same tests).  On the
card, every test marked ``gpu``::

    python -m pytest tests/ -m gpu -q

- The four pins of the JAX tier, at its B=1024 on the 4-DOF ``mahi_arm``
  (N=25, dt=2 ms, |u| <= 20, float32): the fixed-3 warm fused solve within
  5e-3 of the adaptive lanes solve (Riccati kernel) from the same state,
  >= 99.9 % converged; the adaptive cold fused solve >= 99 % converged to
  tolerance and within 5e-2 of the lanes cold solve; LTV fused (adaptive
  warm) within 5e-3 of lanes; N=50 adaptive warm >= 99 % converged.
- The bodies at the shapes the main paths launch them at, each against its
  plain version on the same inputs (max |dX|, |dU| <= 1e-4, statuses):
  ``Ltv<8,4>`` at B=1 on the block body (the LTV single robot's warm
  ``calc_u``), the generated LTV (12, 6) and (6, 3) at B=16384 on the
  body the rule names (the four-lane group over more controls than lanes;
  one thread), and a user's own model at B=1 on the block body
  (``user_chain4``: ``FastNq<gen::Model>``, nx = 8, nu = 4;
  ``user_vdp``: ``Generic<gen::Model>`` under RK4).
"""

import numpy as np
import pytest
import torch
from torch.func import vmap

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.ops.precision import strict_fp32
from mahi_mpc_tpu_torch.solver.batched import solve_batch_lanes
from mahi_mpc_tpu_torch.solver.fused import (card_body, solve_batch_fused,
                                             solve_batch_fused_plain)
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

pytestmark = pytest.mark.gpu

B = 1024                  # the JAX tier's batch: one (8, 128) TPU tile
PLAIN_BAND = 1e-4         # chip_smoke.py's band for a kernel against plain


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    return torch.device("cuda", 0)


def _batch(dev, dyn, mp, batch, seed, q):
    """``batch`` instances of ``mp`` on ``dev`` from one numpy seed: Q =
    ``q``, R = 0.1, Rm = 0.01, x0 and x_des ~ 0.2 N(0, 1); an LTV problem
    frozen at each instance's (x0, u_prev)."""
    nx, nu, N = mp.num_x, mp.num_u, mp.num_shooting_nodes
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    p = default_params(mp, device=dev)._replace(
        q=f32(q), r=f32([0.1] * nu), rm=f32([0.01] * nu))
    ex = lambda a: a.expand((batch,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=f32(0.2 * rng.standard_normal((batch, nx))),
                   x_des=f32(0.2 * rng.standard_normal((batch, N, nx))))
    if mp.is_linear:
        with strict_fp32():
            A, Bm, xd0 = vmap(dyn.linearize)(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return p


def _setup(dev, n_nodes=25, ltv=False, seed=0, batch=B):
    """The JAX tier's problem: ``mahi_arm``, Euler, dt=2 ms, |u| <= 20."""
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("gpu_t", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=0.002, num_shooting_nodes=n_nodes,
                         u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
                         dynamics_name="mahi_arm", is_linear=ltv)
    prob = make_problem(mp, dyn)
    opts = SolverOptions(tol=1e-4, max_iter=30)
    return prob, _batch(dev, dyn, mp, batch, seed, [10.0] * 4 + [1.0] * 4), \
        opts


def _mu(opts):
    return opts.mu_init, opts.warm_mu_factor * opts.tol


def _max_du(a, b, mask=None):
    d = (a.U - b.U).abs()
    if mask is not None:
        d = torch.where(mask[:, None, None], d, 0.0)
    return d.max().item()


def _held(rk, rp):
    """max |dX|, |dU| of the kernel's result from the plain version's."""
    return max((rk.X - rp.X).abs().max().item(),
               (rk.U - rp.U).abs().max().item())


def test_fixed_warm_parity_on_gpu(cuda):
    """One warm fused round (fixed-3, the headline shape) against the
    adaptive lanes solver from the same state: |dU| < 5e-3, >= 99.9 %
    converged."""
    prob, p, opts = _setup(cuda)
    mu_cold, mu_warm = _mu(opts)
    r0 = solve_batch_lanes(prob, p, None, None, opts, mu0=mu_cold)
    p2 = p._replace(x0=p.x0 + 0.01)
    rl = solve_batch_lanes(prob, p2, r0.X, r0.U, opts, mu0=mu_warm)
    rf = solve_batch_fused(prob, p2, r0.X, r0.U, opts, mu0=mu_warm,
                           n_iter=3)
    du = _max_du(rf, rl)
    assert du < 5e-3, f"fused-vs-lanes warm parity on the card: {du}"
    assert (rf.status == 0).float().mean().item() >= 0.999


def test_adaptive_cold_on_gpu(cuda):
    """Cold start through the kernel's barrier continuation: >= 99 %
    converged to tolerance, within 5e-2 of the lanes cold solve where both
    converged."""
    prob, p, opts = _setup(cuda, seed=1)
    mu_cold, _ = _mu(opts)
    rf = solve_batch_fused(prob, p, None, None, opts, mu0=mu_cold,
                           adaptive=True)
    ok = rf.status == 0
    conv = ok.float().mean().item()
    assert conv >= 0.99, f"cold continuation converged_frac {conv}"
    assert torch.where(ok, rf.kkt, 0.0).max().item() < opts.tol
    assert torch.where(ok, rf.feas, 0.0).max().item() < opts.tol
    rl = solve_batch_lanes(prob, p, None, None, opts, mu0=mu_cold)
    du = _max_du(rf, rl, ok & (rl.status == 0))
    assert du < 5e-2, f"cold fused-vs-lanes drifted: {du}"


def test_ltv_fused_on_gpu(cuda):
    """LTV through the kernel's affine step (the group body at B=1024),
    adaptive warm, against lanes from the same state: |dU| < 5e-3."""
    prob, p, opts = _setup(cuda, ltv=True, seed=2)
    assert card_body(prob, B) == ("group", 4)
    mu_cold, mu_warm = _mu(opts)
    r0 = solve_batch_lanes(prob, p, None, None, opts, mu0=mu_cold)
    p2 = p._replace(x0=p.x0 + 0.01)
    rl = solve_batch_lanes(prob, p2, r0.X, r0.U, opts, mu0=mu_warm)
    rf = solve_batch_fused(prob, p2, r0.X, r0.U, opts, mu0=mu_warm,
                           adaptive=True)
    du = _max_du(rf, rl)
    assert du < 5e-3, f"LTV fused-vs-lanes parity on the card: {du}"


def test_n50_adaptive_on_gpu(cuda):
    """N=50: the adaptive warm fused solve from the kernel's own cold plan
    converges on >= 99 % of the instances."""
    prob, p, opts = _setup(cuda, n_nodes=50, seed=3)
    mu_cold, mu_warm = _mu(opts)
    r0 = solve_batch_fused(prob, p, None, None, opts, mu0=mu_cold,
                           adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.01)
    rf = solve_batch_fused(prob, p2, r0.X, r0.U, opts, mu0=mu_warm,
                           adaptive=True)
    conv = (rf.status == 0).float().mean().item()
    assert conv >= 0.99, f"N=50 warm adaptive converged_frac {conv}"


def _launched_on(body, solve):
    """Runs ``solve()`` and checks that it launched the kernel once, on
    ``body``; returns its result."""
    before = dict(solve_batch_fused.body_launches)
    out = solve()
    torch.cuda.synchronize()
    after = solve_batch_fused.body_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == body) for k in after}
    return out


@pytest.mark.parametrize("mode", [dict(n_iter=3), dict(adaptive=True)],
                         ids=["fixed3", "adaptive"])
def test_ltv_block_body_b1_on_gpu(cuda, mode):
    """``Ltv<8,4>`` at B=1, the LTV single robot's warm solve: the rule
    picks the block body, the launch runs there, and its result is the
    plain version's on the same inputs (max |dX|, |dU| <= 1e-4, statuses
    equal), from the kernel's cold plan at x0 + 0.01."""
    prob, p, opts = _setup(cuda, ltv=True, seed=4, batch=1)
    assert card_body(prob, 1) == ("block", 256)
    mu_cold, mu_warm = _mu(opts)
    cold = solve_batch_fused(prob, p, None, None, opts, mu0=mu_cold,
                             adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.01)
    rk = _launched_on("block", lambda: solve_batch_fused(
        prob, p2, cold.X, cold.U, opts, mu0=mu_warm, **mode))
    rp = solve_batch_fused_plain(prob, p2, cold.X, cold.U, opts,
                                 mu0=mu_warm, **mode)
    assert _held(rk, rp) <= PLAIN_BAND
    assert torch.equal(rk.status, rp.status)


def _chain(nq):
    """A chain of nq pendulums coupled by springs (chip_smoke.py's
    generated LTV cases): an LTV model at (2 nq, nq)."""
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        left = torch.cat([q[:1], q[:-1]])
        right = torch.cat([q[1:], q[-1:]])
        return torch.cat([qd, u - torch.sin(q) - 0.1 * qd
                          + 0.5 * ((left - 2.0 * q) + right)])
    return Dynamics(f"chain{nq}", 2 * nq, nq, f, supports_lanes=True, nq=nq)


@pytest.mark.parametrize("nq, body", [(6, ("group", 4)), (3, ("thread", 1))],
                         ids=["ltv_12x6", "ltv_6x3"])
def test_generated_ltv_body_on_gpu(cuda, nq, body):
    """The generated LTV (12, 6) on the four-lane group body (more controls
    than lanes) and (6, 3) on the one-thread body (two lanes lost there),
    at the services' B=16384 (N=25, dt=20 ms, |u| <= 20): the launches run
    on the rule's body, and the fixed-3 warm solve from the kernel's cold
    plan is the plain version's (max |dX|, |dU| <= 1e-4, statuses equal on
    >= 99 %)."""
    dyn = _chain(nq)
    mp = ModelParameters("gpu_chain", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=0.02, num_shooting_nodes=25,
                         u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
                         is_linear=True)
    prob = make_problem(mp, dyn)
    assert card_body(prob) == body
    p = _batch(cuda, dyn, mp, 16384, 5, [10.0] * dyn.nx)
    opts = SolverOptions(tol=1e-4, max_iter=30)
    mu_cold, mu_warm = _mu(opts)
    cold = _launched_on(body[0], lambda: solve_batch_fused(
        prob, p, None, None, opts, mu0=mu_cold, adaptive=True))
    assert (cold.status == 0).float().mean().item() >= 0.99
    p2 = p._replace(x0=p.x0 + 0.01)
    rk = _launched_on(body[0], lambda: solve_batch_fused(
        prob, p2, cold.X, cold.U, opts, mu0=mu_warm, n_iter=3))
    rp = solve_batch_fused_plain(prob, p2, cold.X, cold.U, opts,
                                 mu0=mu_warm, n_iter=3)
    assert _held(rk, rp) <= PLAIN_BAND
    assert (rk.status == rp.status).float().mean().item() >= 0.99


def _vdp(x, u):
    """chip_smoke.py's Van der Pol oscillator (mu = 1)."""
    return torch.stack([x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]])


# A user's own models (chip_smoke.py phase 23): (Dynamics, integrator,
# |u| bound).
USER = {"user_chain4": (_chain(4), "euler", 20.0),
        "user_vdp": (Dynamics("user_vdp", 2, 1, _vdp, supports_lanes=True),
                     "rk4", 5.0)}


@pytest.mark.parametrize("mode", [dict(n_iter=3), dict(adaptive=True)],
                         ids=["fixed3", "adaptive"])
@pytest.mark.parametrize("name", list(USER))
def test_generated_block_body_b1_on_gpu(cuda, name, mode):
    """A user's own model at B=1 (N=25, dt=20 ms), the single robot's warm
    solve through its generated instantiation: the rule picks the block
    body, the launch runs there, and its result is the plain version's on
    the same inputs (max |dX|, |dU| <= 1e-4, statuses equal), from the
    kernel's cold plan at x0 + 0.01."""
    dyn, integrator, ulim = USER[name]
    mp = ModelParameters("gpu_user", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=0.02, num_shooting_nodes=25,
                         u_min=[-ulim] * dyn.nu, u_max=[ulim] * dyn.nu,
                         integrator=integrator)
    prob = make_problem(mp, dyn)
    assert card_body(prob, 1) == ("block", 256)
    p = _batch(cuda, dyn, mp, 1, 6, [10.0] * dyn.nx)
    opts = SolverOptions(tol=1e-4, max_iter=30)
    mu_cold, mu_warm = _mu(opts)
    cold = _launched_on("block", lambda: solve_batch_fused(
        prob, p, None, None, opts, mu0=mu_cold, adaptive=True))
    p2 = p._replace(x0=p.x0 + 0.01)
    rk = _launched_on("block", lambda: solve_batch_fused(
        prob, p2, cold.X, cold.U, opts, mu0=mu_warm, **mode))
    rp = solve_batch_fused_plain(prob, p2, cold.X, cold.U, opts,
                                 mu0=mu_warm, **mode)
    assert _held(rk, rp) <= PLAIN_BAND
    assert torch.equal(rk.status, rp.status)
