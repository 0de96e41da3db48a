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
  ``FastNq<ArmModel<4>>`` at B = 16384 and 65536 on the four-lane group
  body (the service's batches, fixed-3 and adaptive warm solves),
  ``Ltv<8,4>`` at B=1 on the block body (the LTV single robot's warm
  ``calc_u``), the generated LTV (12, 6) and (6, 3) at B=16384 on the
  body the rule names (the four-lane group over more controls than lanes;
  one thread), and a user's own model at B=1 on the block body
  (``user_chain4``: ``FastNq<gen::Model>``, nx = 8, nu = 4;
  ``user_vdp``: ``Generic<gen::Model>`` under RK4).
- The preparation kernel (``csrc/fused_prepare.cuh``): its inputs bit for
  bit the PyTorch preparation's on the CPU at B = 1, 33 (not a multiple of
  the tile) and 16384; a card solve, nonlinear and LTV, bit for bit the
  same kernel's fed by the PyTorch preparation and copies that ran before
  it; one device operation under ``fused.prepare`` (with
  ``fused.copy_in``) a solve; one preparation counted a counted launch.
"""

import numpy as np
import pytest
import torch
from torch.func import vmap

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.ops.precision import strict_fp32
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.solver import fused
from mahi_mpc_tpu_torch.solver import loop_common as lc
from mahi_mpc_tpu_torch.solver.batched import solve_batch_lanes
from mahi_mpc_tpu_torch.solver.fused import (card_body, solve_batch_fused,
                                             solve_batch_fused_plain)
from mahi_mpc_tpu_torch.solver.linearize import ltv_discrete
from mahi_mpc_tpu_torch.solver.sqp import _start
from mahi_mpc_tpu_torch.solver.target import kernel_target
from mahi_mpc_tpu_torch.utils.profiling import clear_spans, spans
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


@pytest.mark.parametrize("mode", [dict(n_iter=3), dict(adaptive=True)],
                         ids=["fixed3", "adaptive"])
@pytest.mark.parametrize("batch", [16384, 65536])
def test_main_path_group_body_on_gpu(cuda, batch, mode):
    """``FastNq<ArmModel<4>>`` at the service's batches, where each lane
    forms its stage's q and qd columns from one sweep of the chain
    (``arm_q_qd_columns``): the rule picks the four-lane group body, the
    launch runs there, and its result is the plain version's on the same
    inputs (max |dX|, |dU| <= 1e-4, statuses equal), from the kernel's
    cold plan at x0 + 0.01."""
    prob, p, opts = _setup(cuda, seed=5, batch=batch)
    assert card_body(prob, batch) == ("group", 4)
    mu_cold, mu_warm = _mu(opts)
    cold = solve_batch_fused(prob, p, None, None, opts, mu0=mu_cold,
                             adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.01)
    rk = _launched_on("group", lambda: solve_batch_fused(
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


# ---- the preparation kernel --------------------------------------------------

def _same_bits(a, b):
    """Equal bit for bit, any NaN matching any NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _mixed(prob, p, seed):
    """``p`` with boxes of every kind by instance (x finite, lower-only,
    open; u finite, upper-only; every fourth instance unbounded) and a
    warm start 3 N(0, 1) with NaN and +-inf in it."""
    g = torch.Generator(device=p.x0.device).manual_seed(seed)
    B, N, nx, nu = p.x0.shape[0], prob.N, prob.nx, prob.nu
    inf = float("inf")
    kind = torch.arange(B, device=p.x0.device)[:, None]
    full = lambda v, n: torch.full((B, n), v, device=p.x0.device)
    x_min = torch.where(kind % 3 == 2, -inf, full(-1.5, nx))
    x_max = torch.where(kind % 3 >= 1, inf, full(0.001, nx))
    u_min = torch.where(kind % 2 == 1, -inf, full(-20.0, nu))
    u_max = full(20.0, nu)
    off = (kind % 4 == 3)
    p = p._replace(x_min=torch.where(off, -inf, x_min),
                   x_max=torch.where(off, inf, x_max),
                   u_min=torch.where(off, -inf, u_min),
                   u_max=torch.where(off, inf, u_max))
    spike = lambda t: torch.where(
        torch.rand(t.shape, generator=g, device=t.device) < 0.02,
        torch.tensor([float("nan"), inf, -inf], device=t.device)[
            torch.randint(0, 3, t.shape, generator=g, device=t.device)], t)
    X0 = spike(3.0 * torch.randn(B, N + 1, nx, generator=g,
                                 device=p.x0.device))
    U0 = spike(3.0 * torch.randn(B, N, nu, generator=g, device=p.x0.device))
    return p, X0, U0


@pytest.mark.parametrize("batch", [1, 33, 16384])
def test_card_preparation_is_the_pytorch_preparation(cuda, batch):
    """The preparation kernel's 14 batch-innermost inputs are bit for bit
    ``sqp._start``'s (``_strict_interior``, ``mu_start``) with each input's
    ``movedim(0, -1).contiguous()``, computed by PyTorch on the CPU."""
    prob, p, opts = _setup(cuda, seed=8, batch=batch)
    p, X0, U0 = _mixed(prob, p, 8)
    _, mu_warm = _mu(opts)
    (_, ws), _ = fused._prepare_cuda(prob, opts, p, X0, U0, mu_warm,
                                     fused.LS_FAN_FIXED)
    host = lambda t: t.cpu()
    ph = p._replace(**{k: host(getattr(p, k)) for k in p._fields
                       if k != "lin"})
    Xr, Ur, mur = _start(prob, ph, host(X0), host(U0), opts, mu_warm)
    want = [t.movedim(0, -1).contiguous() for t in (
        Xr, Ur, ph.x_des, ph.q, ph.r, ph.rm, ph.u_prev, ph.u_min, ph.u_max,
        ph.x_min, ph.x_max, ph.qf, ph.xf_des, mur)]
    for k, (a, b) in enumerate(zip(ws.ins, want)):
        assert _same_bits(a.cpu(), b), k
    assert (mur == opts.mu_min).any() == (batch >= 4)


def _old_route(prob, p, X0, U0, opts, mu0, n_iter):
    """The card solve as it ran before the preparation kernel: PyTorch's
    preparation (``sqp._start``) and a batch-innermost copy of each input
    (``movedim(0, -1).contiguous()``), then the same solve kernel and
    status rules."""
    Xs, Us, mu = _start(prob, p, X0, U0, opts, mu0)
    lanes = lambda t: t.movedim(0, -1).contiguous()
    ws = fused._workspace(prob, Xs.shape[0], Xs.dtype, Xs.device)
    ws = ws._replace(ins=[lanes(t) for t in (
        Xs, Us, p.x_des, p.q, p.r, p.rm, p.u_prev, p.u_min, p.u_max,
        p.x_min, p.x_max, p.qf, p.xf_des, mu)])
    with strict_fp32():
        ltv = ltv_discrete(prob, p) if prob.is_linear else None
        X, U, st = fused._launch_cuda(prob, opts, p,
                                      (kernel_target(prob).cuda, ws),
                                      n_iter, fused.LS_FAN_FIXED, False, ltv)
    return fused._status(opts, X, U, st, mu, lc.mu_floor(opts), n_iter,
                         False)


@pytest.mark.parametrize("ltv", [False, True], ids=["nonlinear", "ltv"])
def test_card_solve_is_the_old_routes(cuda, ltv):
    """The fixed-3 warm solve at B=1024 from the kernel's cold plan, with
    NaN and +-inf spikes in a copy of that plan: X, U and status bit for
    bit what the same kernel gives fed by the PyTorch preparation."""
    prob, p, opts = _setup(cuda, ltv=ltv, seed=9)
    mu_cold, mu_warm = _mu(opts)
    cold = solve_batch_fused(prob, p, None, None, opts, mu0=mu_cold,
                             adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.01)
    U0 = torch.where(torch.arange(B, device=cuda)[:, None, None] % 97 == 5,
                     float("nan"), cold.U)
    new = solve_batch_fused(prob, p2, cold.X, U0, opts, mu0=mu_warm,
                            n_iter=3)
    old = _old_route(prob, p2, cold.X, U0, opts, mu_warm, 3)
    assert _same_bits(new.X, old.X) and _same_bits(new.U, old.U)
    assert torch.equal(new.status, old.status)


def test_preparation_is_one_device_operation(cuda):
    """Under ``torch.profiler``, a fixed-3 solve at B=16384 launches one
    device operation, the preparation kernel, from inside
    ``fused.prepare`` (which holds ``fused.copy_in``): the device
    operations whose launch call lies in the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prob, p, opts = _setup(cuda, seed=10, batch=16384)
    _, mu_warm = _mu(opts)
    solve_batch_fused(prob, p, None, None, opts, mu0=mu_warm, n_iter=3)
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):        # test_torch_gpu_spans.py LEAD_OPS
            torch.cuda._sleep(1)
        solve_batch_fused(prob, p, None, None, opts, mu0=mu_warm, n_iter=3)
        torch.cuda.synchronize()
    prep = [s for s in spans() if s.name == "fused.prepare"]
    copy_in = [s for s in spans() if s.name == "fused.copy_in"]
    assert len(prep) == len(copy_in) == 1
    assert copy_in[0].parent == prep[0].id
    events = prof.profiler.kineto_results.events()
    inside = {e.correlation_id() for e in events
              if e.device_type() == DeviceType.CPU
              and e.name().startswith("cuda") and e.correlation_id()
              and prep[0].start_ns <= e.start_ns() <= prep[0].end_ns}
    ops = [e.name() for e in events if e.device_type() == DeviceType.CUDA
           and e.correlation_id() in inside]
    assert len(ops) == 1 and "fused_prepare_tile_kernel" in ops[0], ops


def test_one_preparation_a_launch(cuda):
    """On the card route ``solve_batch_fused.prepare_launches`` rises with
    ``solve_batch_fused.launches``, one for one: a service's cold adaptive
    step and two warm fixed-3 steps, nonlinear and LTV, and a solve at
    B=1 on the block body."""
    before = (solve_batch_fused.prepare_launches, solve_batch_fused.launches)
    for is_linear in (False, True):
        mp = ModelParameters("count", num_x=8, num_u=4, step_size=0.002,
                             num_shooting_nodes=25, u_min=[-20.0] * 4,
                             u_max=[20.0] * 4, dynamics_name="mahi_arm",
                             is_linear=is_linear)
        svc = BatchModelControl(mp, batch=256, device=cuda,
                                Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
                                Rm=[0.01] * 4,
                                opts=SolverOptions(tol=1e-4, max_iter=30,
                                                   fixed_warm_iters=3))
        svc.set_states(0.2 * torch.randn(256, 8, device=cuda))
        for _ in range(3):
            svc.step()
    prob, p, opts = _setup(cuda, seed=11, batch=1)
    _launched_on("block", lambda: solve_batch_fused(
        prob, p, None, None, opts, mu0=_mu(opts)[1], n_iter=3))
    after = (solve_batch_fused.prepare_launches, solve_batch_fused.launches)
    assert after[0] - before[0] == after[1] - before[1] == 7
