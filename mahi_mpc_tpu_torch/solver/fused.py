"""Fused SQP solve: the whole batched MPC solve in one kernel launch.

Port of ``mahi_mpc_tpu/solver/fused.py``.  ``solve_batch_fused`` runs, per
instance, the SQP of the JAX package's Pallas kernel (``_make_kernel``):
each iteration linearizes the discrete step, builds the block-form stage
QP with log-barrier box terms, solves it by a block Riccati recursion over
(Pxx, Pxv, Pvv, px, pv), rolls the step forward with the
fraction-to-boundary cap, and takes the largest Armijo-passing rung of a
parallel fan on the l1 merit.  Two iteration modes share it:

- **fixed** (``adaptive=False``): exactly ``n_iter`` iterations at fixed
  barrier and regularization — the warm receding-horizon shape;
- **adaptive** (``adaptive=True``): barrier continuation, regularization
  ladder and per-instance CONVERGED / DIVERGED / MAX_ITER status, with an
  early exit once an instance is done — cold starts and adaptive warm
  re-solves.

and three step modes, as in the JAX kernel:

- **fast** (Euler step of a second-order model, JAX's nq-row rule): only the
  nq acceleration rows of the step Jacobian need AD;
- **generic** (midpoint, rk4): all nx rows through the integrator step;
- **ltv** (``prob.is_linear``, reference C8): the exact affine step
  ``Ad x + Bd u + cd`` of the frozen linearization, computed once per solve
  (``linearize.ltv_discrete``: its own kernel on the card, batch-innermost
  as the solve streams it) and streamed in as ``(Ad - I, Bd, cd)``; no AD.

Every step mode gives the step's increment ``F(x, u) - x``, formed
directly, and every defect is formed as ``(x - x') + increment``
(``_solve_batch_fused_plain`` says why); the JAX kernel forms
``F(x) - x'``, which agrees in float64 and crawls in float32.

Two implementations of the same function live here:

- the CUDA kernel (``csrc/fused_sqp*.cu``, batch-innermost arrays), built
  with nvcc at first use (``_build.py``), launched for CUDA tensors.  Its
  body is the block body at small batch for the 4-DOF arm and the double
  pendulum under Euler and for LTV at (8, 4) (``csrc/fused_sqp_block.cuh``:
  a thread block an instance, the instance in shared memory: the single
  robot's warm ``calc_u``, LTV or not, and the reference's default
  example), else the group body (``csrc/fused_sqp_group.cuh``: four
  threads an instance for the serial arms under every integrator, the main
  path, and LTV where nx is a multiple of 4 from 8 up, (8, 4) and any
  generated shape such as (12, 6), whatever nu; two for most closed forms
  under midpoint and RK4, the double pendulum under Euler and a generated
  model's generic step where its shape splits over two lanes) or one
  thread an instance otherwise, as the launcher's own rule (``BlockBody``,
  ``GroupBody``: the policy, B and N) picks it: ``card_body`` asks it.
  Hand-written instantiations serve LTV at the (nx, nu) in ``LTV_SHAPES``
  and the nonlinear modes of the six registered models (their dynamics
  written again in ``csrc/model_dynamics.cuh``); every other problem the
  JAX rule fuses (any LTV shape, any lanes-polymorphic ``f`` that
  ``models/codegen.py`` lowers) gets a generated instantiation, its model
  emitted as C++ from the traced ``f`` and compiled at first use
  (``target.kernel_target`` decides which instantiation serves a
  problem);
- ``_solve_batch_fused_plain``, the plain PyTorch version in batch-leading
  tensor form, used for CPU tensors and as the kernel's reference on the
  card.

Every build of the kernel, nvcc's and g++'s, has its inputs prepared by
a kernel too (``csrc/fused_prepare.cuh``; ``_prepare_cuda``,
``_prepare_cpu``): one launch clips the warm start into the interior, sets
the barrier's start and writes every input batch-innermost, bit for bit
what the plain version's preparation (``sqp._start``) gives.

There is no fallback from one to the other: a problem the kernel does not
serve raises on CUDA tensors (``fused_supported`` says which it serves),
and so does a failed build or launch.

Line-search deviations from the JAX lanes solver follow the JAX fused
kernel (a fan of rungs, and an l1 weight from max|p|); the one deliberate
difference from the JAX fused kernel is the status precedence when an
instance converges and diverges in the same iteration: converged wins, as
in the lanes solver.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers
from typing import NamedTuple, Optional, Sequence

import torch
from torch.func import jvp, vmap

from .. import _build
from ..models.integrators import make_increment
from ..ops.linalg import chol_lanes
from ..ops.precision import strict_fp32
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem
from ..utils.profiling import annotate
from . import linearize
from . import loop_common as lc
from .batched import _fan_jacobian
from .sqp import (CONVERGED, DIVERGED, INTERIOR_DELTA, MAX_ITER, SolveResult,
                  _start)
from .stage_qp import barrier_terms
from .target import INTEGRATORS, KernelTarget, kernel_target, step_mode

Tensor = torch.Tensor

# Line-search fans, as in the JAX package: the fixed-mode fan includes the
# 0.0625 rung; the adaptive fan reaches ~2.4e-4, the depth of the lanes
# solver's 12-halving backtracking, for hard cold starts.
LS_FAN_FIXED = (1.0, 0.5, 0.25, 0.0625)
LS_FAN_ADAPTIVE = (1.0, 0.5, 0.25, 0.0625, 0.015625, 0.00390625,
                   0.0009765625, 0.000244140625)
MAX_FAN = 8               # csrc/fused_sqp.cuh kMaxFan


def fused_supported(prob: ShootingProblem) -> bool:
    """Whether the kernel serves this problem (``target.kernel_target``):
    the JAX rule (``fused.py:173-179``) under ``target.INTEGRATORS``.
    Every LTV problem (any (nx, nu)); every nonlinear problem whose
    dynamics are lanes-polymorphic, when the kernel has them in CUDA (the
    serial arms with nq 2 or 4 and the four closed-form models) or
    ``models/codegen.py`` lowers their ``f`` (decided by tracing, before
    anything is built)."""
    return kernel_target(prob) is not None


def _check_kernel(prob: ShootingProblem,
                  fan: Sequence[float] = ()) -> KernelTarget:
    """The problem's instantiation; raises where no build of the kernel
    serves the problem or the fan."""
    target = kernel_target(prob)
    if target is None:
        raise ValueError(
            f"no instantiation of the fused kernel serves {prob.dynamics.name!r}"
            f" (is_linear={prob.is_linear}, integrator={prob.integrator!r}); "
            f"see fused_supported()")
    if len(fan) > MAX_FAN:
        raise ValueError(f"at most {MAX_FAN} line-search rungs, got {len(fan)}")
    return target


# The kernel's bodies by the launcher's code (csrc/fused_sqp_block.cuh
# `Body`).
BODIES = ("thread", "group", "block")


def card_body(prob: ShootingProblem, B: Optional[int] = None) -> tuple:
    """The kernel body the card runs for B instances of a problem the
    kernel serves, and its threads an instance: ``("block", 256)`` (the
    block body, ``csrc/fused_sqp_block.cuh``: one instance a block, at
    small batch for the policies ``BlockBody`` names), ``("group", 4)`` or
    ``("group", 2)`` (the group body, ``csrc/fused_sqp_group.cuh``, at its
    step policy's width) or ``("thread", 1)`` (one thread an instance).
    ``B=None``: the body at full occupancy, past every policy's block-body
    threshold.  The launcher's own rule (``mpc::card_body``: the policy,
    B and ``prob.N``) decides it, asked through the g++ build of
    ``csrc/flop_count.cpp`` (the problem's generated build, for a generated
    instantiation).  In LTV: the block body at (8, 4) up to B=264, four
    lanes where nx is a multiple of 4 from 8 up and a block's 32 tiles fit
    in its shared memory, one thread otherwise.  A user's model (a
    generated ``FastNq`` or ``Generic`` over ``gen::Model``): the block
    body at small batch where its shape splits over the policy's two lanes
    (nx even; a lane owns controls l, l + 2, ..., so any nu), else, and
    past the policy's threshold, the body it runs at full occupancy (two
    lanes for ``Generic`` where nu <= 2, one thread otherwise); a shape
    that does not split (the unicycle's nx = 3) runs one thread at every
    B."""
    target = _check_kernel(prob)
    threads = ctypes.c_int(0)
    kind = _build.cpu_library(
        target.generated or "flop_count").mpc_fused_card_body(
        target.model, prob.nx, prob.nu, INTEGRATORS.index(prob.integrator),
        int(prob.is_linear), 2 ** 62 if B is None else int(B), prob.N,
        ctypes.byref(threads))
    if kind < 0:
        raise ValueError(f"the kernel holds no instantiation for model "
                         f"{target.model}, (nx, nu) = ({prob.nx}, {prob.nu})")
    return BODIES[kind], threads.value


# ---------------------------------------------------------------------------
# The plain PyTorch version (batch-leading tensors).
# ---------------------------------------------------------------------------

def _ssum(t: Tensor) -> Tensor:
    """Sum over the last dim left to right, the kernel's order."""
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _bar_value(v, lo, hi, mu):
    """-mu sum(log(v - lo) + log(hi - v)) over the last dim."""
    lf, hf = torch.isfinite(lo), torch.isfinite(hi)
    slo = torch.where(lf, torch.clamp(v - lo, min=1e-30), 1.0)
    shi = torch.where(hf, torch.clamp(hi - v, min=1e-30), 1.0)
    return _ssum(-mu * (torch.where(lf, torch.log(slo), 0.0)
                        + torch.where(hf, torch.log(shi), 0.0)))


def _ftb(v, dv, lo, hi, amax):
    """Fraction-to-boundary cap folded into amax (NaN-propagating)."""
    neg, pos = dv < 0, dv > 0
    a_lo = torch.where(torch.isfinite(lo) & neg,
                       (-lc.FTB_TAU * (v - lo)) / torch.where(neg, dv, -1.0),
                       1.0)
    a_hi = torch.where(torch.isfinite(hi) & pos,
                       (lc.FTB_TAU * (hi - v)) / torch.where(pos, dv, 1.0),
                       1.0)
    return torch.minimum(amax, torch.amin(torch.minimum(a_lo, a_hi), dim=-1))


def _cho_solve_rows(L: Tensor, Y: Tensor) -> Tensor:
    """Solve (L L') X = Y, L (n, n, B) lower, Y (n, C, B), by reciprocal
    multiplies (the order of ops/elem.py cho_solve_rows)."""
    n = L.shape[0]
    inv = [1.0 / L[i, i] for i in range(n)]
    y: list = [None] * n
    for i in range(n):
        row = Y[i]
        for k in range(i):
            row = row - L[i, k] * y[k]
        y[i] = row * inv[i]
    x: list = [None] * n
    for i in reversed(range(n)):
        row = y[i]
        for k in range(i + 1, n):
            row = row - L[k, i] * x[k]
        x[i] = row * inv[i]
    return torch.stack(x, dim=0)


def _acc_jacobian(dyn, x: Tensor, u: Tensor):
    """f at M states and the Jacobian rows of its acceleration block:
    x (M, nx), u (M, nu) -> fval (M, nx), J (M, nq, nx + nu).

    One forward-mode pass per input direction (``jvp``, vmapped over the
    basis) through the trailing-batch ``f``.  Keeping the batch inside f
    also keeps every intermediate at least 1-D: forward-mode AD promotes a
    0-d tangent times a python float to float64."""
    nx, nq = dyn.nx, dyn.nq
    xt, ut = x.T, u.T
    M = x.shape[0]
    basis = torch.eye(nx + u.shape[1], dtype=x.dtype, device=x.device)

    def tangent(e):
        return jvp(dyn.f, (xt, ut), (e[:nx, None].expand(-1, M),
                                     e[nx:, None].expand(-1, M)))[1]

    J = vmap(tangent)(basis)                      # (nz, nx, M)
    return dyn.f(xt, ut).T, J[:, nq:].permute(2, 1, 0)


def _plain_step(prob: ShootingProblem, ltv):
    """The plain version's step mode (the kernel's step policy), as three
    functions over batch-leading tensors:

    - ``linearize(xs, us)``: xs (B, N, nx), us (B, N, nu) -> the step's
      increment F(x, u) - x (B, N, nx), A (B, N, nx, nx), Bm (B, N, nx, nu)
      and the rows the rollout reuses;
    - ``next_dx(k, dx, du, ck_k, rows)``: dx (B, nx), du (B, nu) ->
      (dx + (A - I) dx + B du) + ck_k at stage k;
    - ``value(xt, ut)``: the increment at trial points (B, ..., nx).

    Sums run left to right in the kernel's order (``_ssum``)."""
    dyn = prob.dynamics
    nx, nu, nq = prob.nx, prob.nu, dyn.nq
    nz = nx + nu
    dt = float(prob.dt)
    lanes = lambda x, n: x.reshape(-1, n).T          # (..., n) -> (n, M)
    if prob.is_linear:
        AdI, Bd, cd = ltv              # (B, nx, nx), (B, nx, nu), (B, nx)
        A = torch.eye(nx, dtype=AdI.dtype, device=AdI.device) + AdI

        def rows_of(x, u):
            """(Ad - I) x + Bd u for x (B, ..., nx), u (B, ..., nu), each
            dot product left to right as the kernel sums it."""
            mid = (1,) * (x.dim() - 2)
            A_, B_ = AdI.view(-1, *mid, nx, nx), Bd.view(-1, *mid, nx, nu)
            return _ssum(A_ * x[..., None, :]) + _ssum(B_ * u[..., None, :])

        def linearize(xs, us):
            Bsz, N = xs.shape[:2]
            return (rows_of(xs, us) + cd[:, None],
                    A[:, None].expand(Bsz, N, nx, nx),
                    Bd[:, None].expand(Bsz, N, nx, nu), None)

        def next_dx(k, dx, du, ck_k, rows):
            return (dx + rows_of(dx, du)) + ck_k

        def value(xt, ut):
            return rows_of(xt, ut) + cd.view(-1, *(1,) * (xt.dim() - 2), nx)
    elif step_mode(prob) == "fast":
        def linearize(xs, us):
            Bsz, N = xs.shape[:2]
            kw = dict(dtype=xs.dtype, device=xs.device)
            fval, Jac = _acc_jacobian(dyn, xs.reshape(-1, nx),
                                      us.reshape(-1, nu))
            rows = dt * Jac.reshape(Bsz, N, nq, nz)   # dt-scaled acc rows
            A = torch.eye(nx, **kw).repeat(Bsz, N, 1, 1)
            A[:, :, :nq, nq:] += dt * torch.eye(nq, **kw)
            A[:, :, nq:, :] += rows[..., :nx]
            Bm = torch.zeros(Bsz, N, nx, nu, **kw)
            Bm[:, :, nq:, :] = rows[..., nx:]
            return dt * fval.reshape(Bsz, N, nx), A, Bm, rows

        def next_dx(k, dx, du, ck_k, rows):
            dzin = torch.cat([dx, du], dim=1)
            return torch.cat([
                (dx[:, :nq] + dt * dx[:, nq:]) + ck_k[:, :nq],
                (dx[:, nq:] + (rows[:, k] @ dzin[..., None])[..., 0])
                + ck_k[:, nq:]], dim=1)

        def value(xt, ut):
            fv = dyn.f(lanes(xt, nx), lanes(ut, nu)).T
            return fv.reshape(xt.shape) * dt        # the Euler increment
    else:
        inc = make_increment(dyn.f, dt, prob.integrator)

        def linearize(xs, us):
            # the increment's rows [A - I | B]; the body's A is I + them
            Bsz, N = xs.shape[:2]
            val, J = _fan_jacobian(prob, torch.cat(
                [lanes(xs, nx), lanes(us, nu)], dim=0), inc)
            J = J.permute(2, 0, 1).reshape(Bsz, N, nx, nz)
            eye = torch.eye(nx, dtype=xs.dtype, device=xs.device)
            return (val.T.reshape(Bsz, N, nx), eye + J[..., :nx],
                    J[..., nx:], J)

        def next_dx(k, dx, du, ck_k, rows):
            dzin = torch.cat([dx, du], dim=1)
            return (dx + _ssum(rows[:, k] * dzin[:, None, :])) + ck_k

        def value(xt, ut):
            return inc(lanes(xt, nx), lanes(ut, nu)).T.reshape(xt.shape)
    return linearize, next_dx, value


def _solve_batch_fused_plain(prob: ShootingProblem, opts: SolverOptions,
                             p: MPCParams, start: tuple, n_iter: int,
                             fan: Sequence[float], adaptive: bool, ltv=None):
    """The fused solve in plain PyTorch from ``start`` = (X, U, mu)
    (``_prepare_plain``): returns X, U and the (B, 8) stats [stepn, feas,
    jref, alpha, mu, done, iters, 0] of the kernel.  ``ltv`` is the
    streamed (Ad - I, Bd, cd) in LTV mode."""
    X, U, mu = start
    nx, nu, N = prob.nx, prob.nu, prob.N
    nz = nx + nu
    B = X.shape[0]
    dtype, device = X.dtype, X.device
    n_pin = int(opts.num_control_inputs_saved)
    tol, floor, kappa = float(opts.tol), lc.mu_floor(opts), float(opts.kappa_mu)
    fan_t = torch.as_tensor(fan, dtype=dtype, device=device)
    full = lambda v: torch.full((B,), v, dtype=dtype, device=device)

    q, r, rm, qf = p.q, p.r, p.rm, p.qf                     # (B, n)
    q2, r2, rm2, qf2 = 2.0 * q, 2.0 * r, 2.0 * rm, 2.0 * qf
    xlo, xhi = p.x_min[:, None], p.x_max[:, None]           # (B, 1, nx)
    ulo, uhi = p.u_min[:, None], p.u_max[:, None]
    xdes = p.x_des                                          # (B, N, nx)
    xdes_prev = torch.cat([xdes[:, :1], xdes[:, :-1]], dim=1)
    tk = torch.arange(N, device=device) >= 1                # (N,)
    eye_nu = torch.eye(nu, dtype=dtype, device=device)
    linearize, next_dx, step_increment = _plain_step(prob, ltv)

    def stage_cost(x, u, du, e, tkm, mu_b, w):
        """Stage cost + barriers and the rate/magnitude term; x (..., nx);
        ``w`` reshapes a (B, n) weight to broadcast against x."""
        c = _ssum(torch.where(tkm[..., None], w(q) * (e * e), 0.0))
        rate = _ssum(torch.stack([w(r) * (du * du), w(rm) * (u * u)],
                                 dim=-1).flatten(-2))
        bx = _bar_value(x, w(p.x_min), w(p.x_max), mu_b[..., None])
        c = c + torch.where(tkm, bx, 0.0)
        c = c + _bar_value(u, w(p.u_min), w(p.u_max), mu_b[..., None])
        return c + rate, rate

    X, U = X.clone(), U.clone()
    reg, nu_pen = full(lc.REG_MIN), full(1.0)
    done, iters = full(0.0), full(0.0)
    stepn = feas = jref = alpha = full(float("inf"))
    for _ in range(n_iter):
        live = done < 0.5 if adaptive else torch.ones_like(done, dtype=torch.bool)
        if adaptive and not bool(live.any()):
            break
        mu_c = mu[:, None]

        # ---- linearize every stage at once: increment, defect, Jacobians.
        # Every defect is (x - x') + increment: x and x' differ by about the
        # increment, so their float32 rounding stays out of it.  (As
        # F(x) - x' it carries ~ulp(x) a component, which the l1 merit
        # weights by nu_pen: near convergence that noise exceeded the Armijo
        # noise floor, rejected full steps and grew reg until the damped
        # step passed tol away from the solution, the float32 crawl.)
        xs = X[:, :N]
        inc, A, Bm, rows = linearize(xs, U)
        ck = (xs - X[:, 1:]) + inc
        val = xs + inc

        # ---- stage gradients, diagonal, costs (all stages at once)
        ukm1 = torch.cat([p.u_prev[:, None], U[:, :-1]], dim=1)
        e = xs - xdes_prev
        du = U - ukm1
        gx_b, hx_b = barrier_terms(xs, xlo, xhi, mu_c[..., None])
        gu_b, hu_b = barrier_terms(U, ulo, uhi, mu_c[..., None])
        tk3 = tk[None, :, None]
        gzx = torch.where(tk3, q2[:, None] * e + gx_b, 0.0)
        gzv = -(r2[:, None] * du)
        gu = (r2[:, None] * du + rm2[:, None] * U) + gu_b
        Dx = torch.where(tk3, q2[:, None] + hx_b, 0.0)
        Du = (r2 + rm2)[:, None] + (hu_b + reg[:, None, None])
        w3 = lambda t: t[:, None]
        sc, rate = stage_cost(xs, U, du, e, tk[None], mu_c, w3)
        er = val - xdes
        jr = _ssum(torch.cat([rate[..., None], q[:, None] * (er * er)], -1))

        # ---- terminal cost-to-go
        xN = X[:, N]
        eN, eF = xN - xdes[:, N - 1], xN - p.xf_des
        gN_b, hN_b = barrier_terms(xN, p.x_min, p.x_max, mu_c)
        Pxx = torch.diag_embed((q2 + qf2) + hN_b)
        Pxv = torch.zeros(B, nx, nu, dtype=dtype, device=device)
        Pvv = torch.zeros(B, nu, nu, dtype=dtype, device=device)
        px = (q2 * eN + qf2 * eF) + gN_b
        pv = torch.zeros(B, nu, dtype=dtype, device=device)
        G_N = px
        cost0 = _ssum(torch.cat([
            _bar_value(xN, p.x_min, p.x_max, mu_c)[:, None],
            torch.stack([q * (eN * eN), qf * (eF * eF)], dim=-1).flatten(1)],
            dim=1))
        # The kernel accumulates the stage terms in its backward sweep,
        # k = N-1 down to 0, after the terminal ones.
        back = lambda t: t.flip(1)
        cost0 = _ssum(torch.cat([cost0[:, None], back(sc)], dim=1))
        jref_old = _ssum(torch.cat([_ssum(qf * (eF * eF))[:, None],
                                    back(jr)], dim=1))
        feas_i = torch.amax(ck.abs(), dim=(1, 2))
        c_l1 = _ssum(back(ck).abs().flatten(1))
        pmax = torch.amax(px.abs(), dim=1)

        # ---- backward Riccati sweep: Az = [[A,0],[0,0]], Bz = [[B],[I]],
        # Hzz = diag[Dx, 2R], Hzu = [[0],[-2R]]
        K_all = torch.empty(B, N, nu, nz, dtype=dtype, device=device)
        kff_all = torch.empty(B, N, nu, dtype=dtype, device=device)
        for k in reversed(range(N)):
            Ak, Bk, ckk = A[:, k], Bm[:, k], ck[:, k, :, None]
            Prp_x = px + (Pxx @ ckk)[..., 0]
            Prp_v = pv + (Pxv.mT @ ckk)[..., 0]
            PxxB = Pxx @ Bk
            M1 = PxxB + Pxv
            Qxx = Ak.mT @ (Pxx @ Ak)
            Qxx = torch.triu(Qxx) + torch.triu(Qxx, 1).mT   # symmetric
            Qxx = Qxx + torch.diag_embed(Dx[:, k])
            Qxu = Ak.mT @ M1
            BtPxv = Bk.mT @ Pxv
            Quu = ((Bk.mT @ PxxB + (BtPxv + BtPxv.mT)) + Pvv
                   + torch.diag_embed(Du[:, k]))
            qz_x = gzx[:, k] + (Ak.mT @ Prp_x[..., None])[..., 0]
            qu = gu[:, k] + ((Bk.mT @ Prp_x[..., None])[..., 0] + Prp_v)
            L = chol_lanes(Quu.permute(1, 2, 0))
            rhs = torch.cat([-Qxu.mT, r2[:, :, None] * eye_nu,
                             -qu[..., None]], dim=2)          # (B, nu, nz+1)
            Y = _cho_solve_rows(L, rhs.permute(1, 2, 0)).permute(2, 0, 1)
            if k < n_pin:
                # Pinned head controls: K = 0, kff = 0, P = [[Qxx,0],[0,2R]]
                Y = torch.zeros_like(Y)
                Pxx, px = Qxx, qz_x
                Pxv = torch.zeros_like(Pxv)
                Pvv = torch.diag_embed(r2)
                pv = gzv[:, k]
            else:
                Kx, Kv, kff = Y[..., :nx], Y[..., nx:nz], Y[..., nz]
                Pxx = Qxx + Qxu @ Kx
                Pxx = 0.5 * (Pxx + Pxx.mT)
                Pxv = 0.5 * (Qxu @ Kv - r2[:, None, :] * Kx.mT)
                RK = r2[:, :, None] * Kv
                Pvv = -0.5 * (RK + RK.mT) + torch.diag_embed(r2)
                px = qz_x + (Qxu @ kff[..., None])[..., 0]
                pv = gzv[:, k] - r2 * kff
            K_all[:, k] = Y[..., :nz]
            kff_all[:, k] = Y[..., nz]
            pmax = torch.maximum(pmax, torch.maximum(
                torch.amax(px.abs(), dim=1), torch.amax(pv.abs(), dim=1)))

        nu_pen_new = torch.maximum(nu_pen, 2.0 * pmax + 1.0)
        m0 = cost0 + nu_pen_new * c_l1

        # ---- forward rollout from the stored rows (no dynamics evaluated)
        dX = torch.zeros(B, N + 1, nx, dtype=dtype, device=device)
        dU = torch.empty(B, N, nu, dtype=dtype, device=device)
        dx = torch.zeros(B, nx, dtype=dtype, device=device)
        dv = torch.zeros(B, nu, dtype=dtype, device=device)
        amax, ddir, stepn_i = full(1.0), full(0.0), full(0.0)
        for k in range(N):
            dz = torch.cat([dx, dv], dim=1)
            du_k = (K_all[:, k] @ dz[..., None])[..., 0] + kff_all[:, k]
            Gk = torch.cat([gzx[:, k], gzv[:, k], gu[:, k]], dim=1)
            terms = torch.cat([
                Gk[:, :nx] * dx,
                torch.stack([Gk[:, nx:nx + nu] * dv, Gk[:, nx + nu:] * du_k],
                            dim=-1).flatten(1)], dim=1)
            ddir = ddir + _ssum(terms)
            dxn = next_dx(k, dx, du_k, ck[:, k], rows)
            amax = _ftb(U[:, k], du_k, p.u_min, p.u_max, amax)
            amax = _ftb(X[:, k + 1], dxn, p.x_min, p.x_max, amax)
            stepn_i = torch.maximum(stepn_i, torch.maximum(
                torch.amax(du_k.abs(), dim=1), torch.amax(dxn.abs(), dim=1)))
            dU[:, k] = du_k
            dX[:, k + 1] = dxn
            dx, dv = dxn, du_k
        ddir = ddir + _ssum(G_N * dx)
        ddir = ddir - nu_pen_new * c_l1

        # ---- line search: all rungs and stages at once, (B, T, N, .);
        # stage terms summed k = 0 to N-1 as the kernel's forward pass does
        al = amax[:, None] * fan_t                              # (B, T)
        a4 = al[:, :, None, None]
        dukm1 = torch.cat([torch.zeros_like(dU[:, :1]), dU[:, :-1]], dim=1)
        xt = X[:, None, :N] + a4 * dX[:, None, :N]
        ut = U[:, None] + a4 * dU[:, None]
        dut = ut - (ukm1[:, None] + a4 * dukm1[:, None])
        et = xt - xdes_prev[:, None]
        w4 = lambda t: t[:, None, None]
        sc_t, rate_t = stage_cost(xt, ut, dut, et, tk[None, None],
                                  mu_c[..., None], w4)
        inc_t = step_increment(xt, ut)
        d_t = ((X[:, None, :N] - X[:, None, 1:])
               + a4 * (dX[:, None, :N] - dX[:, None, 1:])) + inc_t
        val_t = xt + inc_t
        cl1_t = _ssum(d_t.abs().flatten(-2))
        er_t = val_t - xdes[:, None]
        jref_t = _ssum(_ssum(torch.cat([rate_t[..., None],
                                        q[:, None, None] * (er_t * er_t)],
                                       -1)))
        cost_t = _ssum(sc_t)
        xtN = X[:, None, N] + al[..., None] * dX[:, None, N]   # (B, T, nx)
        eNt = xtN - xdes[:, None, N - 1]
        eFt = xtN - p.xf_des[:, None]
        for i in range(nx):
            cost_t = (cost_t + q[:, None, i] * eNt[..., i] * eNt[..., i]) \
                + qf[:, None, i] * eFt[..., i] * eFt[..., i]
            jref_t = jref_t + qf[:, None, i] * eFt[..., i] * eFt[..., i]
        cost_t = cost_t + _bar_value(xtN, p.x_min[:, None], p.x_max[:, None],
                                     mu_c[..., None])
        m_t = cost_t + nu_pen_new[:, None] * cl1_t
        eps_m = lc.armijo_eps(m0)
        passed = lc.armijo_pass(m_t, m0[:, None], al, ddir[:, None],
                                eps_m[:, None])
        first = passed.to(torch.int32).argmax(dim=1, keepdim=True)
        anyp = passed.any(dim=1)
        alpha_new = torch.where(anyp, al.gather(1, first)[:, 0], 0.0)
        jref_new = torch.where(anyp, jref_t.gather(1, first)[:, 0], jref_old)
        alpha_new = torch.where(live, alpha_new, 0.0)

        # 0*inf-guarded update: a rejected direction may hold inf/NaN.
        step = (alpha_new > 0)[:, None, None]
        X = torch.where(step, X + alpha_new[:, None, None] * dX, X)
        U = torch.where(step, U + alpha_new[:, None, None] * dU, U)

        if not adaptive:
            nu_pen, stepn, feas, jref, alpha = (nu_pen_new, stepn_i, feas_i,
                                                jref_new, alpha_new)
            continue

        # ---- adaptive bookkeeping (loop_common policies); a crawl step
        # (only a deep rung passed) grows reg like a failed search.
        no_move = (alpha_new == 0.0) | ~torch.isfinite(alpha_new)
        crawl = no_move | (alpha_new < 0.01 * amax)
        reg_new = lc.reg_update(reg, crawl)
        mu_new = lc.mu_update(mu, stepn_i, feas_i, tol, floor, kappa)
        conv, div = lc.convergence(stepn_i, feas_i, mu, reg_new, tol, floor)
        # Converged wins over diverged in the same iteration (the lanes
        # solver's rule; the JAX fused kernel lets diverged win).
        done_new = torch.where(conv, 1.0, torch.where(div, 2.0, 0.0))
        sel = lambda new, old: torch.where(live, new, old)
        mu, reg, nu_pen = sel(mu_new, mu), sel(reg_new, reg), \
            sel(nu_pen_new, nu_pen)
        done = sel(done_new.to(dtype), done)
        stepn, feas = sel(stepn_i, stepn), sel(feas_i, feas)
        jref, alpha = sel(jref_new, jref), sel(alpha_new, alpha)
        iters = iters + live.to(dtype)

    stats = torch.stack([stepn, feas, jref, alpha, mu, done, iters,
                         torch.zeros_like(mu)], dim=1)
    return X, U, stats


# ---------------------------------------------------------------------------
# The kernel through its C interface.
# ---------------------------------------------------------------------------

class _Workspace(NamedTuple):
    """The kernel's batch-innermost arrays (``csrc/fused_sqp.cuh``
    ``FusedArgs``)."""
    ins: list       # X0 U0 xdes q r rm uprev umin umax xmin xmax qf xfdes mu0
    outs: list      # X U stats
    scratch: list   # K kff dX dU G J ck
    ltv: list       # AdI Bd cd in LTV, else None


def _workspace(prob: ShootingProblem, B: int, dtype, device) -> _Workspace:
    """The kernel's inputs, outputs and scratch for B instances as views of
    one ``torch.empty``, each at a 128-byte boundary."""
    nx, nu, N = prob.nx, prob.nu, prob.N
    nz = nx + nu
    # Rows a stage of the Jacobian scratch: the nq acceleration rows (fast),
    # all nx (generic), none in LTV (one element keeps the pointer valid).
    n_store = {"ltv": 0, "fast": prob.dynamics.nq,
               "generic": nx}[step_mode(prob)]
    shapes = [(N + 1, nx), (N, nu), (N, nx), (nx,), (nu,), (nu,), (nu,),
              (nu,), (nu,), (nx,), (nx,), (nx,), (nx,), (),
              (N + 1, nx), (N, nu), (8,),
              (N, nu, nz),          # feedback gains K
              (N, nu),              # feedforward kff
              (N + 1, nx),          # step direction dX
              (N, nu),              # step direction dU
              (N + 1, nx + 2 * nu),  # stage gradients G
              (N, n_store, nz) if n_store else (1,),  # rows J
              (N, nx)]              # stage defects ck
    sizes = []
    for shape in shapes:
        n = math.prod(shape) * B
        sizes += [n, -n % 32]
    parts = torch.empty(sum(sizes), dtype=dtype, device=device).split(sizes)
    views = [t.view(shape + (B,)) for t, shape in zip(parts[::2], shapes)]
    return _Workspace(views[:14], views[14:17], views[17:], [None] * 3)


def _prepare(prob: ShootingProblem, opts: SolverOptions, p: MPCParams,
             X0: Optional[Tensor], U0: Optional[Tensor], mu0, fn,
             last) -> _Workspace:
    """A workspace whose inputs one call of a build's preparation
    (``csrc/fused_prepare.cuh``; ``fn``, followed by its own last argument
    ``last``: the stream on the card, 0 for g++) wrote, bit for bit what
    ``sqp._start`` gives, batch-innermost.  ``X0`` and ``U0`` None: a zero
    warm start; ``mu0`` a number, or a tensor that broadcasts to (B,)."""
    nx, nu, N = prob.nx, prob.nu, prob.N
    B, dtype, device = p.x0.shape[0], p.x0.dtype, p.x0.device
    with annotate("fused.copy_in"):
        ws = _workspace(prob, B, dtype, device)
    same = lambda t: None if t is None else t.to(dtype).contiguous()
    mu_each = None
    if not isinstance(mu0, numbers.Real):
        mu_each = torch.as_tensor(mu0, dtype=dtype,
                                  device=device).expand(B).contiguous()
        mu0 = 0.0
    srcs = [same(t) for t in (X0, U0, p.x_des, p.q, p.r, p.rm, p.u_prev,
                              p.u_min, p.u_max, p.x_min, p.x_max, p.qf,
                              p.xf_des, mu_each, p.x0)]
    ins = (ctypes.c_void_p * len(srcs))(*[
        None if t is None else t.data_ptr() for t in srcs])
    outs = (ctypes.c_void_p * len(ws.ins))(*[t.data_ptr() for t in ws.ins])
    scal = (ctypes.c_double * 4)(float(mu0), lc.mu_floor(opts),
                                 float(opts.mu_min), INTERIOR_DELTA)
    rc = fn(B, N, nx, nu, ins, outs, scal, last)
    if rc == -6:
        raise ValueError(f"one instance's inputs at N={N}, (nx, nu) = ({nx}, "
                         f"{nu}) do not fit in a block of the preparation "
                         f"kernel")
    if rc != 0:
        raise RuntimeError(f"fused preparation kernel failed (error code "
                           f"{rc})")
    return ws


def _with_ltv(ws: _Workspace, dtype, ltv) -> _Workspace:
    """``ws`` with the streamed LTV step batch-innermost (LTV only)."""
    if ltv is None:
        return ws
    return ws._replace(ltv=[t.to(dtype).movedim(0, -1).contiguous()
                            for t in ltv])


def _launched(fn, launched) -> dict:
    """The body a build of the kernel ran and its threads an instance: on
    the card what the launcher wrote into ``launched`` (body -1 where it
    launched nothing), in a g++ build (no ``launched``) the build's name
    and no width."""
    if launched is None:
        return dict(body=getattr(fn, "__name__", None), width=None)
    body, width = launched
    return dict(body=BODIES[body] if body >= 0 else None, width=width)


def _run_library(fn, stream, prob: ShootingProblem, opts: SolverOptions,
                 ws: _Workspace, n_iter: int, fan: Sequence[float],
                 adaptive: bool, launched=None):
    """Call a build of the kernel body (``fn``: a CUDA launcher when
    ``stream`` is given, followed by ``launched``, where it writes what it
    launched, else the CPU test build)
    on the arrays of ``ws``; returns X, U, stats in batch-leading layout.
    Its span ``fused.launch`` records what ran: the step ``mode``, the
    ``integrator``, the ``body`` and its threads an instance, ``width``, as
    the launcher wrote them (a g++ build: its name, and no width)."""
    nx, nu, N = prob.nx, prob.nu, prob.N
    B, dtype = ws.outs[0].shape[-1], ws.outs[0].dtype
    target = kernel_target(prob)
    model, mode = target.model, target.mode
    with annotate("fused.launch") as span:
        ptrs = (ctypes.c_void_p * 27)(*[
            None if t is None else t.data_ptr()
            for t in ws.ins + ws.ltv + ws.outs + ws.scratch])
        ctype = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
        scal = (ctype * 4)(float(prob.dt), float(opts.tol),
                           lc.mu_floor(opts), float(opts.kappa_mu))
        ints = (ctypes.c_int * 6)(int(n_iter),
                                  int(opts.num_control_inputs_saved),
                                  int(adaptive), len(fan),
                                  INTEGRATORS.index(prob.integrator),
                                  int(prob.is_linear))
        fan_c = (ctype * MAX_FAN)(*fan)
        consts_c = (ctypes.c_double * len(target.consts))(*target.consts)
        args = [B, N, model, nx, nu, ptrs, scal, ints, fan_c, consts_c]
        if stream is not None:
            args += [stream, launched]
        rc = fn(*args)
        if span is not None:
            span.attrs = dict(mode=mode, integrator=prob.integrator,
                              **_launched(fn, launched))
    if rc == -1:
        raise ValueError(f"the kernel build holds no instantiation for "
                         f"model {model}, (nx, nu) = ({nx}, {nu}), "
                         f"{mode}")
    if rc == -3:
        raise ValueError(f"no group body at (nx, nu) = ({nx}, {nu}): the "
                         f"shape does not split over the group's lanes")
    if rc == -4:
        raise ValueError(f"the step policy of model {model}, (nx, nu) = "
                         f"({nx}, {nu}), {mode} has no such body at "
                         f"N={N}")
    if rc != 0:
        raise RuntimeError(f"fused SQP kernel failed (error code {rc})")
    with annotate("fused.copy_out"):
        back = lambda t: t.movedim(-1, 0).contiguous()
        return back(ws.outs[0]), back(ws.outs[1]), back(ws.outs[2])


def _prepare_cpu(prob, opts, p, X0, U0, mu0, fan):
    """The g++ builds' preparation (``_solve``'s ``prepare``): the
    preparation kernel's blocks run by g++ (``mpc_fused_prepare_cpu_*``)
    into a workspace; returns (the workspace, its mu)."""
    target = _check_kernel(prob, fan)
    bits = "f32" if p.x0.dtype == torch.float32 else "f64"
    fn = getattr(_build.cpu_library(target.generated or "fused_sqp"),
                 f"mpc_fused_prepare_cpu_{bits}")
    ws = _prepare(prob, opts, p, X0, U0, mu0, fn, 0)
    return ws, ws.ins[13]


def _run_cpu(fn, prob, opts, p, ws, n_iter, fan, adaptive, ltv=None):
    """A g++ build of the kernel body (``fn``) as ``_solve``'s ``run``, on
    ``_prepare_cpu``'s workspace."""
    return _run_library(fn, None, prob, opts,
                        _with_ltv(ws, p.x0.dtype, ltv), n_iter, fan,
                        adaptive)


def _prepare_cuda(prob, opts, p, X0, U0, mu0, fan):
    """The card's preparation (``_solve``'s ``prepare``): one launch of the
    preparation kernel of the solve's CUDA library on the current stream,
    counted in ``solve_batch_fused.prepare_launches``; returns ((the
    library's name, the workspace), its mu)."""
    name = _check_kernel(prob, fan).cuda
    if p.x0.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel is float32 only, got {p.x0.dtype}")
    fn = _build.cuda_build(name)[0].mpc_fused_prepare_f32
    device = p.x0.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ws = _prepare(prob, opts, p, X0, U0, mu0, fn, stream)
    solve_batch_fused.prepare_launches += 1
    return (name, ws), ws.ins[13]


def _launch_cuda(prob, opts, p, state, n_iter, fan, adaptive, ltv):
    """The card's solve (``_solve``'s ``run``): the CUDA kernel of
    ``_prepare_cuda``'s library on its workspace (``state``), on the
    current stream of the workspace's device, on the body the launcher's
    rule picks, counting the launch by mode and body."""
    name, ws = state
    fn = _build.cuda_build(name)[0].mpc_fused_launch_f32
    ws = _with_ltv(ws, p.x0.dtype, ltv)
    launched = (ctypes.c_int * 2)(-1, 0)     # the body, its threads
    device = ws.outs[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out = _run_library(fn, stream, prob, opts, ws, n_iter, fan, adaptive,
                           launched)
    solve_batch_fused.launches += 1
    solve_batch_fused.mode_launches[step_mode(prob)] += 1
    if launched[0] >= 0:      # B = 0 launches nothing
        solve_batch_fused.body_launches[BODIES[launched[0]]] += 1
    return out


def _prepare_plain(prob, opts, p, X0, U0, mu0, fan):
    """The plain version's preparation (``_solve``'s ``prepare``):
    ``sqp._start``; returns ((X0, U0, mu), mu)."""
    start = _start(prob, p, X0, U0, opts, mu0)
    return start, start[2]


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------

def _solve(prob, p, X0, U0, opts, mu0, n_iter, ls_fan, adaptive, prepare,
           run, discretize=None):
    """Host-side checks (the JAX wrapper's fused.py:910-932), the
    preparation, one run of the body, and the status rules.  ``prepare(prob,
    opts, p, X0, U0, mu0, fan)`` gives (what ``run`` takes, the barrier's
    start): a kernel build's preparation kernel (``_prepare_cuda``,
    ``_prepare_cpu``) or the plain version's (``_prepare_plain``).  ``run(
    prob, opts, p, prepared, n_iter, fan, adaptive, ltv)`` gives X, U and the
    statistics.  In LTV, ``discretize(prob, p)`` gives the streamed (Ad - I,
    Bd, cd) (``solver/linearize.py``: the kernel ``ltv_discrete`` on the
    card, by default the plain version ``ltv_discrete_plain``)."""
    with annotate("fused.prepare"):
        if not (prob.is_linear or prob.dynamics.supports_lanes):
            raise ValueError(f"dynamics {prob.dynamics.name!r} is not "
                             "lanes-polymorphic")
        nx, nu, N = prob.nx, prob.nu, prob.N
        B = p.x0.shape[0]
        device = p.x0.device
        if n_iter is None:
            n_iter = int(opts.max_iter) if adaptive else 3
        fan = tuple(float(a) for a in (
            ls_fan if ls_fan is not None
            else (LS_FAN_ADAPTIVE if adaptive else LS_FAN_FIXED)))
        want = {"x_des": (B, N, nx), "q": (B, nx), "r": (B, nu),
                "rm": (B, nu), "u_prev": (B, nu), "x0": (B, nx),
                "u_min": (B, nu), "u_max": (B, nu), "x_min": (B, nx),
                "x_max": (B, nx), "qf": (B, nx), "xf_des": (B, nx)}
        got = dict(X0=X0, U0=U0, **{k: getattr(p, k) for k in want})
        want.update(X0=(B, N + 1, nx), U0=(B, N, nu))
        for k, shape in want.items():
            t = got[k]
            if t is not None and (tuple(t.shape) != shape
                                  or t.device != device):
                raise ValueError(f"{k}: expected shape {shape} on {device}, "
                                 f"got {tuple(t.shape)} on {t.device}")
        floor = lc.mu_floor(opts)
        if mu0 is None:
            mu0 = opts.warm_mu_factor * opts.tol
        prepared, mu = prepare(prob, opts, p, X0, U0, mu0, fan)

    with strict_fp32():
        ltv = None
        if prob.is_linear:
            # the kernel streams Ad - I: its increment forms no difference
            if discretize is None:
                discretize = linearize.ltv_discrete_plain
            with annotate("fused.discretize"):
                ltv = discretize(prob, p)
        X, U, st = run(prob, opts, p, prepared, n_iter, fan, adaptive, ltv)

    with annotate("fused.status"):
        return _status(opts, X, U, st, mu, floor, n_iter, adaptive)


def _status(opts, X, U, st, mu, floor, n_iter, adaptive) -> SolveResult:
    """The status rules of a fused solve, from the body's statistics."""
    B, device = X.shape[0], X.device
    stepn, feas, obj = st[:, 0], st[:, 1], st[:, 2]
    finite = (torch.isfinite(stepn) & torch.isfinite(feas)
              & torch.isfinite(X.reshape(B, -1)).all(dim=1))
    code = lambda c: torch.full((B,), c, dtype=torch.int32, device=device)
    if adaptive:
        done = st[:, 5]
        status = torch.where((done >= 1.5) | ~finite, code(DIVERGED),
                             torch.where(done >= 0.5, code(CONVERGED),
                                         code(MAX_ITER)))
        iters = st[:, 6].to(torch.int32)
    else:
        converged = (stepn < opts.tol) & (feas < opts.tol) & (mu <= 2.0 * floor)
        status = torch.where(~finite, code(DIVERGED),
                             torch.where(converged, code(CONVERGED),
                                         code(MAX_ITER)))
        iters = code(n_iter)
    return SolveResult(X=X, U=U, iters=iters, status=status, kkt=stepn,
                       feas=feas, obj=obj)


def solve_batch_fused(prob: ShootingProblem, p: MPCParams,
                      X0: Optional[Tensor] = None, U0: Optional[Tensor] = None,
                      opts: SolverOptions = SolverOptions(),
                      mu0=None, n_iter: Optional[int] = None,
                      ls_fan: Optional[Sequence[float]] = None,
                      adaptive: bool = False) -> SolveResult:
    """Solve a batch of B instances in one fused solve.

    ``p`` holds (B, ...) tensors, ``X0`` (B, N+1, nx) and ``U0`` (B, N, nu)
    warm-start them (zeros when None).  ``adaptive=False``: exactly
    ``n_iter`` (default 3) iterations at the warm barrier ``mu0`` (default
    ``warm_mu_factor * tol``); status CONVERGED when the final step and
    defects pass ``opts.tol``.  ``adaptive=True``: the full adaptive SQP,
    ``n_iter`` the iteration cap (default ``opts.max_iter``); cold starts
    pass ``mu0 = opts.mu_init``.

    On CUDA tensors this launches the preparation kernel and then the
    kernel (float32) on the body the launcher's rule picks (``card_body``),
    in LTV after the discretization kernel (``linearize.ltv_discrete``),
    and counts the launch in ``solve_batch_fused.launches`` (and by mode,
    body) and the preparation in
    ``solve_batch_fused.prepare_launches``; on CPU tensors it runs the
    plain PyTorch version.  Any other device raises.
    """
    kind = p.x0.device.type
    if kind == "cuda":
        route = _prepare_cuda, _launch_cuda, linearize.ltv_discrete
    elif kind == "cpu":
        route = _prepare_plain, _solve_batch_fused_plain, None
    else:
        raise ValueError(f"no fused solve for device type {kind!r}")
    return _solve(prob, p, X0, U0, opts, mu0, n_iter, ls_fan, adaptive,
                  *route)


solve_batch_fused.launches = 0
# card preparations (``_prepare_cuda``): one a counted launch
solve_batch_fused.prepare_launches = 0
solve_batch_fused.mode_launches = {"fast": 0, "generic": 0, "ltv": 0}
# launches by the body the launcher's rule picked (``card_body``)
solve_batch_fused.body_launches = dict.fromkeys(BODIES, 0)


def solve_batch_fused_plain(prob: ShootingProblem, p: MPCParams,
                            X0: Optional[Tensor] = None,
                            U0: Optional[Tensor] = None,
                            opts: SolverOptions = SolverOptions(),
                            mu0=None, n_iter: Optional[int] = None,
                            ls_fan: Optional[Sequence[float]] = None,
                            adaptive: bool = False) -> SolveResult:
    """The plain PyTorch version on any device (the kernel's reference)."""
    return _solve(prob, p, X0, U0, opts, mu0, n_iter, ls_fan, adaptive,
                  _prepare_plain, _solve_batch_fused_plain)


def solve_batch_fused_cpu_kernel(prob: ShootingProblem, p: MPCParams,
                                 X0: Optional[Tensor] = None,
                                 U0: Optional[Tensor] = None,
                                 opts: SolverOptions = SolverOptions(),
                                 mu0=None, n_iter: Optional[int] = None,
                                 ls_fan: Optional[Sequence[float]] = None,
                                 adaptive: bool = False,
                                 body: str = "thread") -> SolveResult:
    """The kernel body built for the CPU by g++ (float32 or float64 CPU
    tensors): how the tests run the kernel's own arithmetic without a
    card.  ``body="thread"``: the one-thread body (``solve_instance``),
    ``body="group"``: the group body (``csrc/fused_sqp_group.cuh``, at the
    step policy's width), each of every policy, whichever the card runs
    (``card_body``); ``body="block"``: the block body
    (``csrc/fused_sqp_block.cuh``) of the policies ``BlockBody`` names (a
    user's model where its shape splits over its policy's lanes); a
    generated instantiation runs from the problem's own g++ build.  The
    group body needs a shape that splits over its lanes (NX a multiple of
    the width; a lane owns controls l, l + W, ..., so any NU)."""
    lib = _build.cpu_library(_check_kernel(prob).generated or "fused_sqp")
    name = {"thread": "mpc_fused_solve_cpu", "group":
            "mpc_fused_solve_group_cpu", "block":
            "mpc_fused_solve_block_cpu"}[body]
    bits = "f32" if p.x0.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"{name}_{bits}")
    return _solve(prob, p, X0, U0, opts, mu0, n_iter, ls_fan, adaptive,
                  _prepare_cpu, functools.partial(_run_cpu, fn))


def count_fused_ops(prob: ShootingProblem, p: MPCParams,
                    X0: Optional[Tensor] = None, U0: Optional[Tensor] = None,
                    opts: SolverOptions = SolverOptions(), mu0=None,
                    n_iter: Optional[int] = None, adaptive: bool = False,
                    body: str = "group"):
    """The floating-point operations of a kernel body on these inputs,
    each as {"add", "mul", "div_sqrt", "transcendental"} summed over the
    instances: the body run by g++ on a scalar that counts
    (``csrc/flop_count.cpp``), in float64 on CPU copies of the inputs.
    Returns {"body": the body's own tally, "minimum": the function's
    operations, each counted once: the tally less what the body repeats,
    "card_body": the body the card runs and its width (``card_body``)}, the
    minimum being the numerator of the kernel's roofline bound.
    ``body="group"``: the group body (it repeats work across its lanes).
    ``body="thread"``: the one-thread body; it repeats the step's value in
    every dual pass of a stage's linearization and adds A's identity entry
    by entry.  Either body of any problem the kernel serves.  The group
    body computes the one-thread body's function except for the arms under
    Euler, so both give the same minimum (``csrc/flop_count.cpp`` counts it
    by running the one-thread body).  For the arms under Euler the group
    body linearizes by another method (the folded Jacobian): there the
    one-thread body is the arithmetic it replaced, and its minimum is None
    (the function's is ``body="group"``'s)."""
    target = _check_kernel(prob)
    lib = _build.cpu_library(target.generated or "flop_count")
    counts = torch.zeros(8, dtype=torch.float64)
    group = {"thread": 0, "group": 1}[body]
    fn = lambda *args: lib.mpc_fused_count_ops(*args, group,
                                               counts.data_ptr())
    host = lambda t: None if t is None else t.detach().to("cpu",
                                                          torch.float64)
    p64 = MPCParams(*[type(f)(*[host(a) for a in f]) if isinstance(f, tuple)
                      else host(f) for f in p])
    _solve(prob, p64, host(X0), host(U0), opts, mu0, n_iter, None, adaptive,
           _prepare_cpu, functools.partial(_run_cpu, fn))
    kinds = ("add", "mul", "div_sqrt", "transcendental")
    tally = dict(zip(kinds, counts[:4].tolist()))
    minimum = dict(zip(kinds, (counts[:4] - counts[4:]).tolist()))
    folded = target.mode == "fast" and target.cuda == "fused_sqp"
    return dict(body=tally, minimum=None if folded and not group else minimum,
                card_body=card_body(prob))


# The block body's regions between two block barriers
# (csrc/fused_sqp_block.cuh `Region`).
BLOCK_REGIONS = ("load", "linearize", "stage_terms", "sweep", "rollout",
                 "rung_terms", "rung_sums", "update")


def count_block_path(prob: ShootingProblem, p: MPCParams,
                     X0: Optional[Tensor] = None, U0: Optional[Tensor] = None,
                     opts: SolverOptions = SolverOptions(), mu0=None,
                     n_iter: Optional[int] = None,
                     adaptive: bool = False) -> dict:
    """The block body's critical path on these inputs, in floating-point
    operations by region (``BLOCK_REGIONS``), summed over the instances:
    the operations of the busiest thread of each stretch between two block
    barriers (the busiest task, lane or the thread beside the group), as
    ``csrc/flop_count.cpp`` ``mpc_fused_count_path`` counts them on the
    body run by g++ in float64.  The numerator of the block body's
    dependency-chain bound (``chip_smoke.py``)."""
    lib = _build.cpu_library(_check_kernel(prob).generated or "flop_count")
    path = torch.zeros(len(BLOCK_REGIONS), dtype=torch.float64)
    fn = lambda *args: lib.mpc_fused_count_path(*args, path.data_ptr())
    host = lambda t: None if t is None else t.detach().to("cpu",
                                                          torch.float64)
    p64 = MPCParams(*[type(f)(*[host(a) for a in f]) if isinstance(f, tuple)
                      else host(f) for f in p])
    _solve(prob, p64, host(X0), host(U0), opts, mu0, n_iter, None, adaptive,
           _prepare_cpu, functools.partial(_run_cpu, fn))
    return dict(zip(BLOCK_REGIONS, path.tolist()))
