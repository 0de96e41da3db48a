"""Lanes-batched SQP (port of ``mahi_mpc_tpu/solver/batched.py``).

The same algorithm as the JAX package's ``solve_batch_lanes``: every
dynamics evaluation puts the batch x node (x tangent) product in the
trailing dim of the models' tensor ``f``, so one call evaluates all B*N
steps; the QP build and the bookkeeping stay batch-leading; the KKT solve
goes to the Riccati kernel on a CUDA card (``kkt_backend="auto"``) or the
scan; and the outer loop carries per-instance convergence and line-search
masks, with the JAX package's statuses, barrier schedule and halving line
search.

Where the JAX ``lax.while_loop``s test ``jnp.any(...)``, this loop reads one
host scalar per SQP iteration and per line-search rung.  LTV mode
(``prob.is_linear``, reference C8) computes the exact discrete affine step
of the frozen linearization once per solve (``_ltv_discrete``); defects,
merit and objective are then batched matmuls, and no dynamics graph runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, jvp, vjp, vmap

from ..models.integrators import make_step
from ..ops.precision import strict_fp32
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem
from . import loop_common as lc
from .riccati import resolve_kkt_backend, solve_lqr
from .sqp import CONVERGED, DIVERGED, MAX_ITER, SolveResult, _strict_interior
from .stage_qp import build_stage_qp, fraction_to_boundary, merit_smooth

Tensor = torch.Tensor


def _lanes_step(prob: ShootingProblem, xs: Tensor, us: Tensor) -> Tensor:
    """Discrete step F on lanes-layout states: xs (nx, M), us (nu, M)."""
    return make_step(prob.dynamics.f, prob.dt, prob.integrator)(xs, us)


# ---- LTV (successive-linearization) mode, reference C8 --------------------
# The frozen-linearization step F(x, u) = step of A (x - x0) + B (u - u0) +
# x_dot0 is affine with per-instance (A, B) constant across the horizon
# (``ModelControl.cpp:125-135``), so its discrete Jacobians are one jacfwd
# per instance (not per node) and the defects are batched matmuls.

def _ltv_step_one(prob: ShootingProblem, lp, x: Tensor, u: Tensor) -> Tensor:
    f = lambda x_, u_: prob.dynamics.linear_f(
        x_, u_, lp.A, lp.B, lp.x_dot0, lp.x0, lp.u0)
    return make_step(f, prob.dt, prob.integrator)(x, u)


def check_lin(prob: ShootingProblem, p: MPCParams):
    """``p.lin``, after checking that it holds one frozen linearization per
    instance of the (B, ...) batch ``p``."""
    nx, nu, B = prob.nx, prob.nu, p.x0.shape[0]
    want = {"A": (B, nx, nx), "B": (B, nx, nu), "x_dot0": (B, nx),
            "x0": (B, nx), "u0": (B, nu)}
    for k, shape in want.items():
        got = tuple(getattr(p.lin, k).shape)
        if got != shape:
            raise ValueError(f"lin.{k}: expected {shape} (one frozen "
                             f"linearization per instance), got {got}")
    return p.lin


@strict_fp32()
def _ltv_discrete(prob: ShootingProblem, p: MPCParams):
    """Exact per-instance discrete affine step for LTV mode:
    ``F(x, u) = Ad x + Bd u + cd`` with Ad (B, nx, nx), Bd (B, nx, nu),
    cd (B, nx), from the frozen linearization ``p.lin`` (a (B, ...) batch).

    An affine continuous-time ``f`` stays affine through every explicit
    integrator, so the discrete step is exactly affine: ``cd`` is the step
    at z = 0 and (Ad, Bd) its ``jacfwd`` there, vmapped over the batch,
    once per solve.  Strict float32: TF32 here would hand the solver a
    perturbed problem (the card's analogue of JAX commit 56dd6ff)."""
    nx, nu = prob.nx, prob.nu
    lin = check_lin(prob, p)

    def one(lp):
        joint = lambda w: _ltv_step_one(prob, lp, w[:nx], w[nx:])
        z = torch.zeros(nx + nu, dtype=lp.x0.dtype, device=lp.x0.device)
        J = jacfwd(joint)(z)
        return J[:, :nx], J[:, nx:], joint(z)

    return vmap(one)(lin)


@strict_fp32()
def _defects_ltv(prob: ShootingProblem, X: Tensor, U: Tensor,
                 p: MPCParams, ltv=None) -> Tensor:
    """Continuity residuals under the frozen LTV step: (B, N, nx)."""
    Ad, Bd, cd = _ltv_discrete(prob, p) if ltv is None else ltv
    xn = (torch.einsum("bij,bnj->bni", Ad, X[:, :-1])
          + torch.einsum("bij,bnj->bni", Bd, U) + cd[:, None])
    return xn - X[:, 1:]


def _linearize_ltv(prob: ShootingProblem, X: Tensor, U: Tensor,
                   p: MPCParams, ltv=None):
    """Stage Jacobians for LTV mode: exact everywhere (the step is affine),
    computed once per instance and broadcast over the horizon."""
    B, Np1, nx = X.shape
    N, nu = Np1 - 1, U.shape[-1]
    Ad, Bd, cd = _ltv_discrete(prob, p) if ltv is None else ltv
    return (Ad[:, None].expand(B, N, nx, nx), Bd[:, None].expand(B, N, nx, nu),
            _defects_ltv(prob, X, U, p, ltv=(Ad, Bd, cd)))


def _lanes(X: Tensor, U: Tensor):
    """(B, N+1, nx), (B, N, nu) -> the N stage states (nx, B*N) and controls
    (nu, B*N)."""
    B, Np1, nx = X.shape
    return X[:, :-1].reshape(B * (Np1 - 1), nx).T, U.reshape(-1, U.shape[-1]).T


def _defects_lanes(prob: ShootingProblem, X: Tensor, U: Tensor) -> Tensor:
    """Continuity residuals for the whole batch: X (B, N+1, nx) ->
    c (B, N, nx), evaluating all B*N dynamics steps in one call."""
    B, Np1, nx = X.shape
    xn = _lanes_step(prob, *_lanes(X, U))           # (nx, B*N)
    return xn.T.reshape(B, Np1 - 1, nx) - X[:, 1:]


def _linearize_lanes(prob: ShootingProblem, X: Tensor, U: Tensor,
                     mode: str = "auto"):
    """Stage Jacobians for the whole batch with node x batch in the trailing
    dim: returns A (B, N, nx, nx), Bm (B, N, nx, nu), c (B, N, nx).

    - ``"rev"`` (Euler step and a second-order model, ``Dynamics.nq``):
      f = [qd, acc], so the step Jacobian is I + dt [[0, I, 0], [Jacc]]
      and only the nq acceleration rows need AD: one ``torch.func.vjp``
      forward pass and nq unit-cotangent pulls.
    - ``"fan"`` / ``"auto"``: the discrete step's Jacobian from nz = nx + nu
      unit-tangent ``torch.func.jvp`` passes, vmapped over the unit
      basis (one batched pass on the card instead of nz).
    """
    if mode not in ("auto", "rev", "fan"):
        raise ValueError(f"unknown linearize_mode {mode!r}; choose 'auto', "
                         "'rev' or 'fan'")
    B, Np1, nx = X.shape
    N = Np1 - 1
    nu = U.shape[-1]
    nz = nx + nu
    dtype, device = X.dtype, X.device
    W = torch.cat(_lanes(X, U), dim=0)                 # (nz, M)
    M = W.shape[-1]
    const = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    nq = prob.dynamics.nq
    rev_ok = nq is not None and 2 * nq == nx and prob.integrator == "euler"
    if mode == "rev":
        if not rev_ok:
            raise ValueError(
                "linearize_mode='rev' needs a second-order model (Dynamics.nq "
                "set, nx == 2*nq) and the Euler integrator")
        f_val, pull = vjp(lambda w: prob.dynamics.f(w[:nx], w[nx:]), W)
        eye = np.eye(nx)
        Jacc = torch.stack([pull(const(eye[:, i:i + 1]).expand(nx, M))[0]
                            for i in range(nq, nx)])  # (nq, nz, M)
        dt = prob.dt
        # Step Jacobian [I_nx | 0] + dt * Jf, row block by row block: the
        # position rows are exact, the acceleration rows take Jacc.
        top = const(np.eye(nx, nz)[:nq] + dt * np.eye(nx, nz, k=nq)[:nq])
        bot = const(np.eye(nx, nz)[nq:])[..., None] + dt * Jacc
        J = torch.cat([top[..., None].expand(nq, nz, M), bot], dim=0)
        J = J.permute(2, 0, 1).reshape(B, N, nx, nz)
        val = W[:nx] + dt * f_val
    else:
        val, J = _fan_jacobian(prob, W)
        J = J.permute(2, 0, 1).reshape(B, N, nx, nz)
    c = val.T.reshape(B, N, nx) - X[:, 1:]
    return J[..., :nx], J[..., nx:], c


def _fan_jacobian(prob: ShootingProblem, W: Tensor, step=None):
    """The discrete step (or ``step(xs, us)``, another function of the
    stage) and its Jacobian at M points W = [x; u] (nz, M): val (nx, M), J
    (nx, nz, M), from nz unit-tangent ``torch.func.jvp`` passes vmapped
    over the unit basis (one batched pass on the card)."""
    nx, nz = prob.nx, W.shape[0]
    if step is None:
        stepw = lambda w: _lanes_step(prob, w[:nx], w[nx:])
    else:
        stepw = lambda w: step(w[:nx], w[nx:])
    basis = torch.eye(nz, dtype=W.dtype, device=W.device)[:, :, None]
    Jt = vmap(lambda t: jvp(stepw, (W,), (t,))[1])(
        basis.expand(nz, nz, W.shape[1]))               # (nz, nx, M)
    return stepw(W), Jt.permute(1, 0, 2)


def _merit_batch(prob: ShootingProblem, X: Tensor, U: Tensor, p: MPCParams,
                 mu: Tensor, nu_pen: Tensor, ltv=None) -> Tensor:
    """l1 merit per instance (B,): separable cost + barrier + nu |c|_1,
    with the defects evaluated in lanes (LTV: batched affine matmuls)."""
    c = (_defects_ltv(prob, X, U, p, ltv=ltv) if prob.is_linear
         else _defects_lanes(prob, X, U))
    return (merit_smooth(X, U, p, mu)
            + nu_pen * torch.sum(torch.abs(c), dim=(1, 2)))


@strict_fp32()
def solve_batch_lanes(prob: ShootingProblem, p: MPCParams,
                      X0: Optional[Tensor] = None,
                      U0: Optional[Tensor] = None,
                      opts: SolverOptions = SolverOptions(),
                      mu0=None) -> SolveResult:
    """Batched SQP with the JAX package's ``solve_batch_lanes`` semantics:
    every field of ``p`` carries a leading batch B, ``X0`` (B, N+1, nx) and
    ``U0`` (B, N, nu) warm-start it (zeros when None), ``mu0`` is the
    initial barrier (default ``opts.mu_init``).  LTV problems take the
    frozen linearization from ``p.lin``, one per instance."""
    if not (prob.is_linear or prob.dynamics.supports_lanes):
        raise ValueError(f"dynamics {prob.dynamics.name!r} is not "
                         "lanes-polymorphic")
    nx, nu, N = prob.nx, prob.nu, prob.N
    nz = nx + nu
    B = p.x0.shape[0]
    dtype, device = p.x0.dtype, p.x0.device
    kw = dict(dtype=dtype, device=device)
    if X0 is None:
        X0 = torch.zeros(B, N + 1, nx, **kw)
    if U0 is None:
        U0 = torch.zeros(B, N, nu, **kw)
    X = torch.cat([p.x0[:, None],
                   _strict_interior(X0[:, 1:].to(dtype), p.x_min[:, None],
                                    p.x_max[:, None])], dim=1)
    U = _strict_interior(U0.to(dtype), p.u_min[:, None], p.u_max[:, None])

    fin = lambda t: torch.isfinite(t).any(dim=1)
    has_bounds = fin(p.u_min) | fin(p.u_max) | fin(p.x_min) | fin(p.x_max)
    floor = lc.mu_floor(opts)
    if mu0 is None:
        mu0 = opts.mu_init
    mu = lc.mu_start(has_bounds, torch.as_tensor(mu0, **kw).expand(B),
                     floor, opts.mu_min)
    tol = float(opts.tol)
    backend = resolve_kkt_backend(opts.kkt_backend, batched=True,
                                  dims=(N, nz, nu), device=device)
    # LTV: the exact discrete affine step depends only on the frozen
    # linearization point, so it is computed once, outside the loop.
    ltv = _ltv_discrete(prob, p) if prob.is_linear else None

    full = lambda v, dt=dtype: torch.full((B,), v, dtype=dt, device=device)
    reg, nu_pen = full(lc.REG_MIN), full(1.0)
    it = full(0, torch.int32)
    done = full(False, torch.bool)
    status = full(MAX_ITER, torch.int32)
    kkt, feas_s = full(float("inf")), full(float("inf"))

    while bool(((~done) & (it < opts.max_iter)).any()):
        A, Bm, c = (_linearize_ltv(prob, X, U, p, ltv=ltv) if prob.is_linear
                    else _linearize_lanes(prob, X, U,
                                          mode=opts.linearize_mode))
        qp = build_stage_qp(prob, X, U, p, mu, reg, lin=(A, Bm, c),
                            n_pin=opts.num_control_inputs_saved)
        sol = solve_lqr(qp, backend)
        dX = sol.dz[..., :nx]                   # (B, N+1, nx)
        dU = sol.du                             # (B, N, nu)

        step_norm = torch.maximum(torch.amax(dX.abs(), dim=(1, 2)),
                                  torch.amax(dU.abs(), dim=(1, 2)))
        feas = torch.amax(qp.r.abs(), dim=(1, 2))
        nu_pen_new = torch.maximum(
            nu_pen, 2.0 * torch.amax(sol.lam.abs(), dim=(1, 2)) + 1.0)

        a_u = torch.amin(fraction_to_boundary(
            U, dU, p.u_min[:, None], p.u_max[:, None]), dim=1)
        a_x = torch.amin(fraction_to_boundary(
            X[:, 1:], dX[:, 1:], p.x_min[:, None], p.x_max[:, None]), dim=1)
        alpha_max = torch.minimum(a_u, a_x)

        # m0's defects are the linearization residuals already in qp.r.
        r_l1 = qp.r.abs().sum(dim=(1, 2))
        m0 = merit_smooth(X, U, p, mu) + nu_pen_new * r_l1
        ddir = (torch.sum(qp.gz[:, 1:] * torch.cat(
                    [dX[:, 1:-1], dU[:, :-1]], dim=2), dim=(1, 2))
                + torch.sum(qp.gu * dU, dim=(1, 2))
                + torch.einsum("bi,bi->b", qp.gf,
                               torch.cat([dX[:, -1], dU[:, -1]], dim=1))
                - nu_pen_new * r_l1)
        eps_m = lc.armijo_eps(m0)

        # Halving line search over the whole batch; an instance that
        # passed keeps its step.
        a = alpha_max
        ok = full(False, torch.bool)
        for _ in range(opts.linesearch_steps):
            if not bool((~ok).any()):
                break
            m_new = _merit_batch(prob, X + a[:, None, None] * dX,
                                 U + a[:, None, None] * dU, p, mu, nu_pen_new,
                                 ltv=ltv)
            pass_ = lc.armijo_pass(m_new, m0, a, ddir, eps_m)
            a = torch.where(ok | pass_, a, 0.5 * a)
            ok = ok | pass_
        alpha = torch.where(ok, a, 0.0)

        X_new = X + alpha[:, None, None] * dX
        U_new = U + alpha[:, None, None] * dU
        bad = (~torch.isfinite(alpha)
               | ~torch.isfinite(X_new).all(dim=(1, 2))
               | ~torch.isfinite(U_new).all(dim=(1, 2)))
        X_new = torch.where(bad[:, None, None], X, X_new)
        U_new = torch.where(bad[:, None, None], U, U_new)
        no_move = bad | (alpha == 0.0)
        reg_new = lc.reg_update(reg, no_move)
        mu_new = lc.mu_update(mu, step_norm, feas, tol, floor, opts.kappa_mu)
        converged, diverged = lc.convergence(step_norm, feas, mu, reg_new,
                                             tol, floor)
        status_new = torch.where(
            converged, CONVERGED,
            torch.where(diverged, DIVERGED, status)).to(torch.int32)

        # Freeze instances that are done or out of iterations: the masking
        # jax.vmap applies to a batched while_loop carry.
        keep = done | (it >= opts.max_iter)
        sel = lambda new, old: torch.where(
            keep.view((B,) + (1,) * (new.dim() - 1)), old, new)
        X, U = sel(X_new, X), sel(U_new, U)
        mu, reg, nu_pen = sel(mu_new, mu), sel(reg_new, reg), \
            sel(nu_pen_new, nu_pen)
        it = it + torch.where(keep, 0, 1).to(torch.int32)
        done = torch.where(keep, done, done | converged | diverged)
        status = sel(status_new, status)
        kkt, feas_s = sel(step_norm, kkt), sel(feas, feas_s)

    return SolveResult(X=X, U=U, iters=it, status=status, kkt=kkt,
                       feas=feas_s,
                       obj=_cost_batch_reference(prob, X, U, p, ltv=ltv))


def _cost_batch_reference(prob: ShootingProblem, X: Tensor, U: Tensor,
                          p: MPCParams, ltv=None) -> Tensor:
    """Reference-form objective per instance (tracking on F(x_k, u_k)).
    ``ltv``: the hoisted discrete affine step of LTV mode."""
    B, Np1, nx = X.shape
    if prob.is_linear:
        xn = _defects_ltv(prob, X, U, p, ltv=ltv) + X[:, 1:]
    else:
        xn = _lanes_step(prob, *_lanes(X, U)).T.reshape(B, Np1 - 1, nx)
    e = xn - p.x_des
    j = torch.einsum("bni,bi->b", e * e, p.q)
    du = torch.diff(U, dim=1, prepend=p.u_prev[:, None, :])
    j = j + torch.einsum("bni,bi->b", du * du, p.r)
    j = j + torch.einsum("bni,bi->b", U * U, p.rm)
    ef = X[:, -1] - p.xf_des
    return j + torch.einsum("bi,bi->b", ef * ef, p.qf)
