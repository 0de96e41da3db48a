"""Structured SQP / interior-point driver (port of
``mahi_mpc_tpu/solver/sqp.py``).

The replacement for the reference's IPOPT solve (``ModelControl.cpp:159``):
a Gauss-Newton SQP over the multiple-shooting NLP, box bounds handled by a
monotone log barrier, each barrier-Newton step solved exactly by a Riccati
backend, globalized by a halving Armijo line search on an l1 merit with a
fraction-to-boundary cap.

``solve_batch`` is one driver over a leading batch B with the semantics of
the JAX package's ``jax.vmap(solve)``: an instance that is done or out of
iterations is frozen while the others iterate, each instance halves its
own step until it passes or runs out of rungs, and failure is a status
code, never an exception.  ``solve`` is that driver at B = 1.  Where the
JAX while loops test ``jnp.any(...)``, this loop reads one host scalar per
SQP iteration and per line-search rung.  Every model runs here: the
stage Jacobians come from ``jacfwd`` through the instance's step, so the
dynamics need not be lanes-polymorphic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from ..ops.precision import strict_fp32
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem, map_params
from . import loop_common as lc
from .riccati import resolve_kkt_backend, solve_lqr
from .stage_qp import StageQP, build_stage_qp, fraction_to_boundary, merit

Tensor = torch.Tensor

# Status codes: per-instance status carried in the batch.
CONVERGED = 0
MAX_ITER = 1
DIVERGED = 2


class SolveResult(NamedTuple):
    X: Tensor       # (B, N+1, nx)
    U: Tensor       # (B, N, nu)
    iters: Tensor   # int32, SQP iterations taken
    status: Tensor  # int32: 0 converged / 1 max_iter / 2 diverged
    kkt: Tensor     # final Newton-step inf-norm (stationarity proxy)
    feas: Tensor    # final defect inf-norm
    obj: Tensor     # reference-form objective at the solution


INTERIOR_DELTA = 1e-3     # the widest margin `_strict_interior` keeps


def _strict_interior(v: Tensor, lo: Tensor, hi: Tensor,
                     delta: float = INTERIOR_DELTA) -> Tensor:
    """Clip into the strict interior of a (possibly infinite) box so barrier
    terms are well-defined at the initial iterate.  ``lo``/``hi`` broadcast
    against ``v``."""
    inf = torch.full_like(lo, float("inf"))
    width = torch.where(torch.isfinite(lo) & torch.isfinite(hi), hi - lo, inf)
    d = torch.clamp(0.25 * width, max=delta)
    lo_c = torch.where(torch.isfinite(lo), lo + d, -inf)
    hi_c = torch.where(torch.isfinite(hi), hi - d, inf)
    return torch.minimum(torch.maximum(v, lo_c), hi_c)


# ---- pieces shared with solver/fixed.py -----------------------------------

def _start(prob: ShootingProblem, p: MPCParams, X0: Optional[Tensor],
           U0: Optional[Tensor], opts: SolverOptions, mu0):
    """The initial iterate (node 0 pinned to the measurement, the rest
    clipped into the interior) and barrier, for a (B, ...) batch."""
    nx, nu, N = prob.nx, prob.nu, prob.N
    B = p.x0.shape[0]
    kw = dict(dtype=p.x0.dtype, device=p.x0.device)
    if X0 is None:
        X0 = torch.zeros(B, N + 1, nx, **kw)
    if U0 is None:
        U0 = torch.zeros(B, N, nu, **kw)
    X = torch.cat([p.x0[:, None],
                   _strict_interior(X0[:, 1:].to(p.x0.dtype),
                                    p.x_min[:, None], p.x_max[:, None])],
                  dim=1)
    U = _strict_interior(U0.to(p.x0.dtype), p.u_min[:, None],
                         p.u_max[:, None])
    fin = lambda t: torch.isfinite(t).any(dim=1)
    has_bounds = fin(p.u_min) | fin(p.u_max) | fin(p.x_min) | fin(p.x_max)
    mu = lc.mu_start(has_bounds, torch.as_tensor(mu0, **kw).expand(B),
                     lc.mu_floor(opts), opts.mu_min)
    return X, U, mu


class _Newton(NamedTuple):
    """One barrier-Newton step at an iterate, with what the line search
    needs."""
    qp: StageQP
    dX: Tensor         # (B, N+1, nx)
    dU: Tensor         # (B, N, nu)
    step_norm: Tensor  # (B,)
    feas: Tensor       # (B,)
    nu_pen: Tensor     # (B,) l1 weight, monotone
    alpha_max: Tensor  # (B,) fraction-to-boundary cap
    m0: Tensor         # (B,) merit at the iterate
    ddir: Tensor       # (B,) directional derivative of the merit
    eps_m: Tensor      # (B,) merit noise floor


def _newton(prob: ShootingProblem, X: Tensor, U: Tensor, p: MPCParams,
            mu: Tensor, reg: Tensor, nu_pen: Tensor, opts: SolverOptions,
            backend: str) -> _Newton:
    nx = prob.nx
    qp = build_stage_qp(prob, X, U, p, mu, reg,
                        n_pin=opts.num_control_inputs_saved)
    sol = solve_lqr(qp, backend)
    dX, dU = sol.dz[..., :nx], sol.du
    step_norm = torch.maximum(torch.amax(dX.abs(), dim=(1, 2)),
                              torch.amax(dU.abs(), dim=(1, 2)))
    feas = torch.amax(qp.r.abs(), dim=(1, 2))
    nu_pen = torch.maximum(
        nu_pen, 2.0 * torch.amax(sol.lam.abs(), dim=(1, 2)) + 1.0)
    a_u = torch.amin(fraction_to_boundary(
        U, dU, p.u_min[:, None], p.u_max[:, None]), dim=1)
    a_x = torch.amin(fraction_to_boundary(
        X[:, 1:], dX[:, 1:], p.x_min[:, None], p.x_max[:, None]), dim=1)
    m0 = merit(prob, X, U, p, mu, nu_pen)
    # The merit's derivative along the step: stage k's gz pairs with
    # [dx_k ; du_{k-1}], the terminal gf with [dx_N ; du_{N-1}].
    ddir = (torch.sum(qp.gz[:, 1:] * torch.cat([dX[:, 1:-1], dU[:, :-1]],
                                               dim=2), dim=(1, 2))
            + torch.sum(qp.gu * dU, dim=(1, 2))
            + torch.sum(qp.gf * torch.cat([dX[:, -1], dU[:, -1]], dim=1),
                        dim=1)
            - nu_pen * torch.sum(torch.abs(qp.r), dim=(1, 2)))
    return _Newton(qp, dX, dU, step_norm, feas, nu_pen,
                   torch.minimum(a_u, a_x), m0, ddir, lc.armijo_eps(m0))


def _advance(X: Tensor, U: Tensor, st: _Newton, alpha: Tensor, mu: Tensor,
             reg: Tensor, opts: SolverOptions):
    """Take the step ``alpha`` (B,) with the non-finite safeguard, then the
    regularization ladder and the barrier schedule: (X, U, reg, mu)."""
    X_new = X + alpha[:, None, None] * st.dX
    U_new = U + alpha[:, None, None] * st.dU
    bad = (~torch.isfinite(alpha) | ~torch.isfinite(X_new).all(dim=(1, 2))
           | ~torch.isfinite(U_new).all(dim=(1, 2)))
    X_new = torch.where(bad[:, None, None], X, X_new)
    U_new = torch.where(bad[:, None, None], U, U_new)
    reg = lc.reg_update(reg, bad | (alpha == 0.0))
    mu = lc.mu_update(mu, st.step_norm, st.feas, float(opts.tol),
                      lc.mu_floor(opts), opts.kappa_mu)
    return X_new, U_new, reg, mu


def _batched(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t[None]


# ---- the drivers -----------------------------------------------------------

@strict_fp32()
def solve_batch(prob: ShootingProblem, p: MPCParams,
                X0: Optional[Tensor] = None, U0: Optional[Tensor] = None,
                opts: SolverOptions = SolverOptions(),
                mu0=None) -> SolveResult:
    """Solve B receding-horizon NLP instances, the JAX package's
    ``solve_batch`` (``jax.vmap(solve)``): every field of ``p`` carries a
    leading B, ``X0`` (B, N+1, nx) and ``U0`` (B, N, nu) warm-start it
    (zeros when None), ``mu0`` is the initial barrier (default
    ``opts.mu_init``; warm re-solves pass a small value).  The KKT backend
    resolves as for one instance: ``"auto"`` is the scan, and
    ``kkt_backend="pallas"`` reaches the Riccati kernel."""
    B = p.x0.shape[0]
    dtype, device = p.x0.dtype, p.x0.device
    X, U, mu = _start(prob, p, X0, U0, opts,
                      opts.mu_init if mu0 is None else mu0)
    tol, floor = float(opts.tol), lc.mu_floor(opts)
    backend = resolve_kkt_backend(opts.kkt_backend, batched=False)

    full = lambda v, dt=dtype: torch.full((B,), v, dtype=dt, device=device)
    reg, nu_pen = full(lc.REG_MIN), full(1.0)
    it = full(0, torch.int32)
    done = full(False, torch.bool)
    status = full(MAX_ITER, torch.int32)
    kkt, feas = full(float("inf")), full(float("inf"))

    while bool(((~done) & (it < opts.max_iter)).any()):
        # Instances done or out of iterations are frozen: the masking
        # jax.vmap applies to a batched while_loop carry.
        keep = done | (it >= opts.max_iter)
        st = _newton(prob, X, U, p, mu, reg, nu_pen, opts, backend)

        # Halving Armijo search, each instance on its own: an instance that
        # passed keeps its step and stops halving.
        a = st.alpha_max
        ok = full(False, torch.bool)
        for _ in range(opts.linesearch_steps):
            if not bool((~ok & ~keep).any()):
                break
            m_new = merit(prob, X + a[:, None, None] * st.dX,
                          U + a[:, None, None] * st.dU, p, mu, st.nu_pen)
            pass_ = lc.armijo_pass(m_new, st.m0, a, st.ddir, st.eps_m)
            a = torch.where(ok | pass_, a, 0.5 * a)
            ok = ok | pass_
        alpha = torch.where(ok, a, 0.0)

        X_new, U_new, reg_new, mu_new = _advance(X, U, st, alpha, mu, reg,
                                                 opts)
        converged, diverged = lc.convergence(st.step_norm, st.feas, mu,
                                             reg_new, tol, floor)
        status_new = torch.where(
            converged, CONVERGED,
            torch.where(diverged, DIVERGED, status)).to(torch.int32)

        sel = lambda new, old: torch.where(
            keep.view((B,) + (1,) * (new.dim() - 1)), old, new)
        X, U = sel(X_new, X), sel(U_new, U)
        mu, reg, nu_pen = sel(mu_new, mu), sel(reg_new, reg), \
            sel(st.nu_pen, nu_pen)
        it = it + torch.where(keep, 0, 1).to(torch.int32)
        done = torch.where(keep, done, done | converged | diverged)
        status = sel(status_new, status)
        kkt, feas = sel(st.step_norm, kkt), sel(st.feas, feas)

    return SolveResult(X=X, U=U, iters=it, status=status, kkt=kkt, feas=feas,
                       obj=vmap(prob.cost)(X, U, p))


def solve(prob: ShootingProblem, p: MPCParams,
          X0: Optional[Tensor] = None, U0: Optional[Tensor] = None,
          opts: SolverOptions = SolverOptions(), mu0=None) -> SolveResult:
    """Solve one instance: ``p`` with unbatched fields, ``X0`` (N+1, nx),
    ``U0`` (N, nu); ``solve_batch`` at B = 1.  Warm-start with (X0, U0)
    (reference C7, ``ModelControl.cpp:161``); zeros otherwise.  ``mu0``:
    the initial barrier (default ``opts.mu_init``); warm re-solves pass a
    small value such as ``warm_mu_factor * tol``."""
    res = solve_batch(prob, map_params(_batched, p), _batched(X0),
                      _batched(U0), opts, mu0)
    return SolveResult(*[t[0] for t in res])
