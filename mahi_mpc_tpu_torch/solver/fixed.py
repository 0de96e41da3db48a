"""Fixed-iteration SQP for the single-instance hot path (port of
``mahi_mpc_tpu/solver/fixed.py``).

The latency shape of ``solve`` (the reference's 1 kHz budget,
``thread_model_control_example.cpp:70-71,108``): exactly ``n_iter`` SQP
iterations with no data-dependent control flow, and in place of the
halving line search a fan of candidate steps ``alpha_max * (1, 1/2, 1/4,
1/16)``, whose largest Armijo-passing candidate wins.  The QP build, the
Riccati step (the scan, as ``solve`` resolves ``kkt_backend="auto"``), the
barrier schedule and the safeguards are ``solve``'s.  Cold starts belong
to ``solve``; this serves warm re-solves near the optimum.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import vmap

from ..ops.precision import strict_fp32
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem, map_params
from . import loop_common as lc
from .riccati import resolve_kkt_backend
from .sqp import (CONVERGED, MAX_ITER, SolveResult, _advance, _batched,
                  _newton, _start)
from .stage_qp import merit

Tensor = torch.Tensor

LS_FAN = (1.0, 0.5, 0.25, 0.0625)


@strict_fp32()
def solve_fixed(prob: ShootingProblem, p: MPCParams,
                X0: Optional[Tensor] = None, U0: Optional[Tensor] = None,
                opts: SolverOptions = SolverOptions(), mu0=None,
                n_iter: int = 3) -> SolveResult:
    """Exactly ``n_iter`` SQP iterations of one instance (``p`` unbatched,
    ``X0`` (N+1, nx), ``U0`` (N, nu)), the contract of ``solve`` without
    its adaptivity: ``mu0`` defaults to ``warm_mu_factor * tol``, and the
    status is CONVERGED when the last Newton step and the defects pass
    ``opts.tol``, MAX_ITER otherwise (a warm consumer treats that as
    usable)."""
    pb = map_params(_batched, p)
    dtype, device = p.x0.dtype, p.x0.device
    X, U, mu = _start(prob, pb, _batched(X0), _batched(U0), opts,
                      opts.warm_mu_factor * opts.tol if mu0 is None else mu0)
    backend = resolve_kkt_backend(opts.kkt_backend, batched=False)
    one = lambda v: torch.full((1,), v, dtype=dtype, device=device)
    reg, nu_pen = one(lc.REG_MIN), one(1.0)
    step_norm, feas = one(float("inf")), one(float("inf"))
    fan = torch.tensor(LS_FAN, dtype=dtype, device=device)

    for _ in range(n_iter):
        st = _newton(prob, X, U, pb, mu, reg, nu_pen, opts, backend)
        step_norm, feas, nu_pen = st.step_norm, st.feas, st.nu_pen
        alphas = st.alpha_max * fan                               # (K,)
        merits = torch.cat([
            merit(prob, X + a * st.dX, U + a * st.dU, pb, mu, nu_pen)
            for a in alphas])                                     # (K,)
        passing = lc.armijo_pass(merits, st.m0, alphas, st.ddir, st.eps_m)
        # The largest passing candidate (the fan descends); 0 if none.
        first = torch.argmax(passing.to(torch.int32))
        alpha = torch.where(passing.any(), alphas[first], 0.0)[None]
        X, U, reg, mu = _advance(X, U, st, alpha, mu, reg, opts)

    converged = (step_norm < opts.tol) & (feas < opts.tol)
    status = torch.where(converged, CONVERGED, MAX_ITER).to(torch.int32)
    return SolveResult(
        X=X[0], U=U[0],
        iters=torch.tensor(n_iter, dtype=torch.int32, device=device),
        status=status[0], kkt=step_norm[0], feas=feas[0],
        obj=vmap(prob.cost)(X, U, pb)[0])
