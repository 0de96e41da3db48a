"""Shared SQP-iteration policy (port of ``mahi_mpc_tpu/solver/loop_common.py``).

The constants are the JAX package's, verbatim; the CUDA kernel receives the
ones it needs as arguments or repeats them in ``csrc/fused_sqp.cuh`` (the
CPU tests pin the two).  Every function is elementwise on tensors of any
shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

ARMIJO_SLOPE = 1e-4          # Armijo sufficient-decrease coefficient
NOISE_FLOOR_MULT = 10.0      # eps multiplier in the fp32 merit noise floor
REG_GROW = 10.0              # Levenberg ladder on line-search failure
REG_GROW_ABS = 1e-6
REG_SHRINK = 0.25
REG_MIN = 1e-8
REG_DIVERGED = 1e8           # reg at/above this => instance diverged
INNER_MU_MULT = 10.0         # inner-Newton resolution: step < 10*mu
FTB_TAU = 0.995              # fraction-to-boundary


def mu_floor(opts) -> float:
    """Barrier stop tied to the KKT tolerance: mu never needs to go below
    0.1*tol (clamped by the hard mu_min)."""
    return max(opts.mu_min, 0.1 * opts.tol)


def mu_start(has_bounds: Tensor, mu0: Tensor, floor: float,
             mu_min_opt: float) -> Tensor:
    """Initial barrier value: mu0 clamped above the floor for bounded
    instances; unbounded instances sit at mu_min (barrier inert)."""
    return torch.where(has_bounds, torch.clamp(mu0, min=floor),
                       torch.full_like(mu0, mu_min_opt))


def armijo_eps(m0: Tensor) -> Tensor:
    """Merit noise floor eps*|m0|: near convergence the predicted decrease
    drops below merit roundoff."""
    return NOISE_FLOOR_MULT * torch.finfo(m0.dtype).eps * (1.0 + m0.abs())


def armijo_pass(m_new: Tensor, m0: Tensor, alpha: Tensor, ddir: Tensor,
                eps_m: Tensor) -> Tensor:
    return torch.isfinite(m_new) & (
        m_new <= m0 + ARMIJO_SLOPE * alpha * ddir + eps_m)


def reg_update(reg: Tensor, no_move: Tensor) -> Tensor:
    """Levenberg ladder: grow on a failed line search, decay otherwise."""
    return torch.where(no_move,
                       torch.clamp(reg * REG_GROW + REG_GROW_ABS,
                                   max=REG_DIVERGED),
                       torch.clamp(reg * REG_SHRINK, min=REG_MIN))


def mu_update(mu: Tensor, step_norm: Tensor, feas: Tensor, tol: float,
              mu_min: float, kappa_mu: float) -> Tensor:
    """Monotone Fiacco-McCormick: shrink mu once the inner Newton is past
    its mu-resolution."""
    inner_done = ((step_norm < torch.clamp(INNER_MU_MULT * mu, min=tol))
                  & (feas < INNER_MU_MULT * tol))
    return torch.where(inner_done, torch.clamp(kappa_mu * mu, min=mu_min), mu)


def convergence(step_norm: Tensor, feas: Tensor, mu: Tensor, reg_new: Tensor,
                tol: float, mu_min: float) -> Tuple[Tensor, Tensor]:
    """(converged, diverged) predicates per instance."""
    converged = (step_norm < tol) & (feas < tol) & (mu <= 2.0 * mu_min)
    diverged = reg_new >= REG_DIVERGED
    return converged, diverged
