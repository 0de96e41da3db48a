"""Status codes, the solve result and the interior clip (port of
``mahi_mpc_tpu/solver/sqp.py:35-75``).  The single-instance SQP driver
itself is not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def _strict_interior(v: Tensor, lo: Tensor, hi: Tensor,
                     delta: float = 1e-3) -> Tensor:
    """Clip into the strict interior of a (possibly infinite) box so barrier
    terms are well-defined at the initial iterate.  ``lo``/``hi`` broadcast
    against ``v``."""
    inf = torch.full_like(lo, float("inf"))
    width = torch.where(torch.isfinite(lo) & torch.isfinite(hi), hi - lo, inf)
    d = torch.clamp(0.25 * width, max=delta)
    lo_c = torch.where(torch.isfinite(lo), lo + d, -inf)
    hi_c = torch.where(torch.isfinite(hi), hi - d, inf)
    return torch.minimum(torch.maximum(v, lo_c), hi_c)
