from .sqp import (CONVERGED, DIVERGED, MAX_ITER, SolveResult, solve,
                  solve_batch)
from .fixed import solve_fixed
from .fused import fused_supported, solve_batch_fused
from .riccati import (LQRSolution, register_backend, resolve_kkt_backend,
                      solve_lqr)
from . import pariccati  # registers kkt_backend="pariccati"
from .batched import solve_batch_lanes
from .select import resolve_warm_solver

__all__ = [
    "SolveResult", "CONVERGED", "MAX_ITER", "DIVERGED",
    "solve", "solve_batch", "solve_fixed",
    "solve_batch_fused", "fused_supported", "resolve_warm_solver",
    "solve_batch_lanes", "solve_lqr", "register_backend", "resolve_kkt_backend",
    "LQRSolution",
]
