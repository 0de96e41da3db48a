from .sqp import CONVERGED, DIVERGED, MAX_ITER, SolveResult
from .fused import fused_supported, solve_batch_fused
from .select import resolve_warm_solver

__all__ = [
    "SolveResult", "CONVERGED", "MAX_ITER", "DIVERGED",
    "solve_batch_fused", "fused_supported", "resolve_warm_solver",
]
