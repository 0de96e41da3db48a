from .linalg import (chol_lanes, cho_solve_lanes, cho_solve_small, chol_small,
                     spd_solve_lanes, spd_solve_small, tri_solve_lower,
                     tri_solve_upper_t)
from .precision import strict_fp32

__all__ = ["chol_lanes", "cho_solve_lanes", "spd_solve_lanes",
           "chol_small", "tri_solve_lower", "tri_solve_upper_t",
           "cho_solve_small", "spd_solve_small", "strict_fp32"]
