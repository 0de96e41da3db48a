from .linalg import chol_lanes, cho_solve_lanes, spd_solve_lanes

__all__ = ["chol_lanes", "cho_solve_lanes", "spd_solve_lanes"]
