"""The fused route's host preparation a step, in the traced stretch: its
mean solve (``solve_time_s``) less the device time a step of the kernels
inside the solve (the configuration's ``kernels.in_solve``: the fused
kernel; in LTV also the discretization), both over the same steps."""

UNIT, LAYER, MOVES = "ms", "fused route host preparation", "solves_per_s"


def read(s):
    tr = s["trace"]
    if not tr:
        return None
    k = tr["kernel_s"]
    names = s["config"]["kernels"]["in_solve"]
    if not all(k[n][1] for n in names):
        return None
    inside = sum(k[n][0] for n in names)
    return 1e3 * (sum(tr["solve_s"]) - inside) / tr["steps"]
