"""The LTV path's relinearization and discretization kernels' device time
a step (``linearize_tile_kernel`` + ``ltv_discrete_tile_kernel``), from
the trace; nothing to read in a nonlinear cell."""

UNIT, LAYER, MOVES = ("ms", "LTV relinearization and discretization",
                      "solves_per_s")


def read(s):
    tr = s["trace"]
    names = s["config"]["kernels"]["ltv_prep"]
    if not tr or not names:
        return None
    k = tr["kernel_s"]
    if not all(k[n][1] for n in names):
        return None
    return 1e3 * sum(k[n][0] for n in names) / tr["steps"]
