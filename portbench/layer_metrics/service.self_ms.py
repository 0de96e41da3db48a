"""The service's own time a step: the mean window step less the mean
solve (``BatchModelControl.solve_time_s``, the host clock between the
step's two synchronisations).  It holds ``relinearize``, the status rule,
the gather, the state and reference updates and the copy to the host."""

UNIT, LAYER, MOVES = "ms", "service", "solves_per_s"


def read(s):
    n = len(s["step_s"])
    return 1e3 * (sum(s["step_s"]) - sum(s["solve_s"])) / n
