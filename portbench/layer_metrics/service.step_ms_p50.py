"""The median window step, on the host clock from the state update to
the controls on the host."""

import statistics

UNIT, LAYER, MOVES = "ms", "service", "step_ms_p95"


def read(s):
    return 1e3 * statistics.median(s["step_s"])
