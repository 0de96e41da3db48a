"""The fused SQP kernel's device time a launch, from the trace, by the
kernel's name."""

UNIT, LAYER, MOVES = "ms", "fused kernel", "solves_per_s"


def read(s):
    tr = s["trace"]
    if not tr:
        return None
    total, count = tr["kernel_s"][s["config"]["kernels"]["fused"]]
    return 1e3 * total / count if count else None
