"""SQP iterations a warm instance-solve, averaged over the window (the
service's per-instance counts); fixed mode always runs its fixed count,
so only adaptive cells have something to read."""

UNIT, LAYER, MOVES = "iters", "SQP in the kernel", "solves_per_s"


def read(s):
    if int(s["mix"]["fixed_warm_iters"]) != 0:
        return None
    return s["mean_iters"]
