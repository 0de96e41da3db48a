"""The device's idle share of the traced stretch: 1 - the union of its
kernel, copy and set intervals over the stretch's length."""

UNIT, LAYER, MOVES = "%", "device", "solves_per_s"


def read(s):
    tr = s["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
