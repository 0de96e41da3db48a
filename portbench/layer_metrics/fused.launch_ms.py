"""The fused kernel's launch a step, on the host: the self time of the
``fused.launch`` spans (the ctypes arguments packed, until the launcher
returns) in the traced stretch."""

UNIT, LAYER, MOVES = "ms", "fused route host preparation", "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("fused.launch",))
