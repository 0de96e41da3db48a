"""The fused solve's status rules a step: the self time of the
``fused.status`` spans in the traced stretch."""

UNIT, LAYER, MOVES = "ms", "fused route host preparation", "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("fused.status",))
