"""The fused solve's preparation a step (shape checks, the interior clip
of X and U, the ``cat``, the barrier's start): the self time of the
``fused.prepare`` spans in the traced stretch."""

UNIT, LAYER, MOVES = "ms", "fused route host preparation", "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("fused.prepare",))
