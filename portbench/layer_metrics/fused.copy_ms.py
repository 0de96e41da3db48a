"""The fused solve's batch-innermost copies a step: the self time of the
``fused.copy_in`` spans (the inputs' copies, the outputs and scratch
allocated) and ``fused.copy_out`` spans (the three copies back) in the
traced stretch."""

UNIT, LAYER, MOVES = "ms", "fused route host preparation", "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("fused.copy_in", "fused.copy_out"))
