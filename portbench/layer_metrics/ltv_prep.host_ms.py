"""The LTV path's linearization and discretization a step, on the host:
the self time of the ``service.relinearize`` and ``fused.discretize``
spans in the traced stretch (their kernels' device time is
``ltv_prep.device_ms``)."""

UNIT, LAYER, MOVES = "ms", "LTV relinearization and discretization", \
    "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("service.relinearize", "fused.discretize"))
