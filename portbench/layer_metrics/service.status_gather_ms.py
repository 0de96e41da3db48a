"""The service's failed-instance rule and gather a step: the self time of
the ``service.status`` and ``service.gather`` spans in the traced
stretch."""

UNIT, LAYER, MOVES = "ms", "service", "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("service.status", "service.gather"))
