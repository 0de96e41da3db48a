"""How long the host waits on the card a step: the time in the service
step's two ``service.sync`` spans (before and after the solve; they hold
no child span), from the program's spans in the traced stretch."""

UNIT, LAYER, MOVES = "ms", "service", "solves_per_s"


def read(s):
    from portbench.spans import self_ms
    return self_ms(s, ("service.sync",))
