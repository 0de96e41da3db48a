"""The traced stretch's time a step outside the program's root spans: the
stretch's window over its steps less the mean time the roots
(``service.step``, ``service.set_states``, ``service.set_references``)
cover.  It holds the harness's generator, recorder and copy to the host,
and any program code under no span."""

UNIT, LAYER, MOVES = "ms", "whole step", "solves_per_s"


def read(s):
    from portbench.spans import outside_ms
    return outside_ms(s)
