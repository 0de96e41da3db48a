"""The share of the traced stretch's fused launches that ran the path the
RK4 cells are for: the ``fused.launch`` spans whose attributes read step
mode ``generic``, integrator ``rk4`` and body ``group``.  Nothing (None)
where the program records no such attributes (a program without them) or
no spans of the stretch's steps."""

UNIT, LAYER, MOVES = "%", "fused kernel", "solves_per_s"
PATH = dict(mode="generic", integrator="rk4", body="group")


def read(s):
    from portbench.spans import stretch
    found = stretch(s)
    if found is None:
        return None
    launches = [x.attrs for x in found[0] if x.name == "fused.launch"]
    if not launches or not all(a and "mode" in a for a in launches):
        return None
    on_path = sum(all(a.get(k) == v for k, v in PATH.items())
                  for a in launches)
    return 100.0 * on_path / len(launches)
