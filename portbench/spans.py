"""The program's spans for the per-layer metrics that read them.

The port records a span (``mahi_mpc_tpu_torch.utils.profiling.annotate``)
around each part of the service step and of the fused route's host
preparation while a profiler collects: here, the traced stretch alone.
These helpers take the spans of that stretch's steps (those of its
``service.step`` roots, by step id) and give a mean a step in ms of their
self time: a span's duration less what its child spans cover.  They find
nothing (None) where the program records no spans (a program without
them, an untraced run), where the stretch's roots are not exactly its
steps, and where the stretch saw no device work (the CPU): the spans
split the host time that paces the card.
"""

from __future__ import annotations

STEP = "service.step"
ROOTS = ("service.step", "service.set_states", "service.set_references")


def _covered(intervals) -> int:
    """Nanoseconds the union of ``intervals`` covers."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def stretch(s):
    """(the spans of the traced stretch's steps, the number of steps), or
    None where there is nothing to read."""
    tr = s.get("trace")
    if not tr or tr.get("busy_s", 0.0) <= 0.0:
        return None
    try:
        from mahi_mpc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = spans()
    steps = [x.step for x in got if x.name == STEP and x.parent is None]
    if not steps or len(steps) != tr["steps"] or len(set(steps)) != len(steps):
        return None
    ids = set(steps)
    return [x for x in got if x.step in ids], len(steps)


def self_ms(s, names):
    """Mean a step of the summed self time of the spans named ``names``."""
    found = stretch(s)
    if found is None:
        return None
    got, n = found
    kids: dict = {}
    for x in got:
        kids.setdefault(x.parent, []).append(x)
    total, seen = 0, False
    for x in got:
        if x.name in names:
            seen = True
            total += (x.end_ns - x.start_ns) - _covered(
                (max(c.start_ns, x.start_ns), min(c.end_ns, x.end_ns))
                for c in kids.get(x.id, ()) if c.end_ns > x.start_ns
                and c.start_ns < x.end_ns)
    return total / n / 1e6 if seen else None


def outside_ms(s):
    """Mean a step of the traced stretch's time that no root span covers:
    the window a step less the mean time ``ROOTS`` cover."""
    found = stretch(s)
    if found is None:
        return None
    got, n = found
    tr = s["trace"]
    roots = [(x.start_ns, x.end_ns) for x in got
             if x.parent is None and x.name in ROOTS]
    return 1e3 * tr["window_s"] / tr["steps"] - _covered(roots) / n / 1e6
