"""The device's idle share of the traced stretch in the cells of the RK4
configuration: ``device.idle_pct``'s reading."""

from portbench.core import BENCH, load_module

UNIT, LAYER, MOVES = "%", "device", "solves_per_s"


def read(s):
    return load_module(BENCH / "layer_metrics" / "device.idle_pct.py").read(s)
