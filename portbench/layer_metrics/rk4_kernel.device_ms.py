"""The RK4 arm's fused kernel (``Generic<ArmModel<4>>`` on the group body)
device time a launch, from the trace: ``fused_kernel.device_ms``'s reading
in the cells of the RK4 configuration."""

from portbench.core import BENCH, load_module

UNIT, LAYER, MOVES = "ms", "fused kernel", "solves_per_s"


def read(s):
    return load_module(BENCH / "layer_metrics"
                       / "fused_kernel.device_ms.py").read(s)
