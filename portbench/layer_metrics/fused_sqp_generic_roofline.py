"""The share of its roofline of the fused kernel's ``Generic`` step policy
(``csrc/fused_sqp_generic.cu``; the RK4 arm's ``Generic<ArmModel<4>>`` on
the group body) in fixed mode: ``fused_sqp_group_kernel_roofline``'s
reading (the batch times the configuration's frozen operations a fixed
iteration times the iterations over the FP32 peak, or the bytes computed
from the shapes over HBM, the larger, over the launch's device time) in
the cells of the RK4 configuration."""

from portbench.core import BENCH, load_module

UNIT, LAYER, MOVES = "%", "fused kernel", "solves_per_s"


def read(s):
    return load_module(BENCH / "layer_metrics"
                       / "fused_sqp_group_kernel_roofline.py").read(s)
