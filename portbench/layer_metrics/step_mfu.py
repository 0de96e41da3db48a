"""The whole step's share of the chip's FP32 peak, on the host clock: the
batch times the configuration's frozen operations an instance-step (the
fused solve in fixed mode and, in LTV, the linearization and the
discretization) over the peak times the mean window step."""

UNIT, LAYER, MOVES = "%", "whole step", "solves_per_s"


def read(s):
    iters = int(s["mix"]["fixed_warm_iters"])
    if iters == 0:
        return None
    from portbench.core import step_ops
    mean_step = sum(s["step_s"]) / len(s["step_s"])
    return 100.0 * s["batch"] * step_ops(s["config"], iters) / (
        s["peaks"]["fp32_flops_per_s"] * mean_step)
