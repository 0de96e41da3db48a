"""The fused kernel's share of its roofline in fixed mode: the least time
the chip could take for a launch (the configuration's frozen operations a
fixed iteration times the iterations, over the FP32 peak; or the bytes
computed from the shapes over HBM; the larger, for the batch) over the
launch's device time.  In fixed mode the function's work does not depend
on the data; adaptive steps have nothing to read here."""

UNIT, LAYER, MOVES = "%", "fused kernel", "solves_per_s"


def read(s):
    iters = int(s["mix"]["fixed_warm_iters"])
    tr = s["trace"]
    if iters == 0 or not tr:
        return None
    total, count = tr["kernel_s"][s["config"]["kernels"]["fused"]]
    if not count:
        return None
    from portbench.core import fused_ops, roofline_pct
    B = s["batch"]
    return roofline_pct(B * fused_ops(s["config"], iters),
                        B * s["fused_io_bytes"], total / count, s["peaks"])
