"""The yardstick's arithmetic against values worked out by hand."""

import math
from types import SimpleNamespace as NS

import pytest

from portbench import core
from portbench.core import BENCH, Cell, load_module

PEAKS = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def reader(name):
    return load_module(BENCH / "layer_metrics" / f"{name}.py")


def test_fused_io_bytes_by_hand():
    arm = Cell("arm.b16k.fixed3").config
    ltv = Cell("arm_ltv.b64k.fixed3").config
    # in: X 26*8, U 25*4, x_des 25*8, q 8, r 4, rm 4, u_prev 4, u bounds
    # 4+4, x bounds 8+8, qf 8, xf_des 8, mu 1; out: X 208, U 100, stats 8
    ins = 208 + 100 + 200 + 8 + 4 + 4 + 4 + 8 + 16 + 8 + 8 + 1
    assert core.fused_io_bytes(arm) == 4 * (ins + 316) == 3540
    assert core.fused_io_bytes(ltv) == 3540 + 4 * (64 + 32 + 8)


def test_operations_by_hand():
    arm = Cell("arm.b16k.fixed3").config
    ltv = Cell("arm_ltv.b64k.fixed3").config
    assert core.fused_ops(arm, 3) == 2_655_828
    assert core.step_ops(arm, 3) == 2_655_828
    assert core.step_ops(ltv, 3) == 575_256 + 21_140 + 4_057


def test_roofline_by_hand():
    # 16384 instances of the arm's fixed-3 solve: 4.3513e10 operations,
    # 0.64945 ms at 67 TFLOP/s; 58.0 MB, 0.01731 ms at 3.35 TB/s
    ops, nbytes = 16384 * 2_655_828, 16384 * 3540
    assert core.roofline_pct(ops, nbytes, 7.5e-3, PEAKS) == pytest.approx(
        100 * (ops / 67e12) / 7.5e-3)
    assert core.roofline_pct(1.0, 3.35e12, 2.0, PEAKS) == pytest.approx(50.0)


def test_end_to_end_by_hand():
    s = dict(setup_s=9.5, batch=100, steps=4, window_s=2.0,
             step_s=[0.1, 0.2, 0.3, 0.4, 0.5] * 4)
    assert core.END_TO_END["setup_s"](s) == 9.5
    assert core.END_TO_END["solves_per_s"](s) == 200.0
    # numpy's linear percentile of 20 values: rank 0.95 * 19 = 18.05
    assert core.END_TO_END["step_ms_p95"](s) == pytest.approx(500.0)


def summary(fixed=3, trace=True, ltv=False):
    cfg = Cell("arm_ltv.b64k.fixed3" if ltv else "arm.b16k.fixed3").config
    kernels = {"fused_sqp_group_kernel": [0.075, 10]}
    if ltv:
        kernels.update(linearize_tile_kernel=[0.0004, 10],
                       ltv_discrete_tile_kernel=[0.0001, 10])
    return dict(config=cfg, mix=dict(fixed_warm_iters=fixed), peaks=PEAKS,
                batch=16384, step_s=[0.010, 0.012, 0.011],
                solve_s=[0.009, 0.010, 0.009], mean_iters=2.5,
                fused_io_bytes=core.fused_io_bytes(cfg),
                trace=dict(busy_s=0.08, window_s=0.1, steps=10,
                           solve_s=[0.0092] * 5 + [0.0094] * 5,
                           kernel_s=kernels) if trace else None)


def test_readers_by_hand():
    s = summary()
    assert reader("device.idle_pct").read(s) == pytest.approx(20.0)
    assert reader("service.self_ms").read(s) == pytest.approx(5 / 3)
    assert reader("service.step_ms_p50").read(s) == pytest.approx(11.0)
    # the traced steps' mean solve 9.3 ms less the fused kernel's 7.5 ms
    assert reader("fused.host_ms").read(s) == pytest.approx(9.3 - 7.5)
    assert reader("fused_kernel.device_ms").read(s) == pytest.approx(7.5)
    assert reader("fused_sqp_group_kernel_roofline").read(s) == \
        pytest.approx(100 * max(16384 * 2_655_828 / 67e12,
                                16384 * 3540 / 3.35e12) / 7.5e-3)
    assert reader("step_mfu").read(s) == pytest.approx(
        100 * 16384 * 2_655_828 / (67e12 * 0.011))
    assert reader("ltv_prep.device_ms").read(s) is None
    assert reader("solver.mean_iters").read(s) is None
    lt = summary(ltv=True)
    assert reader("ltv_prep.device_ms").read(lt) == pytest.approx(0.05)
    assert reader("fused.host_ms").read(lt) == pytest.approx(
        9.3 - 7.5 - 0.01)


def test_readers_find_nothing_where_nothing_is():
    ad = summary(fixed=0)
    assert reader("solver.mean_iters").read(ad) == 2.5
    for name in ("fused_sqp_group_kernel_roofline", "step_mfu"):
        assert reader(name).read(ad) is None
    untraced = summary(trace=False)
    for name in ("device.idle_pct", "fused.host_ms",
                 "fused_kernel.device_ms", "fused_sqp_group_kernel_roofline",
                 "ltv_prep.device_ms"):
        assert reader(name).read(untraced) is None


def ev(name, dev, a, b):
    from torch.autograd import DeviceType
    return NS(name=name, time_range=NS(start=a, end=b),
              device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def test_trace_reduction_by_hand():
    events = [ev("aten::copy_", False, 50, 65),
              ev("service_step", True, 0, 60),   # a host range mirrored
              ev("service_step", False, 0, 60),
              ev("fused_sqp_group_kernel<x>", True, 10, 30),
              ev("other", True, 20, 45),
              ev("memcpy", True, 70, 80),
              ev("other", True, 90, 95)]
    tr = core.device_time(events, ["fused_sqp_group_kernel"])
    # busy: [10, 45], [70, 80] and [90, 95]
    assert tr["busy_s"] == pytest.approx(50e-6)
    assert tr["kernel_s"]["fused_sqp_group_kernel"] == [
        pytest.approx(20e-6), 1]
    assert all(n != "service_step" for n, _ in tr["device_ops"])
    # the gaps [45, 70] and [80, 90], each named by the operation after it
    gaps = dict(core.idle_gaps(events))
    assert gaps == {"before memcpy": pytest.approx(25e-6),
                    "before other": pytest.approx(10e-6)}
    assert math.isclose(sum(gaps.values()) + tr["busy_s"], 85e-6)
