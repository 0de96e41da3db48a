"""The readers of the RK4 cell: the share of fused launches on the path the
cell is for, from the attributes of the ``fused.launch`` spans, against a
synthetic span list; nothing where the program records no attributes or no
spans; and the readers that reuse another reader's arithmetic read what it
reads."""

import pytest

from mahi_mpc_tpu_torch.utils import profiling
from portbench.core import BENCH, Cell, load_module
from portbench.tests.test_portbench_spans import span_list

RK4 = dict(mode="generic", integrator="rk4", body="group", width=4)
EULER = dict(mode="fast", integrator="euler", body="group", width=4)


def reader(name):
    return load_module(BENCH / "layer_metrics" / f"{name}.py")


def summary(steps=2, busy_s=0.001):
    cfg = Cell("arm_rk4.b16k.fixed3").config
    return dict(config=cfg, mix=Cell("arm_rk4.b16k.fixed3").mix,
                batch=16384, peaks=Cell("arm_rk4.b16k.fixed3").peaks,
                fused_io_bytes=4096,
                trace=dict(steps=steps, busy_s=busy_s, window_s=0.05,
                           kernel_s={"fused_sqp_group_kernel": [0.041, 2]}))


def with_attrs(*attrs):
    """The synthetic span list with its stretch's ``fused.launch`` spans
    carrying ``attrs`` in turn (the root one of no step is not read)."""
    got, k = [], 0
    for s in span_list():
        if s.name == "fused.launch" and s.step is not None:
            s = s._replace(attrs=attrs[k % len(attrs)])
            k += 1
        got.append(s)
    return lambda: got


@pytest.mark.parametrize("attrs, share", [((RK4,), 100.0),
                                          ((RK4, EULER), 50.0),
                                          ((dict(RK4, body="thread"),), 0.0),
                                          ((dict(RK4, integrator="midpoint"),),
                                           0.0)])
def test_generic_launch_share(monkeypatch, attrs, share):
    monkeypatch.setattr(profiling, "spans", with_attrs(*attrs))
    assert reader("rk4.generic_launch_pct").read(summary()) == share


def test_generic_launch_share_finds_nothing_where_nothing_is(monkeypatch):
    r = reader("rk4.generic_launch_pct")
    monkeypatch.setattr(profiling, "spans", span_list)   # no attributes
    assert r.read(summary()) is None
    monkeypatch.setattr(profiling, "spans", with_attrs(RK4))
    assert r.read(summary(busy_s=0.0)) is None
    assert r.read(dict(summary(), trace=None)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert r.read(summary()) is None
    monkeypatch.delattr(profiling, "spans")
    assert r.read(summary()) is None


@pytest.mark.parametrize("name, base", [
    ("rk4_kernel.device_ms", "fused_kernel.device_ms"),
    ("fused_sqp_generic_roofline", "fused_sqp_group_kernel_roofline"),
    ("rk4.device_idle_pct", "device.idle_pct")])
def test_reused_readers_read_as_their_base(name, base):
    s = summary()
    assert reader(name).read(s) == reader(base).read(s) is not None
    assert reader(name).read(dict(s, trace=None)) is None
