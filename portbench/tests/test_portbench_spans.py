"""The readers of the program's spans and set-up counters against a
synthetic span list and counters, with each value worked out by hand, and
nothing where there is nothing to read."""

import pytest

from mahi_mpc_tpu_torch import _build
from mahi_mpc_tpu_torch.utils import profiling
from mahi_mpc_tpu_torch.utils.profiling import Span
from portbench.core import BENCH, Cell, load_module

US = 1000   # ns


def reader(name):
    return load_module(BENCH / "layer_metrics" / f"{name}.py")


def one_step(k, ids):
    """The spans of service step ``k`` (times in us from the step's
    start), each (name, parent name, start, end, attrs); the status rule
    holds a child of its own, to be left out of its self time."""
    o = 1000 * (k - 1)
    rows = [("service.set_states", None, 0, 20, None),
            ("service.set_references", None, 20, 30, None),
            ("service.step", None, 40, 900, None),
            ("service.relinearize", "service.step", 45, 60, None),
            ("service.sync", "service.step", 60, 70, {"at": "before"}),
            ("service.solve", "service.step", 70, 700, None),
            ("fused.prepare", "service.solve", 75, 200, None),
            ("fused.discretize", "service.solve", 200, 220, None),
            ("fused.copy_in", "service.solve", 220, 300, None),
            ("fused.launch", "service.solve", 300, 350, None),
            ("fused.copy_out", "service.solve", 350, 380, None),
            ("fused.status", "service.solve", 380, 450, None),
            ("service.sync", "service.step", 700, 710, {"at": "after"}),
            ("service.status", "service.step", 710, 780, None),
            ("inner", "service.status", 720, 730, None),
            ("service.gather", "service.step", 780, 790, None)]
    out, by_name = [], {}
    for name, parent, a, b, attrs in rows:
        sid = next(ids)
        by_name[name] = sid
        out.append(Span(name, k, sid, by_name.get(parent), (o + a) * US,
                        (o + b) * US, attrs))
    return out


def span_list():
    ids = iter(range(1, 1000))
    got = one_step(7, ids) + one_step(8, ids)
    # a span of no traced step, and a root of no step: not read
    got += [Span("fused.prepare", 99, next(ids), None, 0, 5000 * US, None),
            Span("fused.launch", None, next(ids), None, 0, 5000 * US, None)]
    return got


def summary(steps=2, busy_s=0.001, ltv=False):
    cfg = Cell("arm_ltv.b64k.fixed3" if ltv else "arm.b16k.fixed3").config
    return dict(config=cfg, trace=dict(steps=steps, busy_s=busy_s,
                                       window_s=2000e-6))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "spans", span_list)


# mean a step, ms: by hand from one_step
BY_HAND = {"service.sync_wait_ms": (10 + 10) * 1e-3,
           "service.status_gather_ms": ((70 - 10) + 10) * 1e-3,
           "fused.prepare_ms": 125e-3,
           "fused.copy_ms": (80 + 30) * 1e-3,
           "fused.launch_ms": 50e-3,
           "fused.status_ms": 70e-3,
           "ltv_prep.host_ms": (15 + 20) * 1e-3,
           # a step's window 1000 us less the roots' 20 + 10 + 860 us
           "step.outside_spans_ms": 110e-3}


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_span_readers_by_hand(name, recorded):
    assert reader(name).read(summary()) == pytest.approx(BY_HAND[name])


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_span_readers_find_nothing_where_nothing_is(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name).read(summary()) is None
    monkeypatch.setattr(profiling, "spans", span_list)
    # untraced; a stretch with no device work; roots that are not its steps
    untraced = dict(summary(), trace=None)
    for s in (untraced, summary(busy_s=0.0), summary(steps=3)):
        assert reader(name).read(s) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """The parent's program has no ``spans``: every reader finds
    nothing, and none raises."""
    monkeypatch.delattr(profiling, "spans")
    for name in BY_HAND:
        assert reader(name).read(summary()) is None


def test_library_seconds_by_hand(monkeypatch):
    monkeypatch.setattr(_build.cuda_build, "seconds", {
        "fused_sqp": (41.5, 0.25), "fused_sqp_ltv": (0.0, 0.125),
        "riccati": (30.0, 0.5)})
    r = reader("setup.library_s")
    assert r.read(summary()) == pytest.approx(41.75)
    assert r.read(summary(ltv=True)) == pytest.approx(41.875)
    monkeypatch.setattr(_build.cuda_build, "seconds", {
        "fused_sqp": (41.5, 0.25)})
    assert r.read(summary(ltv=True)) is None
    monkeypatch.setattr(_build.cuda_build, "seconds", {})
    assert r.read(summary()) is None
    monkeypatch.delattr(_build.cuda_build, "seconds")
    assert r.read(summary()) is None
