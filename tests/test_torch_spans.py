"""The program's spans (``mahi_mpc_tpu_torch/utils/profiling.py``
``annotate``) on the CPU: nothing is recorded outside a profiler; under
one, a service step gives its span tree (nonlinear and LTV on the plain
versions, and the kernel body's g++ build through ``_run_library``), every
child inside its parent, step ids one a step; spans of two threads keep
their own parents; the buffer's bound drops and counts."""

import ctypes
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.runtime import BatchModelControl, batch_service
from mahi_mpc_tpu_torch.solver import fused
from mahi_mpc_tpu_torch.utils import annotate, profiling
from mahi_mpc_tpu_torch.utils.profiling import (SpanBuffer, clear_spans,
                                                spans, spans_dropped)

B, N = 4, 8
STEPS = 2
SERVICE = ["service.sync", "service.solve", "service.sync", "service.status",
           "service.gather"]


def _service(is_linear=False, integrator="euler"):
    mp = ModelParameters("spans", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-20.0] * 4,
                         u_max=[20.0] * 4, dynamics_name="mahi_arm",
                         is_linear=is_linear, integrator=integrator)
    svc = BatchModelControl(
        mp, batch=B, device="cpu", Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
        Rm=[0.01] * 4, opts=SolverOptions(tol=1e-4, max_iter=30,
                                          warm_solver="fused",
                                          fixed_warm_iters=3))
    g = torch.Generator().manual_seed(0)
    svc.set_references(0.2 * torch.randn(B, N, 8, generator=g))
    svc.set_states(0.2 * torch.randn(B, 8, generator=g))
    svc.step()                      # the cold seed, outside the profiler
    return svc, g


def _traced_steps(svc, g):
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(STEPS):
            svc.set_states(svc.last.X[:, 1]
                           + 0.01 * torch.randn(B, 8, generator=g))
            svc.step()
    return spans()


def _children(recorded, parent):
    """Names of ``parent``'s children in the order they opened."""
    kids = sorted((s for s in recorded if s.parent == parent.id),
                  key=lambda s: s.start_ns)
    for k in kids:
        assert parent.start_ns <= k.start_ns <= k.end_ns <= parent.end_ns
        assert k.step == parent.step
    return [k.name for k in kids], kids


def _check_tree(recorded, relinearize, solve_children):
    roots = [s for s in recorded if s.parent is None]
    steps = [s for s in roots if s.name == "service.step"]
    first = steps[0].step
    assert [s.step for s in steps] == list(range(first, first + STEPS))
    assert sorted((s.name, s.step) for s in roots) == sorted(
        [(n, first + k) for k in range(STEPS)
         for n in ("service.set_states", "service.step")])
    for step in steps:
        names, kids = _children(recorded, step)
        assert names == (["service.relinearize"] if relinearize else []) \
            + SERVICE
        syncs = [k for k in kids if k.name == "service.sync"]
        assert [k.attrs for k in syncs] == [{"at": "before"}, {"at": "after"}]
        solve = kids[names.index("service.solve")]
        assert _children(recorded, solve)[0] == solve_children
        for k in kids:
            if k.name != "service.solve":
                assert _children(recorded, k)[0] == []
    assert spans_dropped() == 0


def test_nothing_is_recorded_outside_a_profiler():
    """Outside any profiler ``annotate`` is a working context manager that
    records nothing, and a service step records nothing."""
    clear_spans()
    with annotate("outside", step=3, at="x") as region:
        pass
    assert region is None
    svc, _ = _service()
    svc.step()
    assert spans() == [] and spans_dropped() == 0
    assert svc.steps == 2


def test_nonlinear_step_span_tree():
    """The fused route on its plain version: the service's spans and the
    preparation and status rules of ``_solve`` under ``service.solve``."""
    svc, g = _service()
    _check_tree(_traced_steps(svc, g), False,
                ["fused.prepare", "fused.status"])


def test_ltv_step_span_tree():
    """LTV adds ``service.relinearize`` to the step and
    ``fused.discretize`` to the solve."""
    svc, g = _service(is_linear=True)
    _check_tree(_traced_steps(svc, g), True,
                ["fused.prepare", "fused.discretize", "fused.status"])


def _gxx_fused(prob, p, X0=None, U0=None, opts=SolverOptions(), mu0=None,
               n_iter=None, ls_fan=None, adaptive=False):
    """``solve_batch_fused`` on the kernel body's g++ build
    (``solve_batch_fused_cpu_kernel``), as the service calls it."""
    return fused.solve_batch_fused_cpu_kernel(prob, p, X0, U0, opts, mu0,
                                              n_iter, ls_fan, adaptive)


def test_kernel_build_step_span_tree(monkeypatch):
    """Through ``_run_library`` (the g++ build of the kernel body): the
    launch and the copies back between the preparation and the status
    rules, and the workspace (``fused.copy_in``) inside the preparation, as
    on the card."""
    monkeypatch.setattr(batch_service, "solve_batch_fused", _gxx_fused)
    svc, g = _service()
    recorded = _traced_steps(svc, g)
    _check_tree(recorded, False,
                ["fused.prepare", "fused.launch", "fused.copy_out",
                 "fused.status"])
    prepares = [s for s in recorded if s.name == "fused.prepare"]
    assert len(prepares) == STEPS
    for prep in prepares:
        assert _children(recorded, prep)[0] == ["fused.copy_in"]


@pytest.mark.parametrize("is_linear, integrator, mode", [
    (False, "rk4", "generic"), (False, "euler", "fast"),
    (True, "euler", "ltv")])
def test_launch_span_records_what_ran(monkeypatch, is_linear, integrator,
                                      mode):
    """``fused.launch`` carries the step mode, the integrator, and the
    body and its width as the build reports them: a g++ build gives its
    own name and no width."""
    monkeypatch.setattr(batch_service, "solve_batch_fused", _gxx_fused)
    svc, g = _service(is_linear=is_linear, integrator=integrator)
    launches = [s for s in _traced_steps(svc, g) if s.name == "fused.launch"]
    assert len(launches) == STEPS
    for s in launches:
        assert s.attrs == dict(mode=mode, integrator=integrator,
                               body="mpc_fused_solve_cpu_f32", width=None)


def test_launch_records_the_body_the_launcher_wrote():
    """On the card the launcher writes the body it launched and its
    threads an instance; -1 where it launched nothing (B = 0)."""
    launched = lambda body, width: (ctypes.c_int * 2)(body, width)
    assert fused._launched(None, launched(1, 4)) == dict(body="group",
                                                         width=4)
    assert fused._launched(None, launched(2, 256)) == dict(body="block",
                                                           width=256)
    assert fused._launched(None, launched(-1, 0)) == dict(body=None,
                                                          width=0)


def test_two_threads_keep_their_own_parents(monkeypatch):
    """Spans opened on two threads at once, interleaved by a barrier: each
    child's parent is its own thread's span.  A profiler collects on the
    thread that started it, so the switch is turned on for both."""
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    clear_spans()
    barrier = threading.Barrier(2, timeout=10)

    def work(i):
        with annotate(f"outer{i}", step=i):
            barrier.wait()
            with annotate(f"inner{i}"):
                barrier.wait()
            barrier.wait()

    threads = [threading.Thread(target=work, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in spans()}
    assert len(by_name) == 4
    for i in (1, 2):
        outer, inner = by_name[f"outer{i}"], by_name[f"inner{i}"]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.step == outer.step == i


def test_buffer_bound_and_dropped_count(monkeypatch):
    """A full buffer keeps the spans that closed first and counts the
    rest; ``clear_spans`` empties both."""
    monkeypatch.setattr(profiling, "_BUFFER", SpanBuffer(capacity=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with annotate(f"s{k}"):
                pass
    assert [s.name for s in spans()] == ["s0", "s1", "s2"]
    assert spans_dropped() == 2
    clear_spans()
    assert spans() == [] and spans_dropped() == 0
