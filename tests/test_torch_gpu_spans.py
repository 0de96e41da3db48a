"""The program's spans on the card (marked ``gpu``; the ``cuda`` fixture
skips without one)::

    python -m pytest tests/test_torch_gpu_spans.py -m gpu -q

The 4-DOF arm's fixed-3 service at B=16384, the benchmark's main cell,
traced as the benchmark traces it (``torch.profiler``, CUDA activity
only):

- the spans share the profiler's clock: each step's ``fused.launch`` span
  holds the profiler's own record of the group kernel's launch call (the
  runtime event of the kernel's correlation id), to 20 us, with no
  offset; and the kernel's device time fits between that span's start
  and the end of the step's ``after`` ``service.sync`` span.  The device
  interval itself is not placed against the spans: on the H100 machine
  the profiler puts its device events off its own launch events by up to
  milliseconds in some profiles, drifting within one (PERF.md §5);
- each ``fused.launch`` span records what the launcher ran: the step
  mode, the integrator, the body and its threads an instance (the RK4 arm
  on ``Generic<ArmModel<4>>``'s group body, the Euler arm on the group
  body and, at B=1, on the block body, LTV on the group body);
- the spans leak nothing into the device trace: ``portbench.core``'s
  reduction of the device's operations counts the same operations, by
  name and number, with the spans recording as with them patched out.
"""

import contextlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.runtime import BatchModelControl, batch_service
from mahi_mpc_tpu_torch.solver import fused
from mahi_mpc_tpu_torch.utils.profiling import clear_spans, spans

pytestmark = pytest.mark.gpu

B, N = 16384, 25
STEPS = 5
SLACK_NS = 20_000
# Kernels that open every traced window, ignored by what reads the trace.
# Run after run in one process the profiler loses the first device records
# of a trace, more the more traces the process has taken (PERF.md §6),
# so a window's first operations must be ones nothing counts.
LEAD_OPS = 256
LEAD_KERNEL = "spin_kernel"       # torch.cuda._sleep's


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    return torch.device("cuda", 0)


def _service(dev):
    mp = ModelParameters("spans", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-20.0] * 4,
                         u_max=[20.0] * 4, dynamics_name="mahi_arm")
    svc = BatchModelControl(mp, batch=B, device=dev,
                            Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
                            Rm=[0.01] * 4,
                            opts=SolverOptions(tol=1e-4, max_iter=30,
                                               fixed_warm_iters=3))
    g = torch.Generator(device=dev).manual_seed(0)
    svc.set_references(0.2 * torch.randn(B, N, 8, generator=g, device=dev))
    svc.set_states(0.2 * torch.randn(B, 8, generator=g, device=dev))
    svc.step()
    _steps(svc, g, 3)
    return svc, g


def _steps(svc, g, k):
    for _ in range(k):
        svc.set_states(svc.last.X[:, 1] + 0.01 * torch.randn(
            B, 8, generator=g, device=svc.device))
        svc.step().cpu()


def _traced(svc, g):
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(LEAD_OPS):
            torch.cuda._sleep(1)
        _steps(svc, g, STEPS)
        torch.cuda.synchronize()
    return prof


def test_spans_share_the_profilers_clock(cuda):
    from torch.autograd import DeviceType
    svc, g = _service(cuda)
    events = _traced(svc, g).profiler.kineto_results.events()
    launch_call = {e.correlation_id(): e for e in events
                   if e.device_type() == DeviceType.CPU
                   and e.name().startswith("cuda")}
    kernels = sorted((e for e in events if e.device_type() == DeviceType.CUDA
                      and "fused_sqp_group_kernel" in e.name()),
                     key=lambda e: e.start_ns())
    got = spans()
    launch = sorted((s for s in got if s.name == "fused.launch"),
                    key=lambda s: s.start_ns)
    after = sorted((s for s in got if s.name == "service.sync"
                    and s.attrs == {"at": "after"}), key=lambda s: s.start_ns)
    assert len(kernels) == len(launch) == len(after) == STEPS
    for k, a, b in zip(kernels, launch, after):
        assert a.step == b.step
        call = launch_call[k.correlation_id()]
        assert call.name() == "cudaLaunchKernel"
        assert call.start_ns() >= a.start_ns - SLACK_NS, \
            (call.start_ns() - a.start_ns)
        assert call.end_ns() <= a.end_ns + SLACK_NS, \
            (call.end_ns() - a.end_ns)
        assert k.end_ns() - k.start_ns() <= b.end_ns - a.start_ns + SLACK_NS


def test_spans_leak_nothing_into_the_device_trace(cuda, monkeypatch):
    from portbench.core import _device_events, device_time

    def counted(prof):
        events = list(prof.events())
        by_name = Counter(e.name for e in _device_events(events)
                          if LEAD_KERNEL not in e.name)
        tr = device_time(events, sorted(by_name))
        return by_name, {k: v[1] for k, v in tr["kernel_s"].items()}

    svc, g = _service(cuda)
    on = counted(_traced(svc, g))
    assert sum(s.name == "service.step" for s in spans()) == STEPS
    off_span = lambda *a, **kw: contextlib.nullcontext()
    monkeypatch.setattr(batch_service, "annotate", off_span)
    monkeypatch.setattr(fused, "annotate", off_span)
    off = counted(_traced(svc, g))
    assert spans() == []
    assert on == off


@pytest.mark.parametrize("is_linear, integrator, batch, want", [
    (False, "rk4", 2048, ("generic", "group", 4)),
    (False, "euler", 2048, ("fast", "group", 4)),
    (False, "euler", 1, ("fast", "block", 256)),
    (True, "euler", 2048, ("ltv", "group", 4))])
def test_launch_span_records_what_the_launcher_ran(cuda, is_linear,
                                                   integrator, batch, want):
    mp = ModelParameters("spans", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-20.0] * 4,
                         u_max=[20.0] * 4, dynamics_name="mahi_arm",
                         is_linear=is_linear, integrator=integrator)
    svc = BatchModelControl(mp, batch=batch, device=cuda,
                            opts=SolverOptions(tol=1e-4, max_iter=30,
                                               fixed_warm_iters=3))
    svc.set_states(0.1 * torch.ones(batch, 8, device=cuda))
    svc.step()
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        svc.step().cpu()
    launches = [s.attrs for s in spans() if s.name == "fused.launch"]
    mode, body, width = want
    assert launches == [dict(mode=mode, integrator=integrator, body=body,
                             width=width)]
