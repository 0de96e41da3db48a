"""Profiler trace capture and the program's spans (port of
``mahi_mpc_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints
(``model_control_example.cpp:91,95``, ``ModelControl.cpp:108``).  This
module adds the device-level view: a ``torch.profiler`` trace around any
region, written as a Chrome trace that Perfetto (https://ui.perfetto.dev)
loads, with the card's kernels on their own rows; and the program's spans
(``annotate``), named regions that the service step and the fused route's
host preparation open, recorded while a profiler collects and read back
by ``spans()``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

# One check a span: is a torch.profiler (or emit_nvtx) collecting?
_profiler_enabled = torch.autograd._profiler_enabled

SPAN_CAPACITY = 1 << 20


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device="cuda"
                 ) -> Iterator[Optional[profile]]:
    """Capture a ``torch.profiler`` trace of the region into ``trace_dir``
    as ``trace_<pid>_<ns>.json`` (a no-op yielding None when ``trace_dir``
    is falsy); yields the profiler, whose ``key_averages()`` sum the
    region by operator and kernel.  ``device="cuda"`` (the default) traces
    the card's kernels too and raises without one; ``"cpu"`` traces the
    host only.

    Usage:  ``with device_trace(args.profile): run_benchmark()``
    View:   load the ``.json`` in https://ui.perfetto.dev.
    """
    if not trace_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace(device=\"cuda\") needs a CUDA "
                               "device and none is available; pass "
                               "device=\"cpu\" to trace the host only")
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Span(NamedTuple):
    """One closed span.  ``id`` is unique in the process; ``parent`` is the
    ``id`` of the span that was innermost open on the same thread when
    this one opened (None for a root); ``step`` is the service's step
    counter (given, else the parent's); ``start_ns`` and ``end_ns`` are
    Unix-epoch nanoseconds (``time.time_ns``), the base the profiler puts
    its events on: a device event starts at the profiler's
    ``trace_start_ns`` plus its ``time_range.start`` microseconds."""
    name: str
    step: Optional[int]
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    attrs: Optional[dict]


class SpanBuffer:
    """Closed spans in the order they closed (a child before its parent),
    at most ``capacity`` of them: a span beyond that is dropped and
    counted in ``dropped``.  Kept as plain tuples (``Span``'s fields), so
    a recording span costs little; ``snapshot`` makes them ``Span``."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self.rows: list = []
        self._lock = threading.Lock()

    def add(self, row: tuple) -> None:
        # list.append is atomic; only the count of dropped spans is
        # read, changed and written
        if len(self.rows) < self.capacity:
            self.rows.append(row)
        else:
            with self._lock:
                self.dropped += 1

    def snapshot(self) -> list:
        return [Span._make(r) for r in self.rows[:self.capacity]]

    def clear(self) -> None:
        with self._lock:
            self.rows = []
            self.dropped = 0


class _Open(threading.local):
    def __init__(self):
        self.stack = []       # this thread's open spans, innermost last


_BUFFER = SpanBuffer()
_open = _Open()
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "step", "attrs", "id", "parent", "start_ns",
                 "_range")

    def __init__(self, name: str, step: Optional[int], attrs):
        self.name, self.step, self.attrs = name, step, attrs

    def __enter__(self):
        stack = _open.stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.step is None:
                self.step = top.step
        else:
            self.parent = None
        self.id = next(_ids)
        stack.append(self)
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        _BUFFER.add((self.name, self.step, self.id, self.parent,
                     self.start_ns, end_ns, self.attrs))
        return False


def annotate(name: str, step: Optional[int] = None, **attrs):
    """The program's span: a context manager around a named region.

    While a ``torch.profiler`` (or ``torch.autograd.profiler.emit_nvtx``)
    collects on this thread (a profiler collects on the thread that
    started it), the region is recorded as a ``Span`` in memory, a child of
    the span innermost open on this thread, with ``step`` (else its
    parent's) and ``attrs``; ``spans()`` returns what was recorded.  It
    is also a ``record_function`` range, so a ``device_trace`` shows and
    sums it by name, and under ``emit_nvtx`` that range is the NVTX
    range.  Otherwise it costs one check and records nothing."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, step, attrs or None)


def spans() -> list:
    """The spans recorded since the last ``clear_spans()``, in the order
    they closed."""
    return _BUFFER.snapshot()


def spans_dropped() -> int:
    """Spans dropped since the last ``clear_spans()``: closed while the
    buffer held ``SPAN_CAPACITY`` of them."""
    return _BUFFER.dropped


def clear_spans() -> None:
    """Empty the span buffer and its dropped count."""
    _BUFFER.clear()
