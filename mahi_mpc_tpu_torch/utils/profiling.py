"""Profiler trace capture (port of ``mahi_mpc_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints
(``model_control_example.cpp:91,95``, ``ModelControl.cpp:108``).  This
module adds the device-level view: a ``torch.profiler`` trace around any
region, written as a Chrome trace that Perfetto (https://ui.perfetto.dev)
loads, with the card's kernels on their own rows; and named regions inside
it, which also show under Nsight as NVTX ranges.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a ``device_trace``: a
    ``torch.profiler.record_function`` range, and an NVTX range when a
    CUDA device is present."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
