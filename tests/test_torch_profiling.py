"""The port's profiler hooks (``mahi_mpc_tpu_torch/utils/profiling.py``,
counterpart of ``mahi_mpc_tpu/utils/profiling.py``) on the CPU: a trace of
a region holds its ``annotate`` label, a falsy directory traces nothing,
and the card is the default device."""

import json

import pytest
import torch

from mahi_mpc_tpu_torch.utils import annotate, device_trace


def test_trace_holds_the_annotated_region(tmp_path):
    """One Chrome trace file in the directory, loadable as JSON, with an
    event named by the ``annotate`` label; the profiler it yields sums the
    region by name."""
    a = torch.arange(64.0).reshape(8, 8)
    with device_trace(tmp_path / "tr", device="cpu") as prof:
        with annotate("trajgen_round_0"):
            (a @ a).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "trajgen_round_0" for e in events)
    assert any(e.key == "trajgen_round_0" for e in prof.key_averages())


def test_no_directory_is_a_no_op(tmp_path):
    """``device_trace(None)`` and ``device_trace("")`` yield None, write
    nothing and need no card; ``annotate`` works outside a trace."""
    for d in (None, ""):
        with device_trace(d) as prof:
            with annotate("outside"):
                pass
        assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_default_device_is_the_card(tmp_path):
    """With a directory and no card, the default ``device="cuda"`` raises
    and writes no trace."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with device_trace(tmp_path / "tr"):
            pass
    assert not (tmp_path / "tr").exists()
