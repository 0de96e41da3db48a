"""Shared fixtures of the benchmark's tests: a small cell on the CPU, and
the card for the tests marked ``gpu`` (decided here, never at import)."""

import time

import pytest

SMALL = dict(batch=8, check_instances=8, check_steps=2, warm_steps=1,
             trace_steps=2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def run_small(name, seed=2**31 + 11, seconds=0.5, trace=False, **kw):
    """One run of cell ``name`` at B=8 on the CPU, through the plain
    versions of the fused route."""
    from portbench.core import Cell, run
    cell = Cell(name, mix_overrides=SMALL)
    s = run(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
            solver_overrides={"warm_solver": "fused"}, **kw)
    return cell, s
