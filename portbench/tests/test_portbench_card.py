"""On the card (marked ``gpu``): each cell at its own size with a short
window, its numbers within their limits, and the control (the reference
in bfloat16 in the program's place) outside them.

    python -m pytest portbench/tests -m gpu -q
"""

import json
import time

import pytest

from portbench.core import ROOT, Cell, result, run

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_at_its_size(name, card):
    cell = Cell(name)
    s = run(cell, 2**31 + 99, 2.0, False, time.perf_counter(),
            control_dtypes=("bfloat16",))
    out = result(cell, s, False, dict(platform="gpu", kind="", count=1))
    assert out["correct"], out["compared"]
    ctrl = s["control"]["bfloat16"]
    assert any(ctrl[k] > cell.limits[k] for k in ctrl), ctrl
