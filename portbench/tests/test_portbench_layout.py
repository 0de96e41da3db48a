"""BENCHMARK.json against the contract's shape, and every cell resolved to
its files by name."""

import json
import re
from pathlib import Path

import pytest

from portbench.check import NAMES
from portbench.core import BENCH, ROOT, Cell, load_module

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"] and B["command"][-1] == "portbench.run"
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in B[part]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = Cell(cell)
    assert c.chips == 1
    assert (BENCH / "generators" / f"{c.mix['generator']}.py").exists()
    assert set(NAMES) <= set(c.limits)
    assert (BENCH / "reference" / "steps"
            / f"{c.config['reference']}.py").exists()
    conf = next(x for x in B["configs"] if x["name"] == c.workload["config"])
    assert Path(ROOT / conf["file"]).parent == BENCH / "configs"
    assert c.config["name"] == conf["name"]
    assert c.config["reduced"] == conf["reduced"] == []
    assert c.config["source"] == conf["source"]
    moves = {m["moves"] for m in c.per_layer}
    e2e = {m["name"] for m in c.end_to_end}
    assert moves <= e2e and len(e2e) >= 2 and c.per_layer
    assert len(c.workload["why"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_reader_matches_its_entry(metric):
    entry = next(m for m in B["per_layer"] if m["name"] == metric)
    mod = load_module(BENCH / "layer_metrics" / f"{metric}.py")
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])
    assert set(entry["workloads"]) <= set(CELLS)
    layers = {m["layer"] for m in B["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_roofline_names_end_in_roofline():
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
