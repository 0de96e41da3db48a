"""The traffic generator at tiny B on the CPU, and one short run of the
harness core of every cell there (the plain versions of the fused route)."""

import json

import pytest
import torch

from portbench.core import BENCH, ROOT, load_module, result

from .conftest import SMALL, run_small

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def gen(seed, mix="fleet_b16k_fixed3"):
    m = dict(json.loads((BENCH / "traffic" / f"{mix}.json").read_text()),
             **SMALL)
    mod = load_module(BENCH / "generators" / f"{m['generator']}.py")
    return mod.make(m, 8, 25, 0.002, seed, "cpu")


def test_same_seed_same_inputs_and_large_seeds():
    a, b, c = gen(2**31 + 5), gen(2**31 + 5), gen(2**31 + 6)
    assert torch.equal(a.x0, b.x0) and not torch.equal(a.x0, c.x0)
    assert torch.equal(a.reference(7), b.reference(7))
    x = a.x0
    ok = torch.tensor([True] * 4 + [False] * 4)
    X1 = torch.ones_like(x)
    na, nb = a.next_state(x, X1, ok), b.next_state(x, X1, ok)
    assert torch.equal(na, nb)
    noise = (na - torch.where(ok[:, None], X1, x)).abs()
    assert 0 < float(noise.max()) < 0.1


def test_reference_shifts_one_dt_a_step():
    g = gen(3)
    r0, r1 = g.reference(0), g.reference(1)
    assert r0.shape == (8, 25, 8)
    torch.testing.assert_close(r1[:, :-1], r0[:, 1:], atol=1e-6, rtol=0)
    rows = torch.tensor([1, 5])
    assert torch.equal(g.reference(4, rows=rows), g.reference(4)[rows])
    assert float(g.amp.std()) > 0.05


@pytest.mark.parametrize("cell", CELLS)
def test_harness_core_one_second(cell):
    c, s = run_small(cell, seconds=1.0)
    assert s["steps"] >= 1 and s["attempted"] == 8 * s["steps"]
    assert s["failed"] == 0
    out = result(c, s, False, dict(platform="cpu", kind="cpu", count=1))
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(out)[-1] == "compared"
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_traced_run_reads_what_the_cpu_has():
    c, s = run_small("arm.b16k.adaptive", trace=True)
    out = result(c, s, True, dict(platform="cpu", kind="cpu", count=1))
    names = set(out["metrics"])
    # no device on the CPU: the device readers find nothing to read
    assert names == {"service.self_ms", "service.step_ms_p50",
                     "solver.mean_iters"}
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert s["trace"]["steps"] == SMALL["trace_steps"]
    assert len(s["trace"]["solve_s"]) == SMALL["trace_steps"]
