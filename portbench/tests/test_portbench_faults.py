"""``correct`` must come out false when the timed path is broken: the
control (the plain reference in bfloat16, one precision below the
configuration's float32, put in the program's place) and each fault a
cell can have, planted under the service at B=8 on the CPU.  The cells
run on one card each, so there is no exchange between cards to leave
out."""

import json

import pytest

from mahi_mpc_tpu_torch.runtime import batch_service
from portbench.core import ROOT, result

from .conftest import run_small

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = dict(platform="cpu", kind="cpu", count=1)


def is_correct(cell, s):
    return result(cell, s, False, CPU)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    c, s = run_small(cell, control_dtypes=("bfloat16",))
    assert is_correct(c, s)
    ctrl = s["control"]["bfloat16"]
    assert any(ctrl[k] > c.limits[k] for k in ctrl), ctrl


def broken_solve(fault, limit):
    real = batch_service.solve_batch_fused

    def solve(prob, p, X0, U0, opts, **kw):
        res = real(prob, p, X0, U0, opts, **kw)
        X, U = res.X.clone(), res.U.clone()
        half = X.shape[0] // 2
        if fault == "state_unchanged":
            X, U = X0.clone(), U0.clone()
        elif fault == "half_left_out":
            X[half:], U[half:] = X0[half:], U0[half:]
        elif fault == "answer_altered":
            U[:, 0] += 10 * limit
        elif fault == "plan_altered":
            U[:, 1:] += 10 * limit
        return res._replace(X=X, U=U)
    return solve


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "plan_altered"])
@pytest.mark.parametrize("cell", ["arm.b16k.fixed3", "arm_ltv.b64k.fixed3"])
def test_fault_is_caught(cell, fault, monkeypatch):
    from portbench.core import Cell
    limit = max(Cell(cell).limits[k] for k in ("u_gap", "plan_u_gap"))
    monkeypatch.setattr(batch_service, "solve_batch_fused",
                        broken_solve(fault, limit))
    c, s = run_small(cell)
    assert not is_correct(c, s), s["compared"]


def test_ltv_linearization_altered_is_caught(monkeypatch):
    real = batch_service.linearize_batch

    def altered(dyn, x0, u0):
        A, B, xd = real(dyn, x0, u0)
        return A * 1.01, B, xd
    monkeypatch.setattr(batch_service, "linearize_batch", altered)
    c, s = run_small("arm_ltv.b64k.fixed3")
    assert not is_correct(c, s), s["compared"]
