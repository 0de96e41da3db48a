"""The plain float64 reference against the port's plain versions at B <= 4,
N = 25: the arm's dynamics and Jacobians, the frozen linearization's
discrete step, the fused solve in fixed and adaptive mode, the service's
rule for a failed instance."""

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.runtime import BatchModelControl
from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused
from mahi_mpc_tpu_torch.solver.linearize import (linearize_batch_plain,
                                                 ltv_discrete_plain)
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)
from portbench.core import Cell
from portbench.reference.arm import Arm
from portbench.reference.service import service_step, step_module
from portbench.reference.steps.arm_ltv_euler import LtvStep
from portbench.reference.sqp import Params, failed_rule, solve

F64 = torch.float64
CFG = Cell("arm.b16k.fixed3").config
LTV = Cell("arm_ltv.b64k.fixed3").config


def draws(B=4, seed=0):
    g = np.random.default_rng(seed)
    t = lambda *s, sd=0.2: torch.as_tensor(sd * g.standard_normal(s),
                                           dtype=F64)
    return t(B, 8), t(B, 4, sd=1.0), t(B, 25, 8)


def test_arm_dynamics_and_jacobians():
    x, u, _ = draws()
    dyn = make_dynamics("mahi_arm")
    arm = Arm(CFG["chain"])
    torch.testing.assert_close(arm.f(x, u), dyn.f(x.T, u.T).T,
                               rtol=1e-12, atol=1e-12)
    fv, A, B = arm.jacobians(x, u)
    A2, B2, f2 = linearize_batch_plain(dyn, x, u)
    for a, b in ((fv, f2), (A, A2), (B, B2)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_ltv_discrete_step():
    x, u, _ = draws()
    mp = ModelParameters("m", 8, 4, 0.002, 25, is_linear=True,
                         dynamics_name="mahi_arm")
    prob = make_problem(mp, make_dynamics("mahi_arm"))
    A, B, xd = linearize_batch_plain(prob.dynamics, x, u)
    p = default_params(mp, dtype=F64, device="cpu")
    p = MPCParams(*[type(f)(*[a.expand((4,) + a.shape) for a in f])
                    if isinstance(f, tuple) else f.expand((4,) + f.shape)
                    for f in p])._replace(x0=x, u_prev=u,
                                          lin=LinPoint(A, B, xd, x, u))
    AmI, Bd, cd = ltv_discrete_plain(prob, p)
    step = LtvStep(Arm(CFG["chain"]), 0.002, x, u)
    for a, b in ((step.AmI, AmI), (step.Bd, Bd), (step.cd, cd)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def port_problem(cfg, B, x0, u_prev, x_des):
    m, w = cfg["model"], cfg["weights"]
    mp = ModelParameters("m", 8, 4, m["step_size"], 25,
                         is_linear=m["is_linear"], u_min=m["u_min"],
                         u_max=m["u_max"], dynamics_name="mahi_arm")
    prob = make_problem(mp, make_dynamics("mahi_arm"))
    t = lambda v: torch.as_tensor(v, dtype=F64)
    p = default_params(mp, dtype=F64, device="cpu")._replace(
        q=t(w["Q"]), r=t(w["R"]), rm=t(w["Rm"]))
    p = MPCParams(*[type(f)(*[a.expand((B,) + a.shape).clone() for a in f])
                    if isinstance(f, tuple) else
                    f.expand((B,) + f.shape).clone() for f in p])
    p = p._replace(x0=x0, u_prev=u_prev, x_des=x_des)
    if m["is_linear"]:
        A, Bm, xd = linearize_batch_plain(prob.dynamics, x0, u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd, x0, u_prev))
    return prob, p


def ref_params(p):
    return Params(*[getattr(p, k) for k in Params._fields])


@pytest.mark.parametrize("cfg", [CFG, LTV], ids=["arm", "ltv"])
def test_fused_solve_cold_then_warm(cfg):
    x0, u_prev, x_des = draws(seed=1)
    sv = cfg["solver"]
    opts = SolverOptions(tol=sv["tol"], max_iter=sv["max_iter"],
                         dtype="float64")
    prob, p = port_problem(cfg, 4, x0, 0 * u_prev, x_des)
    cold = solve_batch_fused(prob, p, None, None, opts, mu0=sv["mu_init"],
                             adaptive=True)
    step = step_module(cfg).make(cfg, ref_params(p), F64, "cpu")
    kw = dict(tol=sv["tol"], mu_min=sv["mu_min"], kappa=sv["kappa_mu"])
    zx, zu = torch.zeros(4, 26, 8, dtype=F64), torch.zeros(4, 25, 4, dtype=F64)
    rc = solve(step, ref_params(p), zx, zu, sv["mu_init"], sv["max_iter"],
               True, **kw)
    assert torch.equal(rc.status, cold.status.long())
    assert torch.equal(rc.iters, cold.iters.long())
    torch.testing.assert_close(rc.U, cold.U, rtol=1e-8, atol=1e-9)
    # the next step, warm, fixed-3 and adaptive, from the cold plan
    x1 = cold.X[:, 1] + 0.01
    prob, p1 = port_problem(cfg, 4, x1, cold.U[:, 0], x_des.roll(1, 1))
    for iters in (3, 0):
        kw_port = dict(n_iter=iters) if iters else dict(adaptive=True)
        w = solve_batch_fused(prob, p1, cold.X, cold.U, opts, mu0=1e-5,
                              **kw_port)
        rp1 = ref_params(p1)
        u, res = service_step(step_module(cfg).make(cfg, rp1, F64, "cpu"),
                              cfg, rp1, cold.X, cold.U, warm=True,
                              fixed_iters=iters)
        assert torch.equal(res.status, w.status.long())
        torch.testing.assert_close(u, w.U[:, 0], rtol=1e-8, atol=1e-9)
        torch.testing.assert_close(res.U, w.U, rtol=1e-8, atol=1e-9)
        torch.testing.assert_close(res.X, w.X, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("change", [dict(integrator="rk4"),
                                    dict(is_linear=True), dict(num_x=6)])
def test_reference_step_refuses_another_model(change):
    cfg = dict(CFG, model=dict(CFG["model"], **change))
    x, u, _ = draws()
    p = Params(x0=x, u_prev=u, **{k: None for k in Params._fields[2:]})
    with pytest.raises(ValueError):
        step_module(cfg).make(cfg, p, F64, "cpu")


def test_failed_instance_rule_matches_the_service(monkeypatch):
    from mahi_mpc_tpu_torch.runtime import batch_service
    from mahi_mpc_tpu_torch.solver.sqp import SolveResult
    svc = BatchModelControl(ModelParameters(
        "m", 8, 4, 0.002, 25, u_min=[-20.0] * 4, u_max=[20.0] * 4,
        dynamics_name="mahi_arm"), batch=4, device="cpu",
        opts=SolverOptions(warm_solver="fused"))
    status = torch.tensor([0, 2, 1, 0], dtype=torch.int32)
    X, U = torch.randn(4, 26, 8), torch.randn(4, 25, 4)
    U[2, 3, 1] = float("nan")
    X[3, 5, 0] = float("inf")
    z = torch.zeros(4)
    monkeypatch.setattr(batch_service, "solve_batch_fused", lambda *a, **k:
                        SolveResult(X, U, z.int(), status, z, z, z))
    u = svc.step()
    ok, u_ref, Xn, Un = failed_rule(status, X, U)
    assert ok.tolist() == [True, False, False, False]
    assert torch.equal(u, u_ref)
    assert torch.equal(svc._X, Xn) and torch.equal(svc._U, Un)
