"""The 4-DOF arm under RK4 against the benchmark's plain reference step
(``portbench/reference/steps/arm_rk4.py``) on the CPU, at N = 25:

- the step's increment against the port's ``_rk4_increment`` on the arm,
  and its Jacobians (``jacfwd`` through the four stages) against central
  finite differences, in float64;
- the service (``BatchModelControl``, ``integrator="rk4"``, B = 8) over a
  cold step and three fixed-3 warm steps, on its CPU route and on the g++
  build of the kernel's group body (the card's ``Generic<ArmModel<4>>``),
  against the reference's service step, which follows the program step by
  step as the benchmark's ``correct`` does;
- the step refuses a configuration it does not implement.
"""

import functools

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.integrators import _rk4_increment
from mahi_mpc_tpu_torch.runtime import BatchModelControl, batch_service
from mahi_mpc_tpu_torch.solver import fused
from portbench.core import Cell
from portbench.reference.service import service_step, step_module
from portbench.reference.sqp import Params

F64 = torch.float64
CFG = Cell("arm_rk4.b16k.fixed3").config
DT = CFG["model"]["step_size"]
B, N = 8, 25
# Gaps of a float32 solve from the float64 reference: the limits of the
# benchmark's RK4 cell (``portbench/limits/arm_rk4.b16k.fixed3.json``),
# whose readings on the card are 1.3e-7 to 7.0e-7 for the program and 6e-3
# to 4.6e-2 for the reference computed in bfloat16: two hundred times
# above the first and sixty or more below the second.
U_TOL, X_TOL, PLAN_U_TOL = 1e-4, 1e-4, 2e-4


def draws(M, seed):
    g = np.random.default_rng(seed)
    t = lambda sd, *s: torch.as_tensor(sd * g.standard_normal(s), dtype=F64)
    return t(0.2, M, 8), t(5.0, M, 4)


def port_increment():
    dyn = make_dynamics("mahi_arm")
    return _rk4_increment(lambda x, u: dyn.f(x.T, u.T).T, DT)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_increment_and_jacobians(seed):
    x, u = draws(4, seed)
    step = step_module(CFG).make(CFG, None, F64, "cpu")
    inc = port_increment()
    torch.testing.assert_close(step.inc(x, u), inc(x, u), rtol=1e-12,
                               atol=1e-15)
    v, A, Bm = step.linearize(x[:, None], u[:, None])
    torch.testing.assert_close(v[:, 0], inc(x, u), rtol=1e-12, atol=1e-15)
    # central differences: truncation ~h^2, rounding ~1e-16 |inc| / h, up
    # to 2e-9 where a derivative is zero
    h = 1e-6

    def fd(z, other, first):
        cols = []
        for j in range(z.shape[1]):
            e = torch.zeros_like(z)
            e[:, j] = h
            f = (lambda a: inc(a, other)) if first else \
                (lambda a: inc(other, a))
            cols.append((f(z + e) - f(z - e)) / (2 * h))
        return torch.stack(cols, -1)

    torch.testing.assert_close(A[:, 0], fd(x, u, True), rtol=1e-6,
                               atol=1e-8)
    torch.testing.assert_close(Bm[:, 0], fd(u, x, False), rtol=1e-6,
                               atol=1e-8)


def ref_params(x0, u_prev, x_des):
    m, w = CFG["model"], CFG["weights"]
    row = lambda v: torch.as_tensor(v, dtype=F64).expand(B, len(v))
    inf = float("inf")
    return Params(x0=x0.double(), u_prev=u_prev.double(),
                  x_des=x_des.double(), q=row(w["Q"]), r=row(w["R"]),
                  rm=row(w["Rm"]), qf=row([0.0] * 8), xf_des=row([0.0] * 8),
                  u_min=row(m["u_min"]), u_max=row(m["u_max"]),
                  x_min=row([-inf] * 8), x_max=row([inf] * 8))


@pytest.mark.parametrize("route", ["plain", "group"])
def test_service_against_the_reference(route, monkeypatch):
    """Cold, then three warm fixed-3 steps: each step's control and kept
    plan against the reference's service step from what the program was
    handed (the measured state, the previous control, the reference and
    the program's own kept plan as the warm start)."""
    if route == "group":
        monkeypatch.setattr(batch_service, "solve_batch_fused",
                            functools.partial(
                                fused.solve_batch_fused_cpu_kernel,
                                body="group"))
    m, w, sv = CFG["model"], CFG["weights"], CFG["solver"]
    mp = ModelParameters("rk4", num_x=8, num_u=4, step_size=DT,
                         num_shooting_nodes=N, u_min=m["u_min"],
                         u_max=m["u_max"], dynamics_name="mahi_arm",
                         integrator=m["integrator"])
    svc = BatchModelControl(mp, batch=B, device="cpu", Q=w["Q"], R=w["R"],
                            Rm=w["Rm"], opts=SolverOptions(
                                tol=sv["tol"], max_iter=sv["max_iter"],
                                warm_solver="fused", fixed_warm_iters=3))
    g = torch.Generator().manual_seed(5)
    amp = 0.2 * torch.randn(B, 1, 8, generator=g)
    ref = lambda k: amp * torch.sin(2 * np.pi * DT * (
        k + torch.arange(1, N + 1))[None, :, None])
    x, u = 0.2 * torch.randn(B, 8, generator=g), torch.zeros(B, 4)
    X, U = torch.zeros(B, N + 1, 8, dtype=F64), torch.zeros(B, N, 4,
                                                           dtype=F64)
    step_of = step_module(CFG)
    for k in range(4):
        svc.set_states(x, u_prev=u if k else None)
        svc.set_references(ref(k))
        u_prog = svc.step()
        p = ref_params(x, u, ref(k))
        u_ref, res = service_step(step_of.make(CFG, p, F64, "cpu"), CFG, p,
                                  X, U, warm=k > 0, fixed_iters=3)
        assert bool((res.status == 0).all())
        assert (svc.last.status == 0).all()
        assert (u_prog.double() - u_ref).abs().max() < U_TOL, k
        assert (svc._X.double() - res.X).abs().max() < X_TOL, k
        assert (svc._U.double() - res.U).abs().max() < PLAN_U_TOL, k
        X, U = svc._X.double(), svc._U.double()
        x = svc.last.X[:, 1] + 0.01 * torch.randn(B, 8, generator=g)
        u = u_prog


@pytest.mark.parametrize("change", [dict(integrator="euler"),
                                    dict(is_linear=True), dict(num_x=6)],
                         ids=["euler", "linear", "chain"])
def test_step_refuses_another_model(change):
    cfg = dict(CFG, model=dict(CFG["model"], **change))
    with pytest.raises(ValueError):
        step_module(cfg).make(cfg, None, F64, "cpu")
