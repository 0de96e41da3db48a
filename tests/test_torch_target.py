"""The instantiation decision (``solver/target.py``), made once a problem
and once a model and kept: two solves of one problem form the model's
constants, or emit its generated unit, once.

Each case runs the kernel bodies' g++ builds twice on one problem: the
4-DOF arm under Euler (``solve_batch_fused_cpu_kernel``), the arm in LTV
(``linearize_batch_cpu_kernel`` and the LTV solve), a user's model through
its generated instantiation, and the generated LTV (12, 6) of a user's
chain (its linearization and its solve, from one generated unit).  The
arm's constants are counted at ``models.arm.arm_constants``, a generated
unit at its emission (``target._unit``).
"""

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import arm, make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.solver import target
from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused_cpu_kernel
from mahi_mpc_tpu_torch.solver.linearize import linearize_batch_cpu_kernel
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 2, 4


def _vdp(x, u):
    return torch.stack([x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]])


def _chain(nq, nu):
    """A chain of nq pendulums coupled by springs, its first nu joints
    actuated."""
    def f(x, u):
        q, qd = x[:nq], x[nq:]
        act = torch.cat([u, torch.zeros_like(q[:nq - nu])])
        left, right = torch.cat([q[:1], q[:-1]]), torch.cat([q[1:], q[-1:]])
        return torch.cat([qd, act - torch.sin(q) - 0.1 * qd
                          + 0.5 * ((left - 2.0 * q) + right)])
    return f


CASES = {
    # case: (the model, integrator, LTV, what is counted)
    "arm_euler": (lambda: make_dynamics("mahi_arm"), "euler", False, "arm"),
    "arm_ltv": (lambda: make_dynamics("mahi_arm"), "euler", True, "arm"),
    "user_vdp": (lambda: Dynamics("vdp", 2, 1, lambda x, u: _vdp(x, u),
                                  supports_lanes=True), "rk4", False, "unit"),
    "ltv_12x6": (lambda: Dynamics("chain_12x6", 12, 6, _chain(6, 6),
                                  supports_lanes=True),
                 "euler", True, "unit"),
}


def _params(mp, dyn):
    """B instances of float64 inputs from numpy seed 0."""
    nx, nu = dyn.nx, dyn.nu
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    p = default_params(mp, dtype=torch.float64, device="cpu")._replace(
        q=t([10.0] * nx), r=t([0.1] * nu), rm=t([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    return p._replace(x0=t(0.2 * rng.standard_normal((B, nx))),
                      x_des=t(0.2 * rng.standard_normal((B, N, nx))))


@pytest.mark.parametrize("case", list(CASES))
def test_decision_is_made_once_a_problem(case, monkeypatch):
    """Two solves of one fresh problem (in LTV each after its
    relinearization by the linearization kernel) form the arm's constants
    once, or emit the generated unit once; both solves agree bit for
    bit."""
    make, integrator, is_linear, counted = CASES[case]
    calls = []
    if counted == "arm":
        real = arm.arm_constants
        monkeypatch.setattr(arm, "arm_constants",
                            lambda dyn: calls.append(dyn) or real(dyn))
    else:
        real = target._unit
        monkeypatch.setattr(target, "_unit",
                            lambda *a: calls.append(a) or real(*a))
    dyn = make()
    mp = ModelParameters("t", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
                         num_shooting_nodes=N, u_min=[-20.0] * dyn.nu,
                         u_max=[20.0] * dyn.nu, integrator=integrator,
                         is_linear=is_linear)
    prob = make_problem(mp, dyn)
    p = _params(mp, dyn)
    runs = []
    for _ in range(2):
        if is_linear:
            A, Bm, xd0 = linearize_batch_cpu_kernel(dyn, p.x0, p.u_prev)
            p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
        runs.append(solve_batch_fused_cpu_kernel(
            prob, p, opts=SolverOptions(tol=1e-4, max_iter=10), n_iter=2))
    assert len(calls) == 1, calls
    assert (target.kernel_target(prob).unit is not None) == (counted ==
                                                             "unit")
    for field in ("X", "U", "status"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field))
