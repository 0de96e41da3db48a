"""The float32 crawl of the adaptive cold solve on the Euler path.

A stage's defect formed as F(x) - x' (x' the next node, F(x) = x + dt f)
cancels: x' is within about dt f of x, so the float32 rounding of x and x'
remains, ~ulp(x) a component, and the l1 merit weighs it by nu_pen (~400
on ``mahi_arm``).  Near convergence that noise exceeded the Armijo noise
floor: full steps were rejected, reg grew tenfold an iteration, and a damped
step passed tol away from the solution.  On ``chip_smoke.py``'s parity draw
about 1 % of the instances ended beyond |dU| 5e-3 of the float64 answer, at
~11.6 mean iterations against float64's 9.0.  The port's Euler path forms
the defect as (x - x') + dt f, the same value without the cancellation.

Here, on that draw (1024 bench-shaped ``mahi_arm`` instances from numpy
seed 0, as ``chip_smoke.py`` makes them): the float32 plain version and the
float32 group body (its g++ build, the card's arithmetic), each against the
group body in float64 (the algorithm's answer: the float64 pins of
test_torch_kernel_cpu.py hold it to the plain float64 version at 1e-8)."""

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver.fused import (solve_batch_fused_cpu_kernel,
                                             solve_batch_fused_plain)
from mahi_mpc_tpu_torch.transcribe.shooting import (MPCParams, default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 1024, 25
DU_BAND = 5e-3        # chip_smoke.py's band on |dU| against float64
MAX_BEYOND = 2        # of 1024: the F(x) - x' form left 6-14 beyond
MAX_EXTRA_ITERS = 0.6  # mean iterations over float64's: that form took ~2.6
OPTS = SolverOptions(tol=1e-4, max_iter=30)


def _draw(dtype):
    """chip_smoke.py's bench-shaped parity batch (N=25, dt=2 ms, |u| <= 20,
    Q = [10]*4 + [1]*4, R = 0.1, Rm = 0.01, x0 and x_des ~ 0.2 N(0, 1))."""
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("crawl", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-20.0] * dyn.nu,
                         u_max=[20.0] * dyn.nu, dynamics_name="mahi_arm")
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32).to(dtype)
    p = default_params(mp, dtype=dtype, device="cpu")._replace(
        q=t([10.0] * 4 + [1.0] * 4), r=t([0.1] * 4), rm=t([0.01] * 4))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=t(0.2 * rng.standard_normal((B, dyn.nx))),
                   x_des=t(0.2 * rng.standard_normal((B, N, dyn.nx))))
    return make_problem(mp, dyn), p


def _cold(solve, dtype, **kw):
    prob, p = _draw(dtype)
    return solve(prob, p, None, None, OPTS, mu0=OPTS.mu_init, adaptive=True,
                 **kw)


@pytest.fixture(scope="module")
def answer():
    return _cold(solve_batch_fused_cpu_kernel, torch.float64, body="group")


@pytest.mark.parametrize("solver", ["plain", "group"])
def test_adaptive_cold_float32_ends_at_the_float64_answer(answer, solver):
    """At most 2 of 1024 converged instances beyond |dU| 5e-3 of float64,
    and mean iterations within 0.6 of float64's; with the F(x) - x' defect
    the plain version left 6 beyond at 11.6 mean iterations here."""
    r = (_cold(solve_batch_fused_plain, torch.float32) if solver == "plain"
         else _cold(solve_batch_fused_cpu_kernel, torch.float32,
                    body="group"))
    both = (r.status == 0) & (answer.status == 0)
    assert float(both.float().mean()) >= 0.99
    du = (r.U.double() - answer.U).abs().amax(dim=(1, 2))[both]
    beyond = int((du > DU_BAND).sum())
    extra = float(r.iters.double().mean() - answer.iters.double().mean())
    assert beyond <= MAX_BEYOND, (beyond, extra)
    assert extra <= MAX_EXTRA_ITERS, (beyond, extra)
