"""The float32 crawl of the adaptive cold solve on the fused kernel's LTV
and generic step policies, and the increment those policies form.

tests/test_torch_fused_crawl.py says what the crawl is: a defect formed as
F(x) - x' keeps the float32 rounding of x and x' (~ulp(x) a component), the
l1 merit weighs it by nu_pen, full steps are rejected near the solution,
and the solve stops at a damped answer.  Every step policy now returns the
step's increment F(x, u) - x, formed directly (Euler dt f, midpoint
dt f(x + dt/2 k1), RK4 dt/6 (k1 + 2 k2 + 2 k3 + k4), LTV (Ad - I) x + Bd u +
cd), and every defect is (x - x') + increment.

Here, on the smoke's bench-shaped draw (N=25, dt=2 ms, x0 and x_des ~
0.2 N(0, 1) from numpy seed 0, 1024 instances): LTV ``mahi_arm`` (frozen at
each instance's x0) and ``double_pendulum`` under RK4.  The float32 plain
version and the float32 one-thread body (its g++ build, the card's
arithmetic) are each held to the body's float64 answer (pinned to the
plain float64 version at 1e-8 by test_torch_fused_modes.py), with the
Euler case's band.  Measured here: LTV, plain 1 and body 0 beyond, mean
iterations +0.03 over float64's; with F(x) - x' restored in a copy 148 and
134 beyond at +2.69, and 342 and 345 at +3.1 with the older policies that
returned F.  ``double_pendulum`` under RK4 ends at the float64 answer in
either form (0 beyond, +0.00): that case holds the repaired generic path
to the band without showing the crawl.  On RK4 the crawl shows on
``mahi_arm``, in the iterations more than in the answers: with F(x) - x'
restored in a copy the body took +0.42 mean iterations over float64's (1
beyond; +0.53 with the older policies that returned F), the increment
form +0.00 (0 beyond).  Its case runs the body alone (the plain
version's eager RK4 Jacobians of the arm take minutes at this batch) and
holds it to a band of 0.2 iterations."""

import ctypes

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch._build import cpu_library
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.integrators import make_increment, make_step
from mahi_mpc_tpu_torch.ops.precision import strict_fp32
from mahi_mpc_tpu_torch.solver.fused import (count_fused_ops,
                                             solve_batch_fused_cpu_kernel,
                                             solve_batch_fused_plain)
from mahi_mpc_tpu_torch.solver.target import INTEGRATORS, model_kernel
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 1024, 25
DU_BAND = 5e-3         # chip_smoke.py's band on |dU| against float64
MAX_BEYOND = 2         # of 1024, test_torch_fused_crawl.py's band
MAX_EXTRA_ITERS = 0.6  # mean iterations over float64's, the same band
OPTS = SolverOptions(tol=1e-4, max_iter=30)
CASES = [("mahi_arm", "euler", True), ("double_pendulum", "rk4", False)]
RK4_ARM = ("mahi_arm", "rk4", False)
RK4_ARM_MAX_EXTRA_ITERS = 0.2   # F(x) - x' took +0.42 here, this +0.00
# The body the card runs for each case and its threads an instance
# (csrc/fused_sqp_group.cuh `GroupBody`; tests/test_torch_fused_modes.py
# CARD_BODY has every mode).
CARD_BODY = {CASES[0]: ("group", 4), CASES[1]: ("group", 2),
             RK4_ARM: ("group", 4)}
_ids = lambda c: f"{c[0]}-{c[1]}" + ("-ltv" if c[2] else "")


def _draw(name, integrator, ltv, dtype):
    """chip_smoke.py's ``model_batch`` at B=1024: |u| <= 20 on
    ``mahi_arm``, 60 otherwise, Q = [10]*nq + [1]*nq, R = 0.1, Rm = 0.01.
    The LTV linearization is taken in float32 and cast, so both precisions
    solve the same problem."""
    dyn = make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    ulim = 20.0 if name == "mahi_arm" else 60.0
    mp = ModelParameters("crawl", num_x=nx, num_u=nu, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-ulim] * nu,
                         u_max=[ulim] * nu, dynamics_name=name,
                         integrator=integrator, is_linear=ltv)
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32).to(dtype)
    p = default_params(mp, dtype=dtype, device="cpu")._replace(
        q=t([10.0] * nq + [1.0] * nq), r=t([0.1] * nu), rm=t([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=t(0.2 * rng.standard_normal((B, nx))),
                   x_des=t(0.2 * rng.standard_normal((B, N, nx))))
    if ltv:
        with strict_fp32():
            lin = vmap(dyn.linearize)(p.x0.float(), p.u_prev.float())
        A, Bm, xd0 = [a.to(dtype) for a in lin]
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return make_problem(mp, dyn), p


def _cold(case, solve, dtype, **kw):
    prob, p = _draw(*case, dtype)
    return solve(prob, p, None, None, OPTS, mu0=OPTS.mu_init, adaptive=True,
                 **kw)


@pytest.fixture(scope="module")
def answers():
    return {c: _cold(c, solve_batch_fused_cpu_kernel, torch.float64)
            for c in CASES}


@pytest.mark.parametrize("case, solver", [
    pytest.param(c, s, id=f"{_ids(c)}-{s}")
    for c in CASES for s in ("plain", "thread")
] + [pytest.param(CASES[0], "group", id=f"{_ids(CASES[0])}-group")])
def test_adaptive_cold_float32_ends_at_the_float64_answer(answers, case,
                                                          solver):
    """At most 2 of 1024 converged instances beyond |dU| 5e-3 of float64,
    and mean iterations within 0.6 of float64's: the plain version, the
    one-thread body, and on LTV the group body the card runs."""
    answer = answers[case]
    r = (_cold(case, solve_batch_fused_plain, torch.float32)
         if solver == "plain"
         else _cold(case, solve_batch_fused_cpu_kernel, torch.float32,
                    body=solver))
    both = (r.status == 0) & (answer.status == 0)
    assert float(both.float().mean()) >= 0.99
    du = (r.U.double() - answer.U).abs().amax(dim=(1, 2))[both]
    beyond = int((du > DU_BAND).sum())
    extra = float(r.iters.double().mean() - answer.iters.double().mean())
    assert beyond <= MAX_BEYOND, (beyond, extra)
    assert extra <= MAX_EXTRA_ITERS, (beyond, extra)


def test_rk4_arm_float32_body_iterates_as_float64():
    """RK4 ``mahi_arm``, the one-thread body's g++ build: float32 against
    float64 on the same draw.  At most 2 of 1024 converged instances beyond
    |dU| 5e-3 of float64, and mean iterations within 0.2 of float64's."""
    answer = _cold(RK4_ARM, solve_batch_fused_cpu_kernel, torch.float64)
    r = _cold(RK4_ARM, solve_batch_fused_cpu_kernel, torch.float32)
    both = (r.status == 0) & (answer.status == 0)
    assert float(both.float().mean()) >= 0.99
    du = (r.U.double() - answer.U).abs().amax(dim=(1, 2))[both]
    beyond = int((du > DU_BAND).sum())
    extra = float(r.iters.double().mean() - answer.iters.double().mean())
    assert beyond <= MAX_BEYOND, (beyond, extra)
    assert extra <= RK4_ARM_MAX_EXTRA_ITERS, (beyond, extra)


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", ["mahi_arm", "two_link_arm", "pendulum",
                                  "cartpole", "double_pendulum", "acrobot"])
def test_kernel_increment_rows_match_torch(name, integrator):
    """The generic policy's increment F(x, u) - x and its stored rows
    [A - I | B] (``csrc/model_dynamics.cuh`` ``increment_rows``, g++,
    float64) against ``make_increment`` and ``torch.func.jacfwd`` of it,
    and against ``make_step(f) - x``, at 1e-9.  In float32, at the same
    float32 points, the kernel's increment and rows are within 1e-5 of the
    float64 ones, relative to their largest entry: the increment is formed
    without cancelling against x."""
    dyn = make_dynamics(name)
    nx, nu = dyn.nx, dyn.nu
    M, dt = 16, 0.01
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((nx, M)))
    u = torch.tensor(rng.standard_normal((nu, M)))
    model, consts, _ = model_kernel(dyn)
    consts_c = (ctypes.c_double * len(consts))(*consts)
    integ = INTEGRATORS.index(integrator)

    def kernel(xs, us):
        dtype = xs.dtype
        val = torch.empty(nx, M, dtype=dtype)
        rows = torch.empty(nx, nx + nu, M, dtype=dtype)
        bits = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(cpu_library(), f"mpc_model_increment_cpu_{bits}")
        assert fn(M, model, integ, xs.data_ptr(), us.data_ptr(), dt,
                  consts_c, val.data_ptr(), rows.data_ptr()) == 0
        return val, rows

    val, rows = kernel(x, u)
    inc = make_increment(dyn.f, dt, integrator)
    step = make_step(dyn.f, dt, integrator)
    Z = torch.cat([x, u]).T
    one = lambda z: inc(z[:nx, None], z[nx:, None])[:, 0]
    np.testing.assert_allclose(val.numpy(), inc(x, u).numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(val.numpy(), (step(x, u) - x).numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(rows.permute(2, 0, 1).numpy(),
                               vmap(jacfwd(one))(Z).numpy(), rtol=0,
                               atol=1e-9)
    x32, u32 = x.float(), u.float()
    val32, rows32 = kernel(x32, u32)
    val64, rows64 = kernel(x32.double(), u32.double())
    rel = lambda a, b: float((a.double() - b).abs().amax() / b.abs().amax())
    assert rel(val32, val64) <= 1e-5
    assert rel(rows32, rows64) <= 1e-5


@pytest.mark.parametrize("case", CASES + [RK4_ARM], ids=_ids)
def test_thread_body_operation_count(case):
    """``count_fused_ops(body="thread")`` counts the one-thread body of the
    generic and LTV policies (``csrc/flop_count.cpp``) and the function's
    minimum, the numerator of their bounds in chip_smoke.py: every kind but
    the transcendentals of an LTV solve is positive, fixed mode's three
    iterations count three times one (rtol 1e-3, the barrier's
    data-dependent terms), and no kind of the minimum exceeds the body's.
    The LTV body repeats only the adds of A's identity block, nx^2 - nx a
    stage, exactly; the generic body also forms the RK4 increment's value
    in each of its nz dual passes, so its minimum is lower in every kind.
    Under RK4 a stage's linearization takes nz dual passes of four stage
    evaluations each, so the generic body does more than the same model's
    nq-row Euler body.  The group body (``count_fused_ops(body="group")``:
    four lanes for LTV ``mahi_arm`` and ``mahi_arm`` under RK4, two for
    ``double_pendulum``) tallies exactly W - 1 more Cholesky factorizations
    of Quu a stage (nu square roots and nu reciprocals each) than the
    one-thread body, and its tally is at or above the minimum in every
    kind."""
    name, integrator, ltv = case
    prob, p = _draw(name, integrator, ltv, torch.float32)
    n_b = 4
    p = MPCParams(*[type(f)(*[a[:n_b] for a in f]) if isinstance(f, tuple)
                    else (None if f is None else f[:n_b]) for f in p])
    count = lambda prob, n: count_fused_ops(prob, p, opts=OPTS, mu0=1e-5,
                                            n_iter=n, body="thread")
    one, three = count(prob, 1), count(prob, 3)
    total = lambda c, part="body": sum(c[part].values())
    np.testing.assert_allclose(total(three), 3 * total(one), rtol=1e-3)
    np.testing.assert_allclose(total(three, "minimum"),
                               3 * total(one, "minimum"), rtol=1e-3)
    assert min(v for k, v in one["body"].items()
               if k != "transcendental") > 0
    body, least = one["body"], one["minimum"]
    assert all(0 <= least[k] <= body[k] for k in body)
    if ltv:
        nx = prob.nx
        assert body["add"] - least["add"] == (nx * nx - nx) * N * n_b
        assert all(body[k] == least[k] for k in body if k != "add")
    else:
        assert all(least[k] < body[k] for k in body)
    if integrator == "rk4":
        euler, _ = _draw(name, "euler", False, torch.float32)
        assert total(one) > total(count(euler, 1))
    width = 4 if name == "mahi_arm" else 2
    assert one["card_body"] == CARD_BODY[case]
    group = count_fused_ops(prob, p, opts=OPTS, mu0=1e-5, n_iter=1,
                            body="group")
    assert (group["body"]["div_sqrt"] - body["div_sqrt"]
            == (width - 1) * 2 * prob.nu * N * n_b)
    assert all(group["body"][k] >= least[k] for k in body)
