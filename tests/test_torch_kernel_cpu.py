"""The fused kernel's own arithmetic on the CPU: ``csrc/fused_sqp.cuh`` (the
one-thread body) and ``csrc/fused_sqp_group.cuh`` (the group body: four
lanes for the serial arms under every integrator and for LTV at (8, 4),
two lanes for the smaller shapes), built with g++ and run against the
plain PyTorch version — the port's analogue of Pallas interpret mode.  The main path's pins (``mahi_arm``
under Euler) run both bodies (``body``), and the group body also on the
dense step policies it serves: LTV ``mahi_arm`` and ``mahi_arm`` under RK4
and midpoint.  float64 pins the math to roundoff; float32 holds the bands
of the JAX parity tests."""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch._build import cpu_library
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver.fused import (_acc_jacobian, count_fused_ops,
                                             solve_batch_fused,
                                             solve_batch_fused_cpu_kernel)
from mahi_mpc_tpu_torch.solver.target import arm_flat
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    default_params,
                                                    make_problem)

torch.set_num_threads(1)

B, N = 8, 8
TOL = 1e-4


def _problem(dtype, name="mahi_arm", x_bounded=False, seed=0,
             integrator="euler", ltv=False):
    dyn = make_dynamics(name)
    nx, nu = dyn.nx, dyn.nu
    kw = {}
    if x_bounded:
        kw = dict(x_min=[-0.3] * dyn.nq + [-30.0] * dyn.nq,
                  x_max=[0.3] * dyn.nq + [30.0] * dyn.nq)
    ulim = 20.0 if name == "mahi_arm" else 60.0
    mp = ModelParameters("t", num_x=nx, num_u=nu, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-ulim] * nu,
                         u_max=[ulim] * nu, dynamics_name=name,
                         integrator=integrator, is_linear=ltv, **kw)
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    p = default_params(mp, dtype=dtype, device="cpu")._replace(
        q=t([10.0] * dyn.nq + [1.0] * dyn.nq), r=t([0.1] * nu),
        rm=t([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    scale = 0.1 if x_bounded else 0.2
    p = p._replace(x0=t(scale * rng.standard_normal((B, nx))),
                   x_des=t(scale * rng.standard_normal((B, N, nx))))
    if ltv:                 # frozen at each instance's (x0, u_prev)
        A, Bm, xd0 = torch.func.vmap(dyn.linearize)(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return prob, p


BODIES = ["thread", "group"]
# The runs of the pins below: (body, integrator, LTV), the main path under
# both bodies, then the dense step policies under the group body.
RUNS = [("thread", "euler", False), ("group", "euler", False),
        ("group", "euler", True), ("group", "rk4", False),
        ("group", "midpoint", False)]
_run_ids = lambda r: "-".join([r[0]] + (["ltv"] if r[2] else [])
                              + ([r[1]] if r[1] != "euler" else []))


def _solve_both(prob, p, opts, body, **kw):
    return (solve_batch_fused_cpu_kernel(prob, p, opts=opts, body=body, **kw),
            solve_batch_fused(prob, p, opts=opts, **kw))


def _cold_then_warm(prob, p, opts, body):
    """Adaptive cold solve, then fixed-3 warm from the plain version's plan
    at a perturbed state, each by kernel body and plain version."""
    cold = _solve_both(prob, p, opts, body, mu0=opts.mu_init, adaptive=True)
    p2 = p._replace(x0=p.x0 + 0.01)
    X0, U0 = cold[1].X, cold[1].U
    warm = (solve_batch_fused_cpu_kernel(prob, p2, X0, U0, opts, n_iter=3,
                                         body=body),
            solve_batch_fused(prob, p2, X0, U0, opts, n_iter=3))
    return cold, warm


@pytest.fixture(scope="module")
def lib():
    return cpu_library()


@pytest.fixture(scope="module", params=RUNS, ids=_run_ids)
def f64_runs(lib, request):
    body, integrator, ltv = request.param
    prob, p = _problem(torch.float64, integrator=integrator, ltv=ltv)
    return _cold_then_warm(prob, p, SolverOptions(tol=TOL, max_iter=30),
                           body)


@pytest.fixture(scope="module", params=RUNS, ids=_run_ids)
def f32_runs(lib, request):
    body, integrator, ltv = request.param
    prob, p = _problem(torch.float32, integrator=integrator, ltv=ltv)
    return _cold_then_warm(prob, p, SolverOptions(tol=TOL, max_iter=30),
                           body)


@pytest.mark.parametrize("name", ["mahi_arm", "two_link_arm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_dynamics_and_jacobian_rows(lib, name, dtype):
    """The kernel's f (f_elem order) and its dual-number Jacobian rows
    against the tensor-form f and torch.func: float64 at 1e-9 (exact AD both
    sides), float32 at rtol/atol 1e-4 (accelerations and their
    derivatives reach ~1e2-1e3, where float32 keeps ~5 significant digits
    through the Cholesky solve)."""
    dyn = make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    M, dt = 32, 0.002
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((nx, M)), dtype=dtype)
    u = torch.tensor(rng.standard_normal((nu, M)), dtype=dtype)
    fval = torch.empty(nx, M, dtype=dtype)
    jrows = torch.empty(nq, nx + nu, M, dtype=dtype)
    arm = arm_flat(dyn)
    f64 = dtype == torch.float64
    fn = lib.mpc_arm_eval_cpu_f64 if f64 else lib.mpc_arm_eval_cpu_f32
    rc = fn(M, nq, x.data_ptr(), u.data_ptr(), dt,
            (ctypes.c_double * len(arm))(*arm), fval.data_ptr(),
            jrows.data_ptr())
    assert rc == 0
    ref_f, ref_J = _acc_jacobian(dyn, x.T, u.T)
    tol = dict(rtol=0, atol=1e-9) if f64 else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fval.T.numpy(), ref_f.numpy(), **tol)
    np.testing.assert_allclose(jrows.permute(2, 0, 1).numpy(),
                               (dt * ref_J).numpy(), **tol)


@pytest.mark.parametrize("name", ["mahi_arm", "two_link_arm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_folded_jacobian_rows(lib, name, dtype):
    """The folded linearization the group body runs (q columns by one
    tangent pass through the chain, qd columns through the RNEA alone, u
    columns by two triangular solves) against the dual-number rows
    (``acc_rows``) and against ``Dynamics.linearize``: float64 at 1e-12,
    float32 at 1e-5 against the dual-number rows in float32 (both float32
    arithmetic of the same chain, accelerations and their dt-scaled
    derivatives of order 1e0-1e1) and at the float32 band of
    ``test_kernel_dynamics_and_jacobian_rows`` against the float64
    linearization.  The one-sweep columns (``arm_q_qd_columns``: a q and
    a qd tangent through one pass of the chain, which the four-lane group
    body runs where NQ = 4) are the folded columns bit for bit, f and every
    Jacobian row."""
    dyn = make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    M, dt = 32, 0.002
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((nx, M)), dtype=dtype)
    u = torch.tensor(rng.standard_normal((nu, M)), dtype=dtype)
    arm = arm_flat(dyn)
    arm_c = (ctypes.c_double * len(arm))(*arm)
    bits = "f64" if dtype == torch.float64 else "f32"
    out = {}
    for kind in ("eval", "fold", "sweep"):
        fval = torch.empty(nx, M, dtype=dtype)
        jrows = torch.empty(nq, nx + nu, M, dtype=dtype)
        fn = getattr(lib, f"mpc_arm_{kind}_cpu_{bits}")
        assert fn(M, nq, x.data_ptr(), u.data_ptr(), dt, arm_c,
                  fval.data_ptr(), jrows.data_ptr()) == 0
        out[kind] = fval.T.numpy(), jrows.permute(2, 0, 1).numpy()
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else \
        dict(rtol=1e-5, atol=1e-5)
    for a, b in zip(out["fold"], out["eval"]):
        np.testing.assert_allclose(a, b, **tol)
    raw = lambda a: a.view(np.uint64 if a.itemsize == 8 else np.uint32)
    for a, b in zip(out["sweep"], out["fold"]):
        np.testing.assert_array_equal(raw(a), raw(b))
    # Dynamics.linearize at each point: A = d f / dx, B = d f / du (float64)
    lin = [dyn.linearize(x[:, j].double(), u[:, j].double())
           for j in range(M)]
    ref = np.stack([np.concatenate([A[nq:].numpy(), Bm[nq:].numpy()], 1)
                    for A, Bm, _ in lin])
    ref_tol = dict(rtol=0, atol=1e-12) if dtype == torch.float64 else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["fold"][1], dt * ref, **ref_tol)


@pytest.mark.parametrize("mode", ["cold_adaptive", "warm_fixed3"])
def test_kernel_matches_plain_f64(f64_runs, mode):
    """float64: X and U at 1e-8, equal statuses and iterations — the kernel
    body and the plain version are the same algorithm in the same order up
    to summation association."""
    cold, warm = f64_runs
    rk, rp = cold if mode == "cold_adaptive" else warm
    np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    np.testing.assert_array_equal(rk.iters.numpy(), rp.iters.numpy())
    assert bool((rk.status == 0).all())


def test_kernel_matches_plain_f32_fixed(f32_runs):
    """float32 fixed-3 warm: the band of the JAX fixed-mode parity (X, U at
    2e-5; kkt, feas at 1e-5; equal statuses)."""
    _, (rk, rp) = f32_runs
    np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    np.testing.assert_allclose(rk.kkt.numpy(), rp.kkt.numpy(), atol=1e-5)
    np.testing.assert_allclose(rk.feas.numpy(), rp.feas.numpy(), atol=1e-5)


def test_kernel_matches_plain_f32_adaptive(f32_runs):
    """float32 adaptive cold: the band of the JAX adaptive parity (equal
    statuses, iterations within +-1, X and U at 1e-3)."""
    (rk, rp), _ = f32_runs
    np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
    assert np.abs(rk.iters.numpy() - rp.iters.numpy()).max() <= 1
    np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), rtol=0, atol=1e-3)
    assert float(rk.kkt.max()) < TOL and float(rk.feas.max()) < TOL


BRANCHES = [pytest.param(case, body, id=f"{case}-{body}")
            for case in ("x_bounds", "head_pinning", "two_link_arm",
                         "x_bounds-ltv", "head_pinning-ltv",
                         "two_link_arm-ltv", "x_bounds-rk4",
                         "head_pinning-rk4", "two_link_arm-rk4")
            for body in BODIES]


@pytest.mark.parametrize("case, body", BRANCHES)
def test_kernel_branches_match_plain_f64(lib, case, body):
    """The kernel's other branches against the plain version, float64 at
    1e-8: active state bounds (barrier and fraction-to-boundary on x), head
    pinning (num_control_inputs_saved=2: pinned controls stay exactly at
    the warm start), and the 2-joint arm instantiation; under Euler, in LTV
    (Ltv<8, 4>; two_link_arm Ltv<4, 2>, whose group body has two lanes) and
    under RK4 (Generic<ArmModel>)."""
    opts = SolverOptions(tol=TOL, max_iter=30)
    case, _, step = case.partition("-")
    kw = dict(integrator="rk4" if step == "rk4" else "euler",
              ltv=step == "ltv")
    if case == "x_bounds":
        prob, p = _problem(torch.float64, x_bounded=True, seed=1, **kw)
    elif case == "two_link_arm":
        prob, p = _problem(torch.float64, name="two_link_arm", seed=2, **kw)
    else:
        prob, p = _problem(torch.float64, seed=3, **kw)
    cold = solve_batch_fused(prob, p, opts=opts, mu0=opts.mu_init,
                             adaptive=True)
    if case == "head_pinning":
        opts = dataclasses.replace(opts, num_control_inputs_saved=2)
    p2 = p._replace(x0=p.x0 + 0.01)
    for kw in (dict(n_iter=3), dict(adaptive=True)):
        rk = solve_batch_fused_cpu_kernel(prob, p2, cold.X, cold.U, opts,
                                          body=body, **kw)
        rp = solve_batch_fused(prob, p2, cold.X, cold.U, opts, **kw)
        np.testing.assert_allclose(rk.X.numpy(), rp.X.numpy(), atol=1e-8)
        np.testing.assert_allclose(rk.U.numpy(), rp.U.numpy(), atol=1e-8)
        np.testing.assert_array_equal(rk.status.numpy(), rp.status.numpy())
        if case == "head_pinning":
            np.testing.assert_array_equal(rk.U[:, :2].numpy(),
                                          cold.U[:, :2].numpy())
        if case == "x_bounds":
            q = rk.X[:, 1:, :prob.dynamics.nq]
            assert bool((q.abs() < 0.3).all())


# The operations of the Euler arm's group body at n_iter 1 on
# ``_problem(torch.float32)``, counted with a qd column's own pass through
# the chain (``arm_qd_column``, before ``arm_q_qd_columns``), and the
# function's minimum, which the one sweep leaves as it was.
FOLDED_BODY = dict(add=1496032, mul=1746888, div_sqrt=17664,
                   transcendental=10752)
MINIMUM = dict(add=1038176, mul=1211720, div_sqrt=13056,
               transcendental=7168)


def test_group_body_operation_count():
    """``count_fused_ops`` runs a body on a counting scalar
    (csrc/flop_count.cpp): fixed mode does the same work every iteration
    (three iterations count three times one, to within the update's few
    operations and the barrier's data-dependent terms), an adaptive
    iteration adds the deeper fan's rungs, the group body's folded
    Jacobian does less than the one-thread body's dual-number rows, the
    function's minimum (the group body's tally less what its lanes repeat:
    three more value parts and the Riccati step's shared terms, about a
    fifth of the tally) is below the tally in every kind, and the
    pendulum's two-lane group body counts the one-thread body's minimum
    (the same function) below its own tally.  Each lane's one sweep of the
    chain for its q and qd columns (``arm_q_qd_columns``) does exactly
    NQ x N x 1,700 operations an instance-iteration fewer than the body
    with a pass of its own under each qd tangent (``FOLDED_BODY``: that
    pass formed the plain chain's 732 adds, 960 multiplies and 8 sines
    and cosines again), and the function's minimum is that body's
    (``MINIMUM``).  The group body of a dense
    step (LTV ``mahi_arm``, ``mahi_arm`` under RK4) does the one-thread
    body's work and what its lanes repeat: more adds and multiplies (Prp,
    the Cholesky of Quu and the increment in each lane), exactly three more
    Cholesky factorizations of Quu a stage (nu square roots and nu
    reciprocals each) and no more transcendentals; its tally is at or
    above the function's minimum in every kind."""
    prob, p = _problem(torch.float32)
    opts = SolverOptions(tol=TOL, max_iter=30)
    one, three = (count_fused_ops(prob, p, opts=opts, mu0=1e-5, n_iter=n)
                  for n in (1, 3))
    assert set(one) == {"body", "minimum", "card_body"}
    assert one["card_body"] == ("group", 4)
    kinds = ("add", "mul", "div_sqrt", "transcendental")
    assert set(one["body"]) == set(kinds)
    assert min(one["body"].values()) > 0
    total = lambda c: sum(c.values())
    for part in ("body", "minimum"):
        np.testing.assert_allclose(total(three[part]), 3 * total(one[part]),
                                   rtol=1e-3)
    for kind, n in one["minimum"].items():
        assert 0 < n < one["body"][kind]
    assert one["minimum"] == MINIMUM
    chain = dict(add=732, mul=960, div_sqrt=0, transcendental=8)
    assert sum(chain.values()) == 1700
    assert {k: FOLDED_BODY[k] - one["body"][k] for k in kinds} == {
        k: 4 * N * chain[k] * B for k in kinds}
    assert 0.75 < total(one["minimum"]) / total(one["body"]) < 0.85
    adaptive = count_fused_ops(prob, p, opts=opts, mu0=opts.mu_init,
                               n_iter=1, adaptive=True)
    assert total(adaptive["body"]) > total(one["body"])
    assert total(adaptive["minimum"]) > total(one["minimum"])
    thread = count_fused_ops(prob, p, opts=opts, mu0=1e-5, n_iter=1,
                             body="thread")
    assert thread["minimum"] is None
    assert total(one["body"]) < total(thread["body"])
    pend, pp = _problem(torch.float32, name="pendulum")
    two, one_thread = (count_fused_ops(pend, pp, opts=opts, mu0=1e-5,
                                       n_iter=1, body=b)
                       for b in ("group", "thread"))
    assert two["minimum"] == one_thread["minimum"]
    assert total(two["body"]) > total(two["minimum"])
    for kw in (dict(ltv=True), dict(integrator="rk4")):
        prob, p = _problem(torch.float32, **kw)
        count = lambda body: count_fused_ops(prob, p, opts=opts, mu0=1e-5,
                                             n_iter=1, body=body)
        group, thread = count("group"), count("thread")
        assert group["card_body"] == thread["card_body"] == ("group", 4)
        more = {k: group["body"][k] - thread["body"][k] for k in kinds}
        assert more["add"] > 0 and more["mul"] > 0
        assert more["div_sqrt"] == 3 * 2 * prob.nu * N * B
        assert more["transcendental"] == 0
        assert all(group["body"][k] >= n > 0 for k, n in
                   group["minimum"].items() if k != "transcendental")
        assert total(group["body"]) > total(group["minimum"])


# The Euler group body's outputs from its g++ build at the commit before the
# group body took the dense step policies (2e49681), written by
# `_euler_group_runs` there; the main path's arithmetic must not move.
EULER_REFERENCE = Path(__file__).with_name("euler_group_body_2e49681.npz")
EULER_CASES = ("mahi_arm", "two_link_arm", "x_bounds", "head_pinning")
EULER_FIELDS = ("X", "U", "status", "iters", "kkt", "feas", "obj")


def _euler_group_runs() -> dict:
    """The Euler group body (g++ build) in float32 and float64 on the cases
    of ``test_kernel_branches_match_plain_f64``: an adaptive cold solve,
    then fixed-3 and adaptive warm solves at x0 + 0.01 from its own cold
    plan; {"<dtype>/<case>/<run>/<field>": array}."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        for case in EULER_CASES:
            seed = {"x_bounds": 1, "two_link_arm": 2, "head_pinning": 3}
            prob, p = _problem(dtype, name="two_link_arm" if
                               case == "two_link_arm" else "mahi_arm",
                               x_bounded=case == "x_bounds",
                               seed=seed.get(case, 0))
            opts = SolverOptions(tol=TOL, max_iter=30)
            solve = lambda *a, **kw: solve_batch_fused_cpu_kernel(
                *a, body="group", **kw)
            runs = {"cold": solve(prob, p, opts=opts, mu0=opts.mu_init,
                                  adaptive=True)}
            if case == "head_pinning":
                opts = dataclasses.replace(opts, num_control_inputs_saved=2)
            p2 = p._replace(x0=p.x0 + 0.01)
            X0, U0 = runs["cold"].X, runs["cold"].U
            runs["fixed3"] = solve(prob, p2, X0, U0, opts, n_iter=3)
            runs["adaptive"] = solve(prob, p2, X0, U0, opts, adaptive=True)
            bits = str(dtype).split(".")[-1]
            for run, r in runs.items():
                for field in EULER_FIELDS:
                    out[f"{bits}/{case}/{run}/{field}"] = \
                        getattr(r, field).numpy()
    return out


def test_euler_group_body_is_unchanged(lib):
    """The Euler group body (the main path) now shares its phases with the
    dense step policies' group bodies: its float32 and float64 outputs are
    bitwise those of the body before that (``EULER_REFERENCE``)."""
    want = dict(np.load(EULER_REFERENCE))
    got = _euler_group_runs()
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        assert a.dtype == want[key].dtype, key
        np.testing.assert_array_equal(a, want[key], err_msg=key)
