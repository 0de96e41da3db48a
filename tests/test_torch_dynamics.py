"""The PyTorch port's serial-arm dynamics and parameter schema against the
JAX package: the same numpy inputs through both, compared at stated
tolerances."""

import json
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import arm_constants, make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.solver.fused import _acc_jacobian, fused_supported
from mahi_mpc_tpu_torch.solver.select import resolve_warm_solver
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

MODELS = ["mahi_arm", "two_link_arm"]


def _states(name, n=64, seed=0):
    dyn = make_dynamics(name)
    rng = np.random.default_rng(seed)
    return (dyn, jax_make_dynamics(name),
            rng.standard_normal((dyn.nx, n)), rng.standard_normal((dyn.nu, n)))


@pytest.mark.parametrize("name", MODELS)
def test_f_matches_jax_f64(name):
    """Trailing-batch f at 64 random states, float64: the two packages run
    the same formulas in the same order up to summation association, so
    they agree to roundoff (atol 1e-10 on accelerations of order 1e2)."""
    dyn, jdyn, x, u = _states(name)
    ref = np.asarray(jdyn.f(jnp.asarray(x), jnp.asarray(u)))
    got = dyn.f(torch.tensor(x), torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", MODELS)
def test_f_matches_jax_f32(name):
    """Same in float32: rtol 1e-5 / atol 1e-5 allows a few ulps of the
    float32 Cholesky solve on each side."""
    dyn, jdyn, x, u = _states(name, seed=1)
    ref = np.asarray(jdyn.f(jnp.asarray(x, jnp.float32),
                            jnp.asarray(u, jnp.float32)))
    got = dyn.f(torch.tensor(x, dtype=torch.float32),
                torch.tensor(u, dtype=torch.float32)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_jacobian_rows_match_jax_jacfwd(name):
    """The solver's acceleration Jacobian rows (forward-mode jvp over the
    trailing-batch f) and Dynamics.linearize against jax.jacfwd of f, in
    float64 (atol 1e-9: both are exact AD, differing only by roundoff)."""
    dyn, jdyn, x, u = _states(name, n=16, seed=2)
    nq = dyn.nq
    Jx, Ju = jax.vmap(jax.jacfwd(jdyn.f, argnums=(0, 1)))(
        jnp.asarray(x.T), jnp.asarray(u.T))
    ref = np.concatenate([np.asarray(Jx), np.asarray(Ju)], axis=2)[:, nq:]
    fval, J = _acc_jacobian(dyn, torch.tensor(x.T), torch.tensor(u.T))
    np.testing.assert_allclose(J.numpy(), ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        fval.numpy(), np.asarray(jdyn.f(jnp.asarray(x), jnp.asarray(u))).T,
        rtol=0, atol=1e-10)
    A, B, xd = dyn.linearize(torch.tensor(x[:, 0]), torch.tensor(u[:, 0]))
    np.testing.assert_allclose(A.numpy(), np.asarray(Jx[0]), atol=1e-9)
    np.testing.assert_allclose(B.numpy(), np.asarray(Ju[0]), atol=1e-9)


def test_jacobian_rows_stay_float32():
    """Forward-mode AD promotes a 0-d float32 tangent times a python float
    to float64; the solver's Jacobian keeps the batch inside f so the rows
    stay float32."""
    dyn = make_dynamics("mahi_arm")
    fval, J = _acc_jacobian(dyn, torch.zeros(3, 8), torch.zeros(3, 4))
    A, B, _ = dyn.linearize(torch.zeros(8), torch.zeros(4))
    assert {t.dtype for t in (fval, J, A, B)} == {torch.float32}


@pytest.mark.parametrize("name", MODELS)
def test_mass_matrix_and_bias_match_jax(name):
    """The internals the kernel's dynamics mirror (mass matrix, RNEA bias)
    against the JAX package's, float64, atol 1e-12."""
    dyn, jdyn, x, _ = _states(name, n=8, seed=3)
    n = dyn.nq
    q, qd = x[:n], x[n:]
    np.testing.assert_allclose(
        dyn.mass_matrix(torch.tensor(q)).numpy(),
        np.asarray(jdyn.mass_matrix(jnp.asarray(q))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        dyn.bias(torch.tensor(q), torch.tensor(qd)).numpy(),
        np.asarray(jdyn.bias(jnp.asarray(q), jnp.asarray(qd))),
        rtol=0, atol=1e-12)


def test_arm_constants_are_plain_floats():
    c = arm_constants(make_dynamics("mahi_arm"))
    assert len(c["axes"]) == 4 and c["axes"][3] == [0.0, -1.0, 0.0]
    assert c["neg_g"] == [0.0, 0.0, 9.81] and c["damping"] == 0.05
    assert all(isinstance(v, float) for row in c["inertias"] for v in row)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_model_parameters_json_both_ways(tmp_path, direction):
    """JSON written by either package loads in the other, inf sentinels
    included, and builds the same problem."""
    kw = dict(name="arm_cfg", num_x=8, num_u=4, step_size=0.002,
              num_shooting_nodes=25, u_min=[-20.0] * 4, u_max=[20.0] * 4,
              dynamics_name="mahi_arm")
    writer, reader = ((JaxModelParameters, ModelParameters)
                      if direction == "jax_to_torch"
                      else (ModelParameters, JaxModelParameters))
    path = writer(**kw).save(tmp_path)
    assert json.loads(path.read_text())["model"]["x_min"] == [-10e30] * 8
    got = reader.load("arm_cfg", tmp_path)
    assert got.to_json_dict() == writer(**kw).to_json_dict()
    assert all(math.isinf(v) for v in got.x_max)
    prob = make_problem(ModelParameters.load("arm_cfg", tmp_path),
                        make_dynamics("mahi_arm"))
    assert (prob.N, prob.dt, prob.integrator) == (25, 0.002, "euler")


def test_warm_solver_resolution():
    """'auto' picks the fused kernel on a CUDA device only; 'fused' is
    honoured on any device; unsupported problems fall back; RK4 is fused
    (the generic nx-row path)."""
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("t", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=8, dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    assert fused_supported(prob)
    auto = SolverOptions()
    assert resolve_warm_solver(auto, prob, "cuda") == "fused"
    assert resolve_warm_solver(auto, prob, "cpu") == "adaptive"
    assert resolve_warm_solver(SolverOptions(fixed_warm_iters=3), prob,
                               "cpu") == "fixed"
    assert resolve_warm_solver(SolverOptions(warm_solver="fused"), prob,
                               "cpu") == "fused"
    rk4 = make_problem(ModelParameters(
        "t", num_x=8, num_u=4, step_size=0.002, num_shooting_nodes=8,
        integrator="rk4"), dyn)
    assert fused_supported(rk4)
    assert resolve_warm_solver(auto, rk4, "cuda") == "fused"
    assert resolve_warm_solver(auto, rk4, "cpu") == "adaptive"
    with pytest.raises(ValueError):
        resolve_warm_solver(SolverOptions(warm_solver="bogus"), prob)


def _mp(name, **kw):
    dyn = make_dynamics(name)
    return ModelParameters("t", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
                           num_shooting_nodes=25, dynamics_name=name, **kw)


@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("name", ["mahi_arm", "two_link_arm", "pendulum",
                                  "cartpole", "double_pendulum", "acrobot"])
def test_auto_resolves_to_fused_on_cuda(name, integrator):
    """tests/test_fused_adaptive.py:174-196 with device "cuda" for backend
    "tpu": defaults on the card resolve to the fused kernel for every
    registered model under every integrator, in both flavours (LTV
    included); off the card "auto" keeps the lanes route."""
    for ltv in (False, True):
        prob = make_problem(_mp(name, integrator=integrator, is_linear=ltv),
                            make_dynamics(name))
        assert fused_supported(prob)
        assert resolve_warm_solver(SolverOptions(), prob, "cuda") == "fused"
        assert resolve_warm_solver(SolverOptions(), prob, "cpu") == \
            "adaptive"
        assert resolve_warm_solver(SolverOptions(fixed_warm_iters=3), prob,
                                   "cpu") == "fixed"
        assert resolve_warm_solver(SolverOptions(warm_solver="fused"), prob,
                                   "cpu") == "fused"


def _unfusable_cases():
    """Three problems the kernel once could not serve: dynamics without
    lanes support, lanes dynamics the kernel has no hand-written CUDA form
    of, and an LTV (nx, nu) outside the hand-written instantiations."""
    mp = ModelParameters("t", num_x=2, num_u=1, step_size=0.01,
                         num_shooting_nodes=10)
    no_lanes = Dynamics("no_lanes", nx=2, nu=1,
                        f=lambda x, u: torch.stack([x[1], u[0]]),
                        supports_lanes=False)
    unknown = Dynamics("custom", nx=2, nu=1,
                       f=lambda x, u: torch.stack([x[1], u[0]]),
                       supports_lanes=True, nq=1)
    wide = Dynamics("wide", nx=6, nu=3, f=lambda x, u: x,
                    supports_lanes=True)
    return {"no_lanes": make_problem(mp, no_lanes),
            "unknown": make_problem(mp, unknown),
            "wide": make_problem(ModelParameters(
                "t", num_x=6, num_u=3, step_size=0.01,
                num_shooting_nodes=10, is_linear=True), wide)}


@pytest.mark.parametrize("case", ["no_lanes", "unknown", "wide"])
def test_resolution_falls_back_for_unfusable(case):
    """tests/test_fused_adaptive.py:199-216: an explicit 'fused' for a
    problem the kernel cannot serve falls back, on the card and off it;
    that is dynamics without lanes support.  Lanes dynamics the kernel has
    no hand-written form of (``unknown``) and an LTV shape outside the
    hand-written four (``wide``) are served, as JAX's rule serves them
    (``fused.py:173-179``), by instantiations generated at first use: they
    resolve to the fused kernel on the card."""
    prob = _unfusable_cases()[case]
    if case == "no_lanes":
        assert not fused_supported(prob)
        for device in ("cuda", "cpu"):
            assert resolve_warm_solver(SolverOptions(), prob, device) == \
                "adaptive"
            assert resolve_warm_solver(SolverOptions(warm_solver="fused"),
                                       prob, device) == "adaptive"
            assert resolve_warm_solver(
                SolverOptions(warm_solver="fused", fixed_warm_iters=3), prob,
                device) == "fixed"
        return
    assert fused_supported(prob)
    assert resolve_warm_solver(SolverOptions(), prob, "cuda") == "fused"
    assert resolve_warm_solver(SolverOptions(), prob, "cpu") == "adaptive"
    for device in ("cuda", "cpu"):
        assert resolve_warm_solver(SolverOptions(warm_solver="fused"), prob,
                                   device) == "fused"


def test_import_leaves_jax_out():
    """The port imports neither jax nor mahi_mpc_tpu (checked in a fresh
    interpreter, since this test process has both)."""
    code = ("import sys, mahi_mpc_tpu_torch, mahi_mpc_tpu_torch.runtime, "
            "mahi_mpc_tpu_torch.solver, mahi_mpc_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mahi_mpc_tpu.')) or m == 'mahi_mpc_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
