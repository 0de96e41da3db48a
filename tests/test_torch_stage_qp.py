"""The port's batch-leading stage-QP build and barrier helpers against the
JAX package's single-instance functions (vmapped), float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver import stage_qp as jsq
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver.stage_qp import (barrier_value,
                                                build_stage_qp,
                                                fraction_to_boundary)
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

B, N = 4, 6
INF = np.inf
CASES = {
    "unbounded": dict(),
    "u_bounded": dict(u_min=[-3.0, -3.0], u_max=[3.0, 3.0]),
    "x_bounded": dict(x_min=[-INF, -INF, -1.5, -1.5],
                      x_max=[INF, INF, 1.5, 1.5]),
    "pinned": dict(u_min=[-3.0, -3.0], u_max=[3.0, 3.0]),
}


def _inputs(case, seed=0):
    kw = dict(num_x=4, num_u=2, step_size=0.01, num_shooting_nodes=N,
              dynamics_name="double_pendulum", **CASES[case])
    jmp = JaxModelParameters("q", **kw)
    jprob = jax_make_problem(jmp, jax_make_dynamics("double_pendulum"))
    prob = make_problem(ModelParameters("q", **kw),
                        make_dynamics("double_pendulum"))
    rng = np.random.default_rng(seed)
    f64 = jnp.float64
    p = jax_default_params(jmp, dtype=f64)
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    p = p._replace(
        q=jnp.asarray(rng.uniform(1, 10, (B, 4)), f64),
        r=jnp.asarray(rng.uniform(0.1, 1, (B, 2)), f64),
        rm=jnp.asarray(rng.uniform(0.0, 0.1, (B, 2)), f64),
        qf=jnp.asarray(rng.uniform(0.0, 5, (B, 4)), f64),
        x_des=jnp.asarray(rng.standard_normal((B, N, 4)), f64),
        xf_des=jnp.asarray(rng.standard_normal((B, 4)), f64),
        u_prev=jnp.asarray(rng.standard_normal((B, 2)), f64))
    arrays = dict(
        X=rng.uniform(-1, 1, (B, N + 1, 4)), U=rng.uniform(-2, 2, (B, N, 2)),
        mu=rng.uniform(1e-3, 1e-1, B), reg=rng.uniform(1e-8, 1e-3, B),
        A=rng.standard_normal((B, N, 4, 4)), Bm=rng.standard_normal((B, N, 4, 2)),
        c=rng.standard_normal((B, N, 4)))
    return jprob, prob, p, arrays


@pytest.mark.parametrize("case", list(CASES))
def test_build_stage_qp_matches_jax(case):
    """The whole batch at once against jax.vmap(build_stage_qp) with the
    same stage linearization: every field at float64 1e-12."""
    jprob, prob, p, a = _inputs(case)
    n_pin = 2 if case == "pinned" else 0
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref = jax.vmap(lambda X, U, pp, mu, reg, A, Bm, c: jsq.build_stage_qp(
        jprob, X, U, pp, mu, reg, lin=(A, Bm, c), n_pin=n_pin))(
        j["X"], j["U"], p, j["mu"], j["reg"], j["A"], j["Bm"], j["c"])
    t = {k: torch.tensor(v) for k, v in a.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, p), dtype=torch.float64,
                           device="cpu")
    got = build_stage_qp(prob, t["X"], t["U"], tp, t["mu"], t["reg"],
                         lin=(t["A"], t["Bm"], t["c"]), n_pin=n_pin)
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12, err_msg=name)
    if n_pin:
        assert bool((got.Bz[:, :n_pin] == 0).all())
        assert bool((got.gu[:, :n_pin] == 0).all())


@pytest.mark.parametrize("case", ["unbounded", "pinned"])
def test_build_stage_qp_needs_lin(case):
    """Without a stage linearization (lin=None) the QP linearizes each
    instance itself through ShootingProblem.linearize_stages, as the JAX
    build_stage_qp does: against jax.vmap(build_stage_qp(lin=None)), every
    field at float64 1e-12."""
    jprob, prob, p, a = _inputs(case)
    n_pin = 2 if case == "pinned" else 0
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref = jax.vmap(lambda X, U, pp, mu, reg: jsq.build_stage_qp(
        jprob, X, U, pp, mu, reg, n_pin=n_pin))(
        j["X"], j["U"], p, j["mu"], j["reg"])
    tp = params_from_numpy(jax.tree.map(np.asarray, p), dtype=torch.float64,
                           device="cpu")
    t = {k: torch.tensor(v) for k, v in a.items()}
    got = build_stage_qp(prob, t["X"], t["U"], tp, t["mu"], t["reg"],
                         lin=None, n_pin=n_pin)
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12, err_msg=name)


def _box(seed, n=5, m=7):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2, -0.5, (m, n))
    hi = rng.uniform(0.5, 2, (m, n))
    lo[:, 0], hi[:, 1] = -INF, INF
    lo[0, 2], hi[0, 2] = -INF, INF
    v = rng.uniform(-0.4, 0.4, (m, n))
    dv = rng.standard_normal((m, n)) * 3.0
    mu = rng.uniform(1e-3, 1.0, m)
    return v, dv, lo, hi, mu


def test_barrier_value_matches_jax():
    """Per-row barrier value (some sides infinite) at float64 1e-12."""
    v, _, lo, hi, mu = _box(1)
    got = barrier_value(torch.tensor(v), torch.tensor(lo), torch.tensor(hi),
                        torch.tensor(mu)[:, None])
    ref = jax.vmap(jsq.barrier_value)(jnp.asarray(v), jnp.asarray(lo),
                                      jnp.asarray(hi), jnp.asarray(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_fraction_to_boundary_matches_jax():
    """Per-row step cap, including rows whose step leaves no bound
    binding (cap 1), at float64 1e-12, and the cap keeps the step inside."""
    v, dv, lo, hi, _ = _box(2)
    got = fraction_to_boundary(torch.tensor(v), torch.tensor(dv),
                               torch.tensor(lo), torch.tensor(hi))
    ref = jax.vmap(jsq.fraction_to_boundary)(
        jnp.asarray(v), jnp.asarray(dv), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    a = got.numpy()[:, None]
    assert ((v + a * dv > lo) & (v + a * dv < hi)).all()
    assert 0 < a.min() and a.max() <= 1.0
