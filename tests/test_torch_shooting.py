"""The port's multiple-shooting transcription against the JAX package's:
step, rollout, defects and cost of one instance, for each integrator, from
the same numpy inputs in float64."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters
from mahi_mpc_tpu_torch.convert import params_from_numpy
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.transcribe.shooting import (default_params,
                                                    make_problem)

torch.set_num_threads(1)

N = 6


def _pair(integrator, seed=0):
    kw = dict(num_x=8, num_u=4, step_size=0.002, num_shooting_nodes=N,
              u_min=[-20.0] * 4, u_max=[20.0] * 4, dynamics_name="mahi_arm",
              integrator=integrator)
    jmp = JaxModelParameters("t", **kw)
    jprob = jax_make_problem(jmp, jax_make_dynamics("mahi_arm"))
    prob = make_problem(ModelParameters("t", **kw), make_dynamics("mahi_arm"))
    rng = np.random.default_rng(seed)
    f64 = jnp.float64
    p = jax_default_params(jmp, dtype=f64)._replace(
        x_des=jnp.asarray(0.2 * rng.standard_normal((N, 8)), f64),
        q=jnp.asarray(rng.uniform(0.5, 10.0, 8), f64),
        r=jnp.asarray(rng.uniform(0.05, 0.2, 4), f64),
        rm=jnp.asarray(rng.uniform(0.005, 0.02, 4), f64),
        u_prev=jnp.asarray(rng.standard_normal(4), f64),
        qf=jnp.asarray(rng.uniform(0.0, 5.0, 8), f64),
        xf_des=jnp.asarray(0.1 * rng.standard_normal(8), f64))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), dtype=torch.float64,
                           device="cpu")
    X = 0.2 * rng.standard_normal((N + 1, 8))
    U = rng.standard_normal((N, 4))
    return jprob, p, prob, tp, X, U


@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
def test_shooting_matches_jax_f64(integrator):
    """Rollout, defects and cost agree to float64 roundoff (rtol 1e-12,
    atol 1e-12: the same formulas in the same order of terms)."""
    jprob, p, prob, tp, X, U = _pair(integrator)
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        prob.step(Xt[0], Ut[0], tp).numpy(),
        np.asarray(jprob.step(jnp.asarray(X[0]), jnp.asarray(U[0]), p)),
        **tol)
    np.testing.assert_allclose(
        prob.rollout(Xt[0], Ut, tp).numpy(),
        np.asarray(jprob.rollout(jnp.asarray(X[0]), jnp.asarray(U), p)),
        **tol)
    np.testing.assert_allclose(
        prob.defects(Xt, Ut, tp).numpy(),
        np.asarray(jprob.defects(jnp.asarray(X), jnp.asarray(U), p)), **tol)
    np.testing.assert_allclose(
        float(prob.cost(Xt, Ut, tp)),
        float(jprob.cost(jnp.asarray(X), jnp.asarray(U), p)), **tol)


def test_params_default_to_the_card(monkeypatch):
    """``default_params`` and ``params_from_numpy`` put their tensors on the
    card unless asked for another device, as every entry point of the port
    does; without a card the bare call raises rather than giving CPU
    tensors, and ``device="cpu"`` still works."""
    for fn in (default_params, params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    mp = ModelParameters("t", num_x=2, num_u=1, step_size=0.05,
                         num_shooting_nodes=4, dynamics_name="pendulum")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=.cpu."):
        default_params(mp)
    p = default_params(mp, device="cpu")
    with pytest.raises(RuntimeError, match="device=.cpu."):
        params_from_numpy(p)
    assert params_from_numpy(p, device="cpu").x_des.device.type == "cpu"
