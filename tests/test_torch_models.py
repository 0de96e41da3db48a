"""The port's pendulum, cart-pole, double pendulum and acrobot against the
JAX package's models: ``f`` in the trailing-batch form at random states,
and ``linearize`` against ``jax.jacfwd``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu_torch.models import make_dynamics, registered_models

torch.set_num_threads(1)

MODELS = ["pendulum", "cartpole", "double_pendulum", "acrobot"]
M = 64


def _states(dyn, seed=0, n=M):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2.0, 2.0, (dyn.nx, n)),
            rng.uniform(-5.0, 5.0, (dyn.nu, n)))


def test_models_registered_like_jax():
    """Same names, sizes, second-order structure and lanes support."""
    assert set(MODELS) <= set(registered_models())
    for name in MODELS:
        a, b = make_dynamics(name), jax_make_dynamics(name)
        assert (a.nx, a.nu, a.nq, a.supports_lanes) == \
            (b.nx, b.nu, b.nq, b.supports_lanes), name


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_f_matches_jax(name, dtype):
    """f64 at atol 1e-12; f32 at rtol/atol 1e-6 (same expression, same
    order; the two frameworks' sin/cos differ in the last bit)."""
    dyn, jdyn = make_dynamics(name), jax_make_dynamics(name)
    x, u = _states(dyn)
    got = dyn.f(torch.tensor(x, dtype=getattr(torch, dtype)),
                torch.tensor(u, dtype=getattr(torch, dtype)))
    ref = jdyn.f(jnp.asarray(x, dtype), jnp.asarray(u, dtype))
    assert got.shape == (dyn.nx, M) and got.dtype == getattr(torch, dtype)
    tol = (dict(rtol=0, atol=1e-12) if dtype == "float64"
           else dict(rtol=1e-6, atol=1e-6))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("name", MODELS)
def test_linearize_matches_jacfwd(name):
    """(A, B, x_dot) at single states against jax.jacfwd, float64 1e-10."""
    dyn, jdyn = make_dynamics(name), jax_make_dynamics(name)
    x, u = _states(dyn, seed=1, n=6)
    for i in range(x.shape[1]):
        got = dyn.linearize(torch.tensor(x[:, i], dtype=torch.float64),
                            torch.tensor(u[:, i], dtype=torch.float64))
        ref = jdyn.linearize(jnp.asarray(x[:, i], jnp.float64),
                             jnp.asarray(u[:, i], jnp.float64))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-10)
