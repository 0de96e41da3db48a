"""The code generator (``mahi_mpc_tpu_torch/models/codegen.py``): a user's
lanes-polymorphic ``f`` traced and lowered to the C++ model the fused
kernel instantiates, and the fused route's rule that follows from it.

- The emitter's values and derivatives: for every op it lowers, the
  generated model (its g++ build, float64 and float32, through the
  dual-number code the kernel runs) against ``f`` and
  ``torch.func.jacfwd``.
- What it refuses (an op outside its set, an op that mixes lanes, Python
  control flow on values, array constants) makes ``fused_supported``
  False, decided before anything is built.
- The rule itself against the JAX package's ``fused_supported``.
- A failed g++ build of a generated unit raises and names its log.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.models.base import Dynamics as JaxDynamics
from mahi_mpc_tpu.solver.fused import fused_supported as jax_fused_supported
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import ModelParameters
from mahi_mpc_tpu_torch._build import (BUILD_DIR, cpu_build_all,
                                       cpu_library, register_generated)
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.models.base import Dynamics
from mahi_mpc_tpu_torch.models.codegen import Unsupported, lower, lowerable
from mahi_mpc_tpu_torch.solver.fused import fused_supported
from mahi_mpc_tpu_torch.solver.target import (GENERATED_ID, INTEGRATORS,
                                              kernel_target)
from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

torch.set_num_threads(1)

C = torch.tensor(2.5)           # a one-element constant f closes over


def _arith(x, u):
    """+ - * / and negation, reciprocal and reversed subtraction, Python
    scalars and ints, every transcendental, pow by constants."""
    a, b, c, d = x[0], x[1], x[2], x[3]
    s = torch.sin(a) * torch.cos(b) + torch.tan(0.3 * c) - 2.0 / (3.0 + d * d)
    t = torch.exp(0.1 * a) * torch.log(1.0 + b * b) - torch.sqrt(2.0 + c * c)
    v = (torch.tanh(d) * torch.abs(a - b) + (1 - c) * 3 - (-u[0])
         + torch.rsqrt(1.0 + d * d))
    w = (a ** 2 + b ** 3 - (1.5 + c * c) ** -1 + (1.5 + d * d) ** -2
         + (2.0 + a * a) ** 0.5 - (2.0 + b * b) ** -0.5
         + (2.0 + c * c) ** 1.5 + d ** 1 + b ** 0)
    return torch.stack([s * u[1], t + u[0], v, w / (2.0 + u[1] * u[1])])


def _select(x, u):
    """where with every comparison and their logical combinations, where
    with Python-scalar branches, minimum and maximum."""
    a, b, c, d = x[0], x[1], x[2], x[3]
    w1 = torch.where(a > b, a * c, b - c)
    w2 = torch.where((c < 0.2) & (d >= -0.1), c * d, 0.5)
    w3 = torch.where(~(a <= d) | (b == 0.7) | (c != c), 1.0, a * b)
    m = torch.minimum(a, u[0]) + torch.maximum(b * c, u[1])
    floor = torch.maximum(d, torch.full_like(d, 0.1))
    return torch.stack([w1 + m, w2 - u[0], w3 * u[1],
                        floor + torch.minimum(a * d, torch.zeros_like(d))])


def _indexing(x, u):
    """A second-order model (nq = 2, its acc lowered): slices, cat, stack,
    unsqueeze / squeeze, reshape, full_like / zeros_like / ones_like, a
    closed-over one-element tensor."""
    q, qd = x[:2], x[2:]
    rev = torch.cat([q[1:], q[:1]])
    acc = (u * C - torch.sin(rev) * 9.81 - 0.1 * qd).reshape(1, 2, -1)
    acc = acc.squeeze(0) + torch.stack([torch.zeros_like(q[0]),
                                        torch.full_like(q[1], 0.25)])
    return torch.cat([qd, acc * torch.ones_like(qd)
                      + q.unsqueeze(0)[0].clone().detach() * 0.5])


OPS_MODELS = {
    "arith": Dynamics("arith", 4, 2, _arith, supports_lanes=True),
    "select": Dynamics("select", 4, 2, _select, supports_lanes=True),
    "indexing": Dynamics("indexing", 4, 2, _indexing, supports_lanes=True,
                         nq=2),
}


def _problem(dyn, integrator="rk4", is_linear=False):
    mp = ModelParameters("t", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
                         num_shooting_nodes=6, integrator=integrator,
                         is_linear=is_linear)
    return make_problem(mp, dyn)


@pytest.fixture(scope="module")
def ops_libraries():
    """Every generated unit this file runs, built by one concurrent call."""
    names = {k: kernel_target(_problem(d)).cuda
             for k, d in OPS_MODELS.items()}
    libs = cpu_build_all(names.values())
    return {k: libs[n] for k, n in names.items()}


@pytest.mark.parametrize("bits", ["f64", "f32"])
@pytest.mark.parametrize("name", list(OPS_MODELS))
def test_generated_model_matches_torch(ops_libraries, name, bits):
    """The generated f and its Jacobian d f / d[x; u] (the kernel's dual
    numbers, one tangent a pass) against f and torch.func.jacfwd at 16
    random points: float64 at 1e-10 relative (the same operations in the
    same order; the Jacobian differs from jacfwd's own products only in
    rounding), float32 at 2e-5 of the values' size."""
    dyn = OPS_MODELS[name]
    nx, nu = dyn.nx, dyn.nu
    nz = nx + nu
    M = 16
    dtype = torch.float64 if bits == "f64" else torch.float32
    rng = np.random.default_rng(3)
    x = torch.tensor(0.8 * rng.standard_normal((nx, M)), dtype=dtype)
    u = torch.tensor(0.8 * rng.standard_normal((nu, M)), dtype=dtype)
    out = [torch.empty(s, dtype=dtype)
           for s in ((nx, M), (nx, nz, M), (nx, M), (nx, nz, M))]
    zero = (ctypes.c_double * 1)(0.0)
    fn = getattr(ops_libraries[name], f"mpc_model_eval_cpu_{bits}")
    assert fn(M, GENERATED_ID, 0, x.data_ptr(), u.data_ptr(), 0.01, zero,
              *[t.data_ptr() for t in out]) == 0
    fval, fjac = out[0], out[1]
    x64, u64 = x.double(), u.double()
    want = dyn.f(x64, u64)
    one = lambda z: dyn.f(z[:nx, None], z[nx:, None])[:, 0]
    jac = vmap(jacfwd(one))(torch.cat([x64, u64]).T).permute(1, 2, 0)
    if bits == "f64":
        tol = lambda ref: 1e-10 * (1.0 + ref.abs().max().item())
    else:
        tol = lambda ref: 2e-5 * (1.0 + ref.abs().max().item())
    np.testing.assert_allclose(fval.double().numpy(), want.numpy(), rtol=0,
                               atol=tol(want))
    np.testing.assert_allclose(fjac.double().numpy(), jac.numpy(), rtol=0,
                               atol=tol(jac))


def test_generated_model_is_second_order_acc():
    """A model with nq (2 nq == nx) lowers to `acc`, the last nq rows of
    f; a first-order one to all of `f` with NQ = 0."""
    g = lower(OPS_MODELS["indexing"])
    assert g.nq == 2 and "void acc(" in g.source and "NQ = 2" in g.source
    g = lower(OPS_MODELS["arith"])
    assert g.nq == 0 and "void f(" in g.source and "NQ = 0" in g.source
    # every literal is a constant of the kernel's scalar type
    assert "S(9.81)" in lower(OPS_MODELS["indexing"]).source


def _mixes_lanes(x, u):
    return torch.stack([x[0] - x[0].mean(), x[1] + u[0]])


def _contracts(x, u):
    return 0.1 * ((x @ x.T) @ x) + u


def _indexes_lanes(x, u):
    return torch.stack([x[1], x[0] * x[0, :1] + u[0]])


def _branches(x, u):
    if bool((x[0] > 0).all()):
        return torch.stack([x[1], u[0]])
    return torch.stack([x[1], -u[0]])


def _other_op(x, u):
    return torch.stack([x[1], torch.atan2(x[0], 1.0 + x[1] * x[1]) + u[0]])


def _array_constant(x, u):
    k = torch.tensor([1.0, 2.0])
    return torch.stack([x[1], x[0] * k[0] * k[1] + u[0]])


def _rolls_lanes(x, u):
    return torch.stack([x[1], torch.roll(x[0], 1) + u[0]])


REFUSED = {"lane_reduction": _mixes_lanes, "contraction": _contracts,
           "lane_index": _indexes_lanes, "value_branch": _branches,
           "other_op": _other_op, "array_constant": _array_constant,
           "lane_roll": _rolls_lanes}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unlowerable_f_is_not_fused(name, tmp_path, monkeypatch):
    """An f the emitter cannot lower makes fused_supported False, on its
    own decision before anything is built (no build is started), so the
    problem takes the lanes route."""
    from mahi_mpc_tpu_torch import _build
    dyn = Dynamics(name, 2, 1, REFUSED[name], supports_lanes=True)
    with pytest.raises(Unsupported):
        lower(dyn)
    built = []
    monkeypatch.setattr(_build, "_compile",
                        lambda *a, **k: built.append(a))
    for integrator in INTEGRATORS:
        assert not fused_supported(_problem(dyn, integrator))
    assert not lowerable(dyn) and built == []


def test_lanes_free_f_is_refused():
    """Dynamics without lanes support are never lowered."""
    dyn = Dynamics("no_lanes", 2, 1, lambda x, u: torch.stack([x[1], u[0]]))
    with pytest.raises(Unsupported):
        lower(dyn)
    assert not fused_supported(_problem(dyn))


# ---- the rule against the JAX package's ---------------------------------

def _jax_user(name):
    if name == "user_vdp":
        return JaxDynamics(name, 2, 1, lambda x, u: jnp.stack(
            [x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]]),
            supports_lanes=True)
    return JaxDynamics(name, 3, 2, lambda x, u: jnp.stack(
        [u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]]),
        supports_lanes=True)


def _torch_user(name):
    if name == "user_vdp":
        return Dynamics(name, 2, 1, lambda x, u: torch.stack(
            [x[1], (1.0 - x[0] * x[0]) * x[1] - x[0] + u[0]]),
            supports_lanes=True)
    return Dynamics(name, 3, 2, lambda x, u: torch.stack(
        [u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]]),
        supports_lanes=True)


LTV_TABLE = [(2, 1), (3, 2), (4, 1), (4, 2), (6, 3), (8, 4), (10, 2),
             (12, 6)]
RULE_TABLE = (
    [("model", n, i) for n in ("mahi_arm", "two_link_arm", "pendulum",
                               "cartpole", "double_pendulum", "acrobot")
     for i in INTEGRATORS]
    + [("user", n, i) for n in ("user_vdp", "user_unicycle")
       for i in INTEGRATORS]
    + [("no_lanes", "no_lanes", i) for i in INTEGRATORS]
    + [("ltv", f"{nx}x{nu}", "euler") for nx, nu in LTV_TABLE])


@pytest.mark.parametrize("kind, name, integrator", RULE_TABLE)
def test_rule_matches_jax(kind, name, integrator):
    """The port's fused_supported equals the JAX package's on the table:
    the six registered models under every integrator, both user models,
    dynamics without lanes support, and LTV at eight shapes (four of them
    outside the hand-written instantiations)."""
    if kind == "model":
        jdyn, dyn = jax_make_dynamics(name), make_dynamics(name)
    elif kind == "user":
        jdyn, dyn = _jax_user(name), _torch_user(name)
    elif kind == "no_lanes":
        jdyn = JaxDynamics(name, 2, 1, lambda x, u: jnp.stack([x[1], u[0]]))
        dyn = Dynamics(name, 2, 1, lambda x, u: torch.stack([x[1], u[0]]))
    else:
        nx, nu = map(int, name.split("x"))
        jdyn = JaxDynamics(name, nx, nu, lambda x, u: x, supports_lanes=True)
        dyn = Dynamics(name, nx, nu, lambda x, u: x, supports_lanes=True)
    kw = dict(num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
              num_shooting_nodes=10, integrator=integrator,
              is_linear=kind == "ltv")
    jprob = jax_make_problem(JaxModelParameters("t", **kw), jdyn)
    prob = make_problem(ModelParameters("t", **kw), dyn)
    assert fused_supported(prob) == jax_fused_supported(jprob)
    want = kind != "no_lanes"
    assert fused_supported(prob) is want
    if want:
        # a hand-written instantiation or a generated one serves it
        hand = kind == "model" or (kind == "ltv" and (dyn.nx, dyn.nu) in
                                   ((8, 4), (4, 2), (4, 1), (2, 1)))
        assert (kernel_target(prob).unit is None) == hand


# ---- builds ----------------------------------------------------------------

def test_failed_build_raises_and_names_its_log():
    """A generated unit g++ cannot compile raises, naming the log it
    wrote; nothing is loaded in its place, and asking again fails again."""
    name = register_generated("namespace mpc { this is not C++; }\n")
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"failed \(log: ") as e:
            cpu_library(name)
        log = str(e.value).split("(log: ")[1].split(")")[0]
        assert log.startswith(str(BUILD_DIR)) and "error" in open(log).read()
    assert not any(p.suffix == ".so" for p in BUILD_DIR.glob(f"{name}_*"))
