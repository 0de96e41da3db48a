"""Which instantiation of the hand-written kernels serves a problem.

The fused kernel (``csrc/fused_sqp.cuh`` ``dispatch``) holds one
instantiation for each step policy and model it serves, in one of four
hand-written CUDA libraries, or in a library generated for the problem
(``_build.register_generated``): a user's model emitted as C++ from its
traced ``f`` (``models/codegen.py``), or an LTV shape outside
``LTV_SHAPES``.  The LTV path's linearization (``csrc/model_linearize.cuh``
``model_dispatch``) lives with the model.  This module decides both, once
a problem (``kernel_target``) and once a model (``model_kernel``), and
keeps the answer: the problem and its dynamics are frozen, as the JAX
package fixes a model's constants once, when it traces the kernel.  The
fused route (``fused.py``), the LTV path (``linearize.py``) and the
generator (``runtime/generate.py``) read its fields.  Nothing here builds
a library: a generated unit is only named.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

from .. import _build
from ..models import arm
from ..models.codegen import lower, lowerable
from ..transcribe.shooting import ShootingProblem

# The kernel's instantiations (csrc/fused_sqp.cuh `dispatch`): model ids in
# the order of its ModelId (serial arms by joint count), integrators in the
# order of csrc/model_dynamics.cuh Integrator, and the LTV (nx, nu).
ARM_IDS = {2: 0, 4: 1}
CLOSED_FORM_IDS = {"pendulum": 2, "cartpole": 3, "double_pendulum": 4,
                   "acrobot": 5}
INTEGRATORS = ("euler", "midpoint", "rk4")
LTV_SHAPES = ((8, 4), (4, 2), (4, 1), (2, 1))
GENERATED_ID = -2         # csrc/fused_sqp.cuh kGeneratedModel
LTV_ID = -1               # the model id of an LTV solve: no model


class KernelTarget(NamedTuple):
    """The fused kernel's instantiation for a problem."""
    mode: str                 # "fast" (nq rows), "generic" (nx rows), "ltv"
    model: int                # the model id the C interface takes
    consts: tuple             # the model's constants (floats)
    unit: Optional[str]       # the generated unit's C++, None: hand-written
    cuda: str                 # the CUDA library that holds it
    generated: Optional[str]  # the generated library (its g++ build too)


class ModelKernel(NamedTuple):
    """The LTV path's linearization kernel for a model."""
    model: int                # the model id the C interface takes
    consts: tuple             # the model's constants (floats)
    library: str              # the CUDA library that holds it


def arm_flat(dyn) -> tuple:
    """Chain constants in the order of csrc/arm_dynamics.cuh load_arm."""
    c = arm.arm_constants(dyn)
    out = []
    for key in ("axes", "offsets", "coms", "masses", "inertias", "neg_g"):
        out += np.asarray(c[key], dtype=np.float64).reshape(-1).tolist()
    return tuple(out + [c["damping"]])


@functools.lru_cache(maxsize=None)
def _hand_model(dyn) -> Optional[tuple]:
    """(model id, constants) of the kernel's own dynamics for this model,
    or None when the kernel has none.  The constants are the arms' chain
    (``arm_flat``) or what the closed-form factory recorded
    (``models.base.with_closed_form``)."""
    if getattr(dyn, "chain", None) is not None:
        return (ARM_IDS[dyn.nq], arm_flat(dyn)) if dyn.nq in ARM_IDS \
            else None
    form = getattr(dyn, "closed_form", None)
    if form is None or form[0] not in CLOSED_FORM_IDS:
        return None
    return CLOSED_FORM_IDS[form[0]], tuple(form[1])


def _unit(model: str, policy: str, make: str) -> str:
    """A generated unit: the model's C++ (or nothing) and
    ``GeneratedStep<S>::make``, which returns ``policy`` as ``make``."""
    return "\n".join([
        model + "namespace mpc {",
        "template <typename S>",
        "struct GeneratedStep {",
        f"  static {policy} make(const FusedArgs<S>& a) {{",
        "    (void)a;",
        f"    return {make};",
        "  }",
        "};",
        "}  // namespace mpc", ""])


def _user_model(dyn) -> str:
    """The C++ of a user's model (``models/codegen.py``): a
    lanes-polymorphic ``Dynamics`` without a hand-written CUDA form that the
    generator lowers; "" for every other."""
    if not dyn.supports_lanes or _hand_model(dyn) is not None or \
            not lowerable(dyn):
        return ""
    return lower(dyn).source


@functools.lru_cache(maxsize=None)
def _ltv_unit(dyn) -> str:
    """The generated unit of the ``Ltv<S, nx, nu>`` policy at the model's
    shape.  For a user's model (``_user_model``) it also holds the model,
    ``mpc::gen::Model<S>``, whose linearization the build then exports
    (``csrc/model_linearize.cuh`` ``model_dispatch``): the library of such
    a model's LTV path."""
    return _unit(_user_model(dyn), f"Ltv<S, {dyn.nx}, {dyn.nu}>", "{}")


def step_mode(prob: ShootingProblem) -> str:
    """The JAX kernel's step mode: "ltv", "fast" (its nq-row rule: the
    Euler step of a second-order model, whose nq acceleration rows alone
    need AD) or "generic" (nx rows through the integrator step)."""
    if prob.is_linear:
        return "ltv"
    nq = prob.dynamics.nq
    return ("fast" if nq is not None and 2 * nq == prob.nx
            and prob.integrator == "euler" else "generic")


@functools.lru_cache(maxsize=None)
def kernel_target(prob: ShootingProblem) -> Optional[KernelTarget]:
    """The fused kernel's instantiation for ``prob``, or None where the
    kernel does not serve it: the JAX rule (``fused.py:173-179``) under
    ``INTEGRATORS``.  Every LTV problem (any (nx, nu)); every nonlinear
    problem whose dynamics are lanes-polymorphic, when the kernel has them
    in CUDA (the serial arms with nq 2 or 4 and the four closed-form
    models) or ``models/codegen.py`` lowers their ``f`` (decided by
    tracing, before anything is built), in its ``step_mode``.
    Hand-written instantiations serve LTV at ``LTV_SHAPES`` and the six
    registered models; every other problem gets a generated unit (the
    model ``mpc::gen::Model<S>`` and the step policy over it, ``FastNq``
    or ``Generic``, or the ``Ltv<S, NX, NU>`` policy, as
    ``GeneratedStep<S>::make``), named by ``_build.register_generated``
    and built at first use."""
    if prob.integrator not in INTEGRATORS:
        return None
    dyn = prob.dynamics
    if prob.is_linear:
        if (prob.nx, prob.nu) in LTV_SHAPES:
            return KernelTarget("ltv", LTV_ID, (0.0,), None,
                                "fused_sqp_ltv", None)
        return _generated("ltv", _ltv_unit(dyn))
    if not dyn.supports_lanes:
        return None
    mode = step_mode(prob)
    fast = mode == "fast"
    hand = _hand_model(dyn)
    if hand is not None:
        cuda = ("fused_sqp_models" if getattr(dyn, "chain", None) is None
                else "fused_sqp" if fast else "fused_sqp_generic")
        return KernelTarget(mode, *hand, None, cuda, None)
    if not lowerable(dyn):
        return None
    return _generated(mode, _unit(
        lower(dyn).source,
        f"{'FastNq' if fast else 'Generic'}<S, gen::Model<S>>",
        "{{}}" if fast else "{{}, a.integ}"))


def _generated(mode: str, unit: str) -> KernelTarget:
    name = _build.register_generated(unit)
    model = LTV_ID if mode == "ltv" else GENERATED_ID
    return KernelTarget(mode, model, (0.0,), unit, name, name)


@functools.lru_cache(maxsize=None)
def model_kernel(dyn) -> Optional[ModelKernel]:
    """The LTV path's linearization kernel for ``dyn``: a serial arm with
    nq 2 or 4 (``fused_sqp``), a closed form (``fused_sqp_models``), or a
    lanes-polymorphic ``f`` the code generator lowers (its generated LTV
    unit, ``_ltv_unit``), decided by tracing before anything is built;
    None for every other model: the eager route."""
    hand = _hand_model(dyn)
    if hand is not None:
        return ModelKernel(*hand, "fused_sqp" if getattr(dyn, "chain", None)
                           is not None else "fused_sqp_models")
    if not _user_model(dyn):
        return None
    return ModelKernel(GENERATED_ID, (0.0,),
                       _build.register_generated(_ltv_unit(dyn)))
