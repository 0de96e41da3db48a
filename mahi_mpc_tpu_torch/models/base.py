"""Dynamics model protocol (port of ``mahi_mpc_tpu/models/base.py``).

A model is a function ``f(x, u) -> x_dot`` on tensors, and its linearization
is ``torch.func.jacfwd`` (the reference codegens ``get_A``/``get_B`` from
CasADi, ``ModelGenerator.cpp:45-53``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.func import jacfwd

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Dynamics:
    """A continuous-time control system ``x_dot = f(x, u)``.

    ``supports_lanes``: ``f`` takes a *trailing* batch — ``f((nx, ...),
    (nu, ...)) -> (nx, ...)`` with component indices leading.

    ``nq``: set (with ``nx == 2 * nq``) for a second-order mechanical system
    with state ``x = [q, qd]`` and ``f = [qd, acc(x, u)]``; the fused solver
    then differentiates only the ``nq`` acceleration rows.
    """

    name: str
    nx: int
    nu: int
    f: Callable[[Tensor, Tensor], Tensor]
    supports_lanes: bool = False
    nq: int | None = None

    def __call__(self, x: Tensor, u: Tensor) -> Tensor:
        return self.f(x, u)

    def linearize(self, x: Tensor, u: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """``(A, B, x_dot)`` at one state ``(x, u)`` — the runtime equivalent
        of the reference's ``get_A / get_B / get_x_dot_init``
        (``ModelGenerator.cpp:51-53``, ``ModelControl.cpp:70-72,125-135``)."""
        f = self.f
        if self.supports_lanes:
            # A trailing batch of one keeps intermediates 1-D: forward-mode
            # AD promotes a 0-d tangent times a python float to float64.
            f = lambda x_, u_: self.f(x_[:, None], u_[:, None])[:, 0]
        A, B = jacfwd(f, argnums=(0, 1))(x, u)
        return A, B, self.f(x, u)

    def linear_f(self, x: Tensor, u: Tensor, A: Tensor, B: Tensor,
                 x_dot0: Tensor, x0: Tensor, u0: Tensor) -> Tensor:
        """Frozen LTV right-hand side ``x_dot = A (x - x0) + B (u - u0) +
        x_dot0`` (successive-linearization mode, ``ModelGenerator.cpp:47``)."""
        return A @ (x - x0) + B @ (u - u0) + x_dot0


def with_closed_form(dyn: Dynamics, consts: list) -> Dynamics:
    """Record the constants of a model that the fused CUDA kernel also has
    in closed form (``csrc/model_dynamics.cuh``), as ``dyn.closed_form =
    (name, consts)``: the products ``f`` folds, in the order the kernel's
    ``load`` reads them.  Returns ``dyn``."""
    object.__setattr__(dyn, "closed_form", (dyn.name, list(consts)))
    return dyn


_REGISTRY: Dict[str, Callable[..., Dynamics]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def make_dynamics(name: str, **kwargs) -> Dynamics:
    """Instantiate a registered model family by name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dynamics {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def registered_models():
    return sorted(_REGISTRY)
