"""Explicit integrators (port of ``mahi_mpc_tpu/models/integrators.py``).

The reference embeds a forward-Euler step ``x_next = x + x_dot*dt`` in the NLP
(``src/Mahi/Mpc/ModelGenerator.cpp:33-34``); RK4 and midpoint serve plant
simulation and the generic solver path.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor
ODE = Callable[[Tensor, Tensor], Tensor]  # f(x, u) -> x_dot
Step = Callable[[Tensor, Tensor], Tensor]  # F(x, u) -> x_next


def euler_step(f: ODE, dt: float) -> Step:
    """Forward Euler: parity with ``ModelGenerator.cpp:33``."""

    def step(x: Tensor, u: Tensor) -> Tensor:
        return x + f(x, u) * dt

    return step


def midpoint_step(f: ODE, dt: float) -> Step:
    def step(x: Tensor, u: Tensor) -> Tensor:
        k1 = f(x, u)
        return x + dt * f(x + 0.5 * dt * k1, u)

    return step


def rk4_step(f: ODE, dt: float) -> Step:
    """Classic RK4 with zero-order-hold control
    (``model_generate_example.cpp:207-213``)."""

    def step(x: Tensor, u: Tensor) -> Tensor:
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return step


_INTEGRATORS = {
    "euler": euler_step,
    "midpoint": midpoint_step,
    "rk4": rk4_step,
}


def _euler_increment(f: ODE, dt: float) -> Step:
    return lambda x, u: dt * f(x, u)


def _midpoint_increment(f: ODE, dt: float) -> Step:
    return lambda x, u: dt * f(x + 0.5 * dt * f(x, u), u)


def _rk4_increment(f: ODE, dt: float) -> Step:
    def inc(x: Tensor, u: Tensor) -> Tensor:
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return inc


_INCREMENTS = {
    "euler": _euler_increment,
    "midpoint": _midpoint_increment,
    "rk4": _rk4_increment,
}


def make_increment(f: ODE, dt: float, method: str = "euler") -> Step:
    """The step's increment ``F(x, u) - x``, formed directly and not as a
    difference (the fused kernel's step policies, ``csrc/model_dynamics.cuh``
    ``model_increment``): no float32 rounding of x enters it."""
    try:
        return _INCREMENTS[method](f, dt)
    except KeyError:
        raise ValueError(
            f"unknown integrator {method!r}; choose from {sorted(_INCREMENTS)}"
        ) from None


def make_step(f: ODE, dt: float, method: str = "euler") -> Step:
    try:
        return _INTEGRATORS[method](f, dt)
    except KeyError:
        raise ValueError(
            f"unknown integrator {method!r}; choose from {sorted(_INTEGRATORS)}"
        ) from None
