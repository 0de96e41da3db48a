"""Single pendulum and cart-pole dynamics (port of
``mahi_mpc_tpu/models/pendulum.py``), in the component-leading,
trailing-batch form: ``f((nx, ...), (nu, ...)) -> (nx, ...)``."""

from __future__ import annotations

import torch

from .base import Dynamics, register, with_closed_form

Tensor = torch.Tensor


@register("pendulum")
def make_pendulum(m: float = 1.0, l: float = 1.0, g: float = 9.81,
                  b: float = 0.0) -> Dynamics:
    """Torque-actuated pendulum. State x = [theta, theta_dot] with theta = 0
    hanging down; control u = [torque]."""

    mgl, ml2 = m * g * l, m * l * l

    def f(x: Tensor, u: Tensor) -> Tensor:
        th, thd = x[0], x[1]
        thdd = (u[0] - b * thd - mgl * torch.sin(th)) / ml2
        return torch.stack([thd, thdd])

    return with_closed_form(
        Dynamics("pendulum", nx=2, nu=1, f=f, supports_lanes=True, nq=1),
        [b, mgl, ml2])


@register("cartpole")
def make_cartpole(mc: float = 1.0, mp: float = 0.2, l: float = 0.5,
                  g: float = 9.81) -> Dynamics:
    """Cart-pole with force on the cart.  State x = [p, theta, p_dot,
    theta_dot] (theta = 0 hanging down), control u = [force]."""

    mpl, mcg = mp * l, (mc + mp) * g

    def f(x: Tensor, u: Tensor) -> Tensor:
        th, pd, thd = x[1], x[2], x[3]
        s, c = torch.sin(th), torch.cos(th)
        den = mc + mp * s * s
        pdd = (u[0] + mp * s * (l * thd * thd + g * c)) / den
        thdd = (-u[0] * c - mpl * thd * thd * c * s - mcg * s) / (l * den)
        return torch.stack([pd, thd, pdd, thdd])

    return with_closed_form(
        Dynamics("cartpole", nx=4, nu=1, f=f, supports_lanes=True, nq=2),
        [mc, mp, l, g, mpl, mcg])
