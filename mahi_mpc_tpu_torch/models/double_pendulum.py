"""Fully actuated double pendulum and the acrobot (port of
``mahi_mpc_tpu/models/double_pendulum.py``).

State x = [qA, qB, qA_dot, qB_dot]: two links of length L with point masses
m at the link tips, qA measured from the horizontal, qB relative to link A,
gravity g.  The accelerations are evaluated in the JAX package's factored
manipulator form, term by term, in the trailing-batch tensor form.
"""

from __future__ import annotations

import torch

from .base import Dynamics, register, with_closed_form

Tensor = torch.Tensor


@register("double_pendulum")
def make_double_pendulum(L: float = 1.0, m: float = 1.0,
                         g: float = 9.81) -> Dynamics:
    """Torques at both joints: u = [TA, TB]."""

    ml2, mgl = m * L * L, m * g * L

    def f(x: Tensor, u: Tensor) -> Tensor:
        qA, qB, qAd, qBd = x[0], x[1], x[2], x[3]
        TA, TB = u[0], u[1]
        cB, sB = torch.cos(qB), torch.sin(qB)

        # M(q) qdd + c(q, qd) + grav(q) = tau with
        # M = ml2 * [[3 + 2 cB, 1 + cB], [1 + cB, 1]].
        m11 = ml2 * (3.0 + 2.0 * cB)
        m12 = ml2 * (1.0 + cB)
        m22 = ml2

        c1 = -ml2 * sB * (2.0 * qAd * qBd + qBd * qBd)
        c2 = ml2 * sB * qAd * qAd

        g1 = mgl * (2.0 * torch.cos(qA) + torch.cos(qA + qB))
        g2 = mgl * torch.cos(qA + qB)

        rhs1 = TA - c1 - g1
        rhs2 = TB - c2 - g2
        det = m11 * m22 - m12 * m12
        qAdd = (m22 * rhs1 - m12 * rhs2) / det
        qBdd = (m11 * rhs2 - m12 * rhs1) / det
        return torch.stack([qAd, qBd, qAdd, qBdd])

    return with_closed_form(
        Dynamics("double_pendulum", nx=4, nu=2, f=f, supports_lanes=True,
                 nq=2), [ml2, mgl])


@register("acrobot")
def make_acrobot(L: float = 1.0, m: float = 1.0, g: float = 9.81) -> Dynamics:
    """Underactuated double pendulum: torque at the elbow only, u = [TB]."""
    dp = make_double_pendulum(L=L, m=m, g=g)

    def f(x: Tensor, u: Tensor) -> Tensor:
        return dp.f(x, torch.stack([torch.zeros_like(u[0]), u[0]]))

    return with_closed_form(
        Dynamics("acrobot", nx=4, nu=1, f=f, supports_lanes=True, nq=2),
        dp.closed_form[1])
