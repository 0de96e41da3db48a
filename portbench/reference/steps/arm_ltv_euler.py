"""The serial arm of the configuration's ``chain`` frozen at each
instance's measured state and previous control (the LTV path), and the
exact forward-Euler step of that affine model:
F(x, u) - x = dt (A (x - x0) + B (u - u0) + f(x0, u0)).

A configuration names this step with ``"reference": "arm_ltv_euler"``."""

from __future__ import annotations

from portbench.reference.arm import Arm
from portbench.reference.steps.arm_euler import check_model


class LtvStep:
    """The exact Euler step of f frozen at (x0, u0):
    A (x - x0) + B (u - u0) + f(x0, u0)."""

    def __init__(self, arm: Arm, dt: float, x0, u0):
        fv, A, B = arm.jacobians(x0, u0)
        self.AmI, self.Bd = dt * A, dt * B
        self.cd = dt * (fv - (A @ x0[..., None])[..., 0]
                        - (B @ u0[..., None])[..., 0])

    def _mid(self, t, x):
        return t.reshape(t.shape[:1] + (1,) * (x.dim() - 2) + t.shape[1:])

    def inc(self, x, u):
        Am, Bd = self._mid(self.AmI, x), self._mid(self.Bd, x)
        return ((Am @ x[..., None])[..., 0] + (Bd @ u[..., None])[..., 0]
                + self._mid(self.cd, x))

    def linearize(self, xs, us):
        N = xs.shape[1]
        ex = lambda t: t[:, None].expand((t.shape[0], N) + t.shape[1:])
        return self.inc(xs, us), ex(self.AmI), ex(self.Bd)


def make(cfg: dict, p, dtype, device) -> LtvStep:
    """The step for the instances of ``p`` (a ``sqp.Params``), frozen at
    their ``x0`` and ``u_prev``."""
    check_model(cfg, is_linear=True)
    return LtvStep(Arm(cfg["chain"], dtype, device),
                   float(cfg["model"]["step_size"]), p.x0, p.u_prev)
