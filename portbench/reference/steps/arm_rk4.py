"""The serial arm of the configuration's ``chain``, discretized by one
classic RK4 step: F(x, u) - x = dt/6 (k1 + 2 k2 + 2 k3 + k4) with the
control held over the interval, linearized by forward-mode AD through all
four stages.

A configuration names this step with ``"reference": "arm_rk4"``."""

from __future__ import annotations

import torch

from portbench.reference.arm import Arm


class Rk4Step:
    """F(x, u) - x = dt/6 (k1 + 2 k2 + 2 k3 + k4), k1 = f(x, u),
    k2 = f(x + dt/2 k1, u), k3 = f(x + dt/2 k2, u), k4 = f(x + dt k3, u);
    its Jacobians by ``jacfwd`` of the whole increment."""

    def __init__(self, arm: Arm, dt: float):
        self.arm, self.dt = arm, dt

    def inc(self, x, u):
        f, h = self.arm.f, self.dt
        k1 = f(x, u)
        k2 = f(x + (0.5 * h) * k1, u)
        k3 = f(x + (0.5 * h) * k2, u)
        k4 = f(x + h * k3, u)
        return (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def linearize(self, xs, us):
        M, N, nx = xs.shape
        x, u = xs.reshape(M * N, nx), us.reshape(M * N, -1)
        one = lambda a, b: self.inc(a[None], b[None])[0]
        A, B = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))(x, u)
        sh = lambda t: t.reshape((M, N) + t.shape[1:])
        return sh(self.inc(x, u)), sh(A), sh(B)


def check_model(cfg: dict) -> None:
    """Refuse a configuration this step does not implement."""
    m = cfg["model"]
    if m["integrator"] != "rk4" or bool(m["is_linear"]) \
            or "chain" not in cfg:
        raise ValueError(
            f"{cfg['name']}: integrator {m['integrator']!r}, is_linear "
            f"{m['is_linear']}; this reference step is the serial arm's "
            "RK4 step, not linear")
    if (m["num_x"], m["num_u"]) != (2 * len(cfg["chain"]["links"]),
                                    len(cfg["chain"]["links"])):
        raise ValueError(f"{cfg['name']}: num_x, num_u do not match the "
                         "chain's links")


def make(cfg: dict, p, dtype, device) -> Rk4Step:
    """The discrete step for the instances of ``p`` (a ``sqp.Params``)."""
    check_model(cfg)
    return Rk4Step(Arm(cfg["chain"], dtype, device),
                   float(cfg["model"]["step_size"]))
