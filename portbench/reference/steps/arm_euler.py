"""The serial arm of the configuration's ``chain``, discretized by forward
Euler: F(x, u) - x = dt f(x, u), linearized by forward-mode AD.

A configuration names this step with ``"reference": "arm_euler"``."""

from __future__ import annotations

from portbench.reference.arm import Arm


class EulerStep:
    """F(x, u) - x = dt f(x, u), linearized by forward-mode AD."""

    def __init__(self, arm: Arm, dt: float):
        self.arm, self.dt = arm, dt

    def inc(self, x, u):
        return self.dt * self.arm.f(x, u)

    def linearize(self, xs, us):
        M, N, nx = xs.shape
        fv, A, B = self.arm.jacobians(xs.reshape(M * N, nx),
                                      us.reshape(M * N, -1))
        sh = lambda t: t.reshape((M, N) + t.shape[1:])
        return self.dt * sh(fv), self.dt * sh(A), self.dt * sh(B)


def check_model(cfg: dict, is_linear: bool) -> None:
    """Refuse a configuration this step does not implement."""
    m = cfg["model"]
    if m["integrator"] != "euler" or bool(m["is_linear"]) != is_linear \
            or "chain" not in cfg:
        raise ValueError(
            f"{cfg['name']}: integrator {m['integrator']!r}, is_linear "
            f"{m['is_linear']}; this reference step is the serial arm's "
            f"forward Euler with is_linear {is_linear}")
    if (m["num_x"], m["num_u"]) != (2 * len(cfg["chain"]["links"]),
                                    len(cfg["chain"]["links"])):
        raise ValueError(f"{cfg['name']}: num_x, num_u do not match the "
                         "chain's links")


def make(cfg: dict, p, dtype, device) -> EulerStep:
    """The discrete step for the instances of ``p`` (a ``sqp.Params``)."""
    check_model(cfg, is_linear=False)
    return EulerStep(Arm(cfg["chain"], dtype, device),
                     float(cfg["model"]["step_size"]))
