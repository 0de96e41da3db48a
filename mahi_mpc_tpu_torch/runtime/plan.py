"""Plan objects: the (t, x, u) sequence a solve produces, with ZOH lookup
(the port's own copy of ``mahi_mpc_tpu/runtime/plan.py``, which imports
no JAX either).

The equivalent of the reference's ``ControlResult`` vectors +
``control_at_time`` zero-order-hold lookup (``ModelControl.cpp:174-197``,
``ModelControl.hpp:46-56``).  The reference indexes ``control_results[i]``
before checking emptiness (UB before the first solve completes,
``ModelControl.cpp:195-196``); here an empty plan returns the fallback
control, by construction.

The plan is immutable; the async runtime hands plans between threads by
atomic reference swap (no shared mutable state).  Lookup is pure numpy:
the 1 kHz control thread never touches the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Plan:
    """One solve's receding-horizon plan.

    times: (N+1,) absolute times of the shooting nodes.
    X: (N+1, nx) planned states.  U: (N, nu) planned controls (ZOH on
    [times[k], times[k+1])).  Diagnostics mirror the per-instance status
    carried by the solver.
    """

    times: np.ndarray
    X: np.ndarray
    U: np.ndarray
    iters: int = 0
    status: int = 0
    kkt: float = 0.0
    feas: float = 0.0
    obj: float = 0.0
    solve_time_s: float = 0.0

    @property
    def N(self) -> int:
        return self.U.shape[0]

    def control_at_time(self, t: float) -> np.ndarray:
        """ZOH control lookup (``ModelControl.cpp:192-197``): the control of
        the last node whose time is <= t; clamped to the plan's ends."""
        k = int(np.searchsorted(self.times, t, side="right")) - 1
        k = min(max(k, 0), self.N - 1)
        return self.U[k]

    def state_at_time(self, t: float) -> np.ndarray:
        """Linear interpolation of the planned state (the reference only
        exposes the control; the state is useful for estimation/monitoring)."""
        t = float(np.clip(t, self.times[0], self.times[-1]))
        k = int(np.searchsorted(self.times, t, side="right")) - 1
        k = min(max(k, 0), self.N - 1)
        dt = self.times[k + 1] - self.times[k]
        a = 0.0 if dt <= 0 else (t - self.times[k]) / dt
        return (1.0 - a) * self.X[k] + a * self.X[k + 1]

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(times, X, U) — the reference's ``control_results()`` accessor
        (``ModelControl.hpp:40``)."""
        return self.times, self.X, self.U


def empty_plan(nx: int, nu: int, u_fallback: Optional[np.ndarray] = None) -> Plan:
    """Pre-first-solve placeholder: one node, zero (or given) control."""
    u = np.zeros(nu) if u_fallback is None else np.asarray(u_fallback, float)
    return Plan(times=np.array([0.0, np.inf]), X=np.zeros((2, nx)),
                U=u[None, :], status=-1)
