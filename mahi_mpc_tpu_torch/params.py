"""Problem-shape configuration and persistence.

A copy of ``mahi_mpc_tpu/params.py`` (which is already free of JAX): the
reference's ``ModelParameters`` POD and its JSON (de)serialization
(reference: ``include/Mahi/Mpc/ModelParameters.hpp:11-28``,
``src/Mahi/Mpc/ModelParameters.cpp:37-72``).  The JSON schema is kept
field-for-field compatible with the reference and with the JAX package, so
a model file written by any of the three loads in the others:

- ``timespan`` / ``step_size`` are stored in integer microseconds
  (``ModelParameters.cpp:39-40``),
- unbounded entries are stored with the ``±10e30`` sentinel and restored to
  ``±inf`` on load (``ModelParameters.cpp:21-24,66-69``),
- ``dll_filepath`` points at the compiled artifact (unused by this package).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional, Sequence

# The reference writes ±10e30 (== 1e31) for unbounded entries and restores
# ±inf on load (ModelParameters.cpp:21-24,66-69).
INF_SENTINEL = 10e30


def _to_sentinel(vals: Sequence[float]) -> List[float]:
    out = []
    for v in vals:
        if math.isinf(v):
            out.append(INF_SENTINEL if v > 0 else -INF_SENTINEL)
        else:
            out.append(float(v))
    return out


def _from_sentinel(vals: Sequence[float]) -> List[float]:
    out = []
    for v in vals:
        if v >= INF_SENTINEL:
            out.append(math.inf)
        elif v <= -INF_SENTINEL:
            out.append(-math.inf)
        else:
            out.append(float(v))
    return out


@dataclasses.dataclass
class ModelParameters:
    """Canonical problem-shape config (reference ``ModelParameters.hpp:11-28``).

    ``step_size`` is in seconds.  ``timespan`` is derived as
    ``step_size * num_shooting_nodes`` (``ModelParameters.cpp:19``).
    Empty bounds default to unbounded (``ModelParameters.cpp:21-24``).
    """

    name: str
    num_x: int
    num_u: int
    step_size: float  # seconds
    num_shooting_nodes: int
    is_linear: bool = False
    u_min: List[float] = dataclasses.field(default_factory=list)
    u_max: List[float] = dataclasses.field(default_factory=list)
    x_min: List[float] = dataclasses.field(default_factory=list)
    x_max: List[float] = dataclasses.field(default_factory=list)
    dll_filepath: str = ""
    integrator: str = "euler"  # "euler" (reference parity) or "rk4"
    # Extension fields (absent in reference files): which registered dynamics
    # family this model uses, so ModelControl can rebuild the solve when no
    # compiled artifact is present (the reference instead dlopens the .so).
    dynamics_name: str = ""
    dynamics_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.x_min:
            self.x_min = [-math.inf] * self.num_x
        if not self.x_max:
            self.x_max = [math.inf] * self.num_x
        if not self.u_min:
            self.u_min = [-math.inf] * self.num_u
        if not self.u_max:
            self.u_max = [math.inf] * self.num_u

    @property
    def timespan(self) -> float:
        return self.step_size * self.num_shooting_nodes

    @property
    def nv(self) -> int:
        """Size of the multiple-shooting decision vector
        ``nx*(N+1) + nu*N`` (reference ``ModelGenerator.cpp:61``)."""
        return self.num_x * (self.num_shooting_nodes + 1) + self.num_u * self.num_shooting_nodes

    @property
    def num_params(self) -> int:
        """Size of the flat runtime parameter vector ``traj``
        (reference ``ModelGenerator.cpp:129-143``)."""
        n = self.num_shooting_nodes * self.num_x  # desired trajectory
        n += self.num_x + 2 * self.num_u  # Q, R, Rm diagonals
        if self.is_linear:
            n += self.num_x * self.num_x  # A
            n += self.num_x * self.num_u  # B
            n += 2 * self.num_x  # x_dot_init, x_init
        n += self.num_u  # u_init
        return n

    # -- JSON round trip (schema of ModelParameters.cpp:37-72) ---------------

    def to_json_dict(self) -> dict:
        return {
            "name": self.name,
            "timespan": int(round(self.timespan * 1e6)),
            "step_size": int(round(self.step_size * 1e6)),
            "num_x": self.num_x,
            "num_u": self.num_u,
            "num_shooting_nodes": self.num_shooting_nodes,
            "x_min": _to_sentinel(self.x_min),
            "u_min": _to_sentinel(self.u_min),
            "x_max": _to_sentinel(self.x_max),
            "u_max": _to_sentinel(self.u_max),
            "dll_filepath": self.dll_filepath,
            "is_linear": self.is_linear,
            # Extension fields (absent in reference files; defaulted on load).
            "integrator": self.integrator,
            "dynamics_name": self.dynamics_name,
            "dynamics_kwargs": self.dynamics_kwargs,
        }

    @classmethod
    def from_json_dict(cls, j: dict) -> "ModelParameters":
        p = cls(
            name=j["name"],
            num_x=int(j["num_x"]),
            num_u=int(j["num_u"]),
            step_size=float(j["step_size"]) / 1e6,
            num_shooting_nodes=int(j["num_shooting_nodes"]),
            is_linear=bool(j["is_linear"]),
            u_min=_from_sentinel(j["u_min"]),
            u_max=_from_sentinel(j["u_max"]),
            x_min=_from_sentinel(j["x_min"]),
            x_max=_from_sentinel(j["x_max"]),
            dll_filepath=j.get("dll_filepath", ""),
            integrator=j.get("integrator", "euler"),
            dynamics_name=j.get("dynamics_name", ""),
            dynamics_kwargs=j.get("dynamics_kwargs", {}),
        )
        return p

    def save(self, directory: str | Path = ".") -> Path:
        """Write ``<name>.json`` wrapped under the ``model`` key, exactly like
        ``ModelGenerator::save_param_file`` (``ModelGenerator.cpp:261-270``)."""
        path = Path(directory) / f"{self.name}.json"
        with open(path, "w") as f:
            json.dump({"model": self.to_json_dict()}, f, indent=2)
        return path

    @classmethod
    def load(cls, model_name: str, directory: str | Path = ".") -> "ModelParameters":
        """Read ``<name>.json`` (``ModelControl.cpp:21-26``)."""
        path = Path(directory) / f"{model_name}.json"
        with open(path) as f:
            j = json.load(f)
        return cls.from_json_dict(j["model"])


@dataclasses.dataclass
class SolverOptions:
    """Solver configuration (reference hard-codes IPOPT tol 1e-5, max_iter 200,
    mumps, silent — ``ModelControl.cpp:52-59``).  Ours configures the batched
    SQP/interior-point solver instead."""

    tol: float = 1e-5            # KKT tolerance (parity: ipopt.tol 1e-5)
    max_iter: int = 200          # outer iteration cap (parity: ipopt.max_iter)
    max_inner_iter: int = 0      # reserved
    linesearch_steps: int = 12   # backtracking halvings per iteration
    mu_init: float = 1e-1        # initial barrier parameter (bounded problems)
    mu_min: float = 1e-9
    kappa_mu: float = 0.2        # barrier decrease factor
    # KKT backend of the lanes solver (solver.riccati.resolve_kkt_backend):
    # "auto" = the Riccati kernel (solver/riccati_kernel.py) for batched
    # solves on a CUDA device, the scan everywhere else.  Explicit values:
    # "riccati" (scan) | "dense" | "pallas" (the kernel; its plain version
    # on CPU tensors).  The fused kernel does its own block Riccati
    # recursion and ignores it.
    kkt_backend: str = "auto"
    # Stage-Jacobian formulation of the lanes solver: "auto"/"fan" = one
    # unit-tangent JVP per input direction; "rev" = nq VJP rows (Euler step,
    # second-order models).
    linearize_mode: str = "auto"
    dtype: str = "float32"
    # Warm re-solves restart the barrier at factor*tol (clamped to the
    # mu >= max(mu_min, 0.1*tol) floor).  0.1 starts warm solves AT the
    # floor, skipping barrier continuation entirely.
    warm_mu_factor: float = 0.1
    # When > 0, the batch service's warm re-solves run exactly this many
    # SQP iterations at fixed barrier and regularization (the fused
    # kernel's fixed mode); 0 runs them adaptive to tolerance.  Cold solves
    # always run adaptive.
    fixed_warm_iters: int = 0
    # Which program serves (warm) solves (resolution: solver/select.py).
    # "auto" = the fused SQP kernel (solver/fused.py) on a CUDA device when
    # the problem is supported, the lanes SQP (solver/batched.py) otherwise;
    # "fused" forces the fused solve on any device (the plain PyTorch
    # version on CPU); "fixed"/"adaptive" name the lanes SQP.
    warm_solver: str = "auto"
    # Pin the first k controls of each solve to their warm-start values
    # (reference ``m_num_control_inputs_saved``: intended at
    # ``ModelControl.cpp:165-171`` but a no-op there since the field is never
    # set, ``ModelControl.hpp:79``.  Here it works: the solver freezes
    # du_0..du_{k-1} = 0, so already-committed controls are not re-planned.)
    num_control_inputs_saved: int = 0


@dataclasses.dataclass
class TrajectoryParameters:
    """Trajectory-library generation shape config
    (reference ``ModelParameters.hpp:30-41``)."""

    name: str
    num_x: int
    num_u: int
    step_size: float
    num_shooting_nodes: int

    @property
    def timespan(self) -> float:
        return self.step_size * self.num_shooting_nodes
