"""Offline trajectory-library generation (port of
``mahi_mpc_tpu/trajgen/generator.py``).

Completes what the reference's WIP (non-compiling) ``TrajectoryGenerator``
started (``src/Mahi/Mpc/TrajectoryGenerator.cpp:23-220``): read a waypoint
list (CSV), solve a point-to-point trajectory optimization for every
consecutive waypoint pair (minimum-effort ``sum u'u`` cost with endpoint
equality; the reference pinned both endpoints through ``lbx = ubx``,
``TrajectoryGenerator.cpp:72-82``), and write the resulting (t, x, u)
library back to CSV.

All segments are one batch: each segment is an instance of the same
multiple-shooting problem, solved together by ``solve_batch`` (the JAX
package's ``jax.vmap(solve)``).  The terminal equality is enforced by an
augmented-Lagrangian outer loop on the terminal cost (qf / xf_des of
``MPCParams``): quadratic penalty rho plus a multiplier shift, warm-started
between rounds, which drives ``|x_N - goal|`` to tolerance in a few rounds
while every inner solve stays the standard SQP.  ``opts.kkt_backend``
passes through: ``"pallas"`` solves each KKT system with the Riccati
kernel on the card.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.base import Dynamics
from ..params import ModelParameters, SolverOptions, TrajectoryParameters
from ..solver.sqp import solve_batch
from ..transcribe.shooting import default_params, make_problem, map_params


@dataclasses.dataclass
class TrajectorySegment:
    """One waypoint-to-waypoint solve result."""
    times: np.ndarray   # (N+1,)
    X: np.ndarray       # (N+1, nx)
    U: np.ndarray       # (N, nu)
    endpoint_err: float
    status: int


class TrajectoryGenerator:
    """Batched point-to-point trajectory library generator.

    waypoints: (W, nx) array of states (typically [q, 0] rest-to-rest).
    Each consecutive pair becomes a segment of ``num_shooting_nodes`` steps
    of ``step_size``.  Solves run on ``device``: the CUDA card unless told
    otherwise (``"cpu"`` runs the plain PyTorch versions).  After
    ``generate``, ``rounds`` holds the augmented-Lagrangian rounds it took
    and ``iters`` (rounds, segments) the SQP iterations of each.
    """

    def __init__(self, params: TrajectoryParameters | ModelParameters,
                 dynamics: Dynamics,
                 opts: SolverOptions = SolverOptions(),
                 u_min: Optional[Sequence[float]] = None,
                 u_max: Optional[Sequence[float]] = None,
                 effort_weight: float = 1.0,
                 rate_weight: float = 0.01,
                 al_rounds: int = 6,
                 rho: float = 1e3,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TrajectoryGenerator runs on a CUDA device by default and "
                "none is available; pass device=\"cpu\" to run on the CPU")
        self.device = device
        self.tp = params
        mp = ModelParameters(
            name=getattr(params, "name", "trajgen"),
            num_x=params.num_x, num_u=params.num_u,
            step_size=params.step_size,
            num_shooting_nodes=params.num_shooting_nodes,
            u_min=list(u_min) if u_min is not None else [],
            u_max=list(u_max) if u_max is not None else [],
            integrator=getattr(params, "integrator", "rk4"))
        self.mp = mp
        self.dynamics = dynamics
        self.opts = opts
        self.effort_weight = effort_weight
        self.rate_weight = rate_weight
        self.al_rounds = al_rounds
        self.rho = rho
        self.problem = make_problem(mp, dynamics)
        self.rounds = 0
        self.iters = np.zeros((0, 0), dtype=np.int64)

    def problem_batch(self, waypoints: np.ndarray):
        """The batch that ``generate`` solves: one instance a segment, its
        params (no tracking cost, rate and effort weights, the terminal
        penalty on the goal) and the straight-line warm start (X0, U0)."""
        wps = np.asarray(waypoints, float)
        if wps.ndim != 2 or wps.shape[1] != self.mp.num_x:
            raise ValueError(
                f"waypoints must be (W, {self.mp.num_x}), got {wps.shape}")
        S = wps.shape[0] - 1
        if S < 1:
            raise ValueError("need at least two waypoints")
        nx, nu, N = self.problem.nx, self.problem.nu, self.problem.N
        kw = dict(dtype=getattr(torch, self.opts.dtype), device=self.device)

        starts = torch.as_tensor(wps[:-1], **kw)
        goals = torch.as_tensor(wps[1:], **kw)

        p = default_params(self.mp, **kw)
        p = p._replace(
            q=torch.zeros(nx, **kw),                        # no tracking cost
            r=torch.full((nu,), self.rate_weight, **kw),    # smoothness
            rm=torch.full((nu,), self.effort_weight, **kw))  # min effort
        pb = map_params(lambda a: a.expand((S,) + a.shape), p)
        pb = pb._replace(
            x0=starts,
            xf_des=goals,
            qf=torch.full((S, nx), self.rho, **kw),
            # x_des only matters through q=0: keep goals for readability
            x_des=goals[:, None, :].expand(S, N, nx))

        # Warm start: straight-line interpolation between endpoints.
        alpha = torch.linspace(0.0, 1.0, N + 1, **kw)[None, :, None]
        X = (1 - alpha) * starts[:, None, :] + alpha * goals[:, None, :]
        U = torch.zeros((S, N, nu), **kw)
        return pb, X, U

    def generate(self, waypoints: np.ndarray) -> list[TrajectorySegment]:
        """Solve all segments as one batch with an augmented-Lagrangian
        outer loop on the endpoint constraint."""
        prob, mp = self.problem, self.mp
        pb, X, U = self.problem_batch(waypoints)
        goals = pb.xf_des
        S, N = X.shape[0], prob.N

        lam = torch.zeros_like(goals)
        res = None
        iters = []
        for _ in range(self.al_rounds):
            # AL shift: qf ||x_N - (goal - lam/(2 qf))||^2 == lam' c + qf||c||^2
            pb_i = pb._replace(xf_des=goals - lam / (2.0 * self.rho))
            res = solve_batch(prob, pb_i, X, U, self.opts)
            iters.append(res.iters.cpu().numpy())
            X, U = res.X, res.U
            c = X[:, -1, :] - goals
            lam = lam + 2.0 * self.rho * c
            if float(torch.max(torch.abs(c))) < 10.0 * self.opts.tol:
                break
        self.rounds = len(iters)
        self.iters = np.stack(iters)

        times = np.arange(N + 1) * mp.step_size
        Xh, Uh = res.X.cpu().numpy(), res.U.cpu().numpy()
        err = torch.amax(torch.abs(res.X[:, -1] - goals), dim=1).cpu().numpy()
        status = res.status.cpu().numpy()
        return [TrajectorySegment(times=times.copy(), X=Xh[s], U=Uh[s],
                                  endpoint_err=float(err[s]),
                                  status=int(status[s]))
                for s in range(S)]

    # -- CSV round trip (reference csv_read_rows/csv_write_row,
    #    TrajectoryGenerator.cpp:198-205) -----------------------------------

    def generate_from_csv(self, waypoint_csv: str | Path,
                          out_csv: str | Path) -> list[TrajectorySegment]:
        wps = load_waypoints_csv(waypoint_csv, self.mp.num_x)
        segs = self.generate(wps)
        write_library_csv(out_csv, segs, self.mp)
        return segs


def load_waypoints_csv(path: str | Path, nx: int) -> np.ndarray:
    """Waypoint CSV: one row per waypoint, nx columns (header optional)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            try:
                rows.append([float(v) for v in parts[:nx]])
            except ValueError:
                continue  # header
    return np.asarray(rows, float)


def write_library_csv(path: str | Path, segs: Sequence[TrajectorySegment],
                      mp: ModelParameters) -> None:
    """Library CSV: segment, t, x..., u... (u blank on the terminal node)."""
    nx, nu = mp.num_x, mp.num_u
    with open(path, "w") as f:
        hdr = (["segment", "t"] + [f"x{i}" for i in range(nx)]
               + [f"u{i}" for i in range(nu)])
        f.write(",".join(hdr) + "\n")
        for s, seg in enumerate(segs):
            for k in range(seg.X.shape[0]):
                u = seg.U[k] if k < seg.U.shape[0] else [""] * nu
                row = ([str(s), f"{seg.times[k]:.9g}"]
                       + [f"{v:.9g}" for v in seg.X[k]]
                       + [f"{v:.9g}" if v != "" else "" for v in u])
                f.write(",".join(row) + "\n")


def read_library_csv(path: str | Path, nx: int, nu: int
                     ) -> list[TrajectorySegment]:
    """Inverse of `write_library_csv`."""
    per_seg = collections.defaultdict(lambda: ([], [], []))
    with open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.rstrip("\n").split(",")
            s = int(parts[0])
            t = float(parts[1])
            x = [float(v) for v in parts[2:2 + nx]]
            u_raw = parts[2 + nx:2 + nx + nu]
            ts, xs, us = per_seg[s]
            ts.append(t)
            xs.append(x)
            if u_raw and u_raw[0] != "":
                us.append([float(v) for v in u_raw])
    out = []
    for s in sorted(per_seg):
        ts, xs, us = per_seg[s]
        out.append(TrajectorySegment(
            times=np.asarray(ts), X=np.asarray(xs), U=np.asarray(us),
            endpoint_err=float("nan"), status=0))
    return out
