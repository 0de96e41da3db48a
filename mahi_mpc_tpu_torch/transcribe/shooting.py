"""Direct multiple-shooting transcription (port of
``mahi_mpc_tpu/transcribe/shooting.py``).

The reference NLP (``src/Mahi/Mpc/ModelGenerator.cpp``): continuity
constraints ``c_k = F(x_k, u_k) - x_{k+1} = 0`` with ``F`` the forward-Euler
step (``:206``, ``:33-34``) or the frozen LTV step (``:47-48``), and cost
``J = sum_k e_k' Q e_k + du_k' R du_k + u_k' Rm u_k`` with ``e_k = F(x_k,
u_k) - x_des_k`` and ``du_0 = u_0 - u_prev`` (``:210-221``).  Functions act
on one instance, ``X (N+1, nx)`` and ``U (N, nu)``, as in the JAX package;
``torch.func.vmap`` batches them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..models.base import Dynamics
from ..models.integrators import make_step
from ..params import ModelParameters

Tensor = torch.Tensor


class LinPoint(NamedTuple):
    """Per-solve linearization point for LTV mode
    (``ModelControl.cpp:125-135``)."""

    A: Tensor       # (nx, nx)
    B: Tensor       # (nx, nu)
    x_dot0: Tensor  # (nx,)
    x0: Tensor      # (nx,)
    u0: Tensor      # (nu,)


class MPCParams(NamedTuple):
    """Everything that can change between solves: the same fields, in the
    same order, as the JAX package's ``MPCParams``, so either package's
    ``state_dict`` loads in the other.  A batch puts B in front of every
    shape."""

    x_des: Tensor   # (N, nx) desired trajectory
    q: Tensor       # (nx,)  tracking weight diagonal
    r: Tensor       # (nu,)  input-rate weight diagonal
    rm: Tensor      # (nu,)  input-magnitude weight diagonal
    u_prev: Tensor  # (nu,)  previous control (du_0 anchor)
    x0: Tensor      # (nx,)  measured state, pinned at node 0
    u_min: Tensor   # (nu,)
    u_max: Tensor   # (nu,)
    x_min: Tensor   # (nx,)
    x_max: Tensor   # (nx,)
    lin: LinPoint   # linearization point (used only when is_linear)
    qf: Tensor      # (nx,) terminal weight (extension; 0 = reference)
    xf_des: Tensor  # (nx,) terminal target


def default_params(mp: ModelParameters, dtype=torch.float32,
                   device="cpu") -> MPCParams:
    nx, nu, N = mp.num_x, mp.num_u, mp.num_shooting_nodes
    kw = dict(dtype=dtype, device=device)
    vec = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), **kw)
    return MPCParams(
        x_des=torch.zeros((N, nx), **kw),
        q=torch.ones(nx, **kw), r=torch.ones(nu, **kw),
        rm=torch.ones(nu, **kw),
        u_prev=torch.zeros(nu, **kw), x0=torch.zeros(nx, **kw),
        u_min=vec(mp.u_min), u_max=vec(mp.u_max),
        x_min=vec(mp.x_min), x_max=vec(mp.x_max),
        lin=LinPoint(torch.zeros((nx, nx), **kw), torch.zeros((nx, nu), **kw),
                     torch.zeros(nx, **kw), torch.zeros(nx, **kw),
                     torch.zeros(nu, **kw)),
        qf=torch.zeros(nx, **kw), xf_des=torch.zeros(nx, **kw),
    )


@dataclasses.dataclass(frozen=True)
class ShootingProblem:
    """Static problem description: shapes + discretized dynamics."""

    dynamics: Dynamics
    N: int
    dt: float
    is_linear: bool = False
    integrator: str = "euler"

    @property
    def nx(self) -> int:
        return self.dynamics.nx

    @property
    def nu(self) -> int:
        return self.dynamics.nu

    @property
    def nv(self) -> int:
        return self.nx * (self.N + 1) + self.nu * self.N

    def step(self, x: Tensor, u: Tensor, p: MPCParams) -> Tensor:
        """One shooting step ``F(x_k, u_k)`` (``ModelGenerator.cpp:33-34`` /
        linear ``:47-48``)."""
        if self.is_linear:
            lp = p.lin
            f = lambda x_, u_: self.dynamics.linear_f(
                x_, u_, lp.A, lp.B, lp.x_dot0, lp.x0, lp.u0)
        else:
            f = self.dynamics.f
        return make_step(f, self.dt, self.integrator)(x, u)

    def rollout(self, x0: Tensor, U: Tensor, p: MPCParams) -> Tensor:
        """Propagate the discrete dynamics open-loop: X (N+1, nx)."""
        xs = [x0]
        for k in range(U.shape[0]):
            xs.append(self.step(xs[-1], U[k], p))
        return torch.stack(xs, dim=0)

    def _next_states(self, X: Tensor, U: Tensor, p: MPCParams) -> Tensor:
        return vmap(lambda x, u: self.step(x, u, p))(X[:-1], U)

    def defects(self, X: Tensor, U: Tensor, p: MPCParams) -> Tensor:
        """Continuity residuals ``F(x_k,u_k) - x_{k+1}``, (N, nx)
        (``ModelGenerator.cpp:206``)."""
        return self._next_states(X, U, p) - X[1:]

    def cost(self, X: Tensor, U: Tensor, p: MPCParams) -> Tensor:
        """The reference objective (``ModelGenerator.cpp:210-221``), tracking
        measured on the propagated state F(x_k, u_k)."""
        e = self._next_states(X, U, p) - p.x_des
        j_track = torch.sum((e * e) @ p.q)
        du = torch.diff(U, dim=0, prepend=p.u_prev[None])
        j_rate = torch.sum((du * du) @ p.r)
        j_mag = torch.sum((U * U) @ p.rm)
        ef = X[-1] - p.xf_des
        return j_track + j_rate + j_mag + (ef * ef) @ p.qf


def make_problem(mp: ModelParameters, dynamics: Dynamics) -> ShootingProblem:
    """Build a ShootingProblem from a ModelParameters config."""
    if mp.num_x != dynamics.nx or mp.num_u != dynamics.nu:
        raise ValueError(
            f"model '{dynamics.name}' has nx={dynamics.nx}, nu={dynamics.nu}; "
            f"params say {mp.num_x}, {mp.num_u}")
    return ShootingProblem(dynamics=dynamics, N=mp.num_shooting_nodes,
                           dt=mp.step_size, is_linear=mp.is_linear,
                           integrator=mp.integrator)
