"""Direct multiple-shooting transcription (port of
``mahi_mpc_tpu/transcribe/shooting.py``).

The reference NLP (``src/Mahi/Mpc/ModelGenerator.cpp``): continuity
constraints ``c_k = F(x_k, u_k) - x_{k+1} = 0`` with ``F`` the forward-Euler
step (``:206``, ``:33-34``) or the frozen LTV step (``:47-48``), and cost
``J = sum_k e_k' Q e_k + du_k' R du_k + u_k' Rm u_k`` with ``e_k = F(x_k,
u_k) - x_des_k`` and ``du_0 = u_0 - u_prev`` (``:210-221``).  Functions act
on one instance, ``X (N+1, nx)`` and ``U (N, nu)``, as in the JAX package;
``torch.func.vmap`` batches them.  ``pack_ref_params`` /
``unpack_ref_params`` and ``pack_v`` / ``unpack_v`` / ``bounds_v`` are the
exact adapters to the reference's flat parameter and decision vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

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


def map_params(fn: Callable[[Tensor], Tensor], p: MPCParams) -> MPCParams:
    """Apply ``fn`` to every tensor of ``p``, the linearization point's
    included."""
    return MPCParams(*[LinPoint(*[fn(a) for a in f]) if isinstance(f, LinPoint)
                       else fn(f) for f in p])


def check_device(device, who: str) -> None:
    """Raise when ``device`` is a CUDA device and this process has none:
    the port's entry points run on the card unless asked for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} puts its tensors on a CUDA device by default and none "
            "is available; pass device=\"cpu\" to run on the CPU")


def default_params(mp: ModelParameters, dtype=torch.float32,
                   device="cuda") -> MPCParams:
    """The problem's default parameters on ``device``: the card unless the
    caller asks for another device (``device="cpu"``); raises when the
    card is asked for and there is none."""
    check_device(device, "default_params")
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

    def cost_separable(self, X: Tensor, U: Tensor, p: MPCParams) -> Tensor:
        """The cost with tracking measured on ``x_{k+1}`` instead of
        ``F(x_k, u_k)``: equal on the constraint manifold (so at every KKT
        point), and quadratic in (X, U), which the Riccati step exploits."""
        e = X[1:] - p.x_des
        j_track = torch.sum((e * e) @ p.q)
        du = torch.diff(U, dim=0, prepend=p.u_prev[None])
        j_rate = torch.sum((du * du) @ p.r)
        j_mag = torch.sum((U * U) @ p.rm)
        ef = X[-1] - p.xf_des
        return j_track + j_rate + j_mag + (ef * ef) @ p.qf

    def linearize_stages(self, X: Tensor, U: Tensor, p: MPCParams
                         ) -> Tuple[Tensor, Tensor, Tensor]:
        """Stagewise discrete Jacobians ``A_k = dF/dx`` (N, nx, nx),
        ``B_k = dF/du`` (N, nx, nu) at each ``(x_k, u_k)`` and the defects
        ``c_k`` (N, nx): ``jacfwd`` through ``step``, vmapped over the
        horizon, for any ``Dynamics``."""
        nx = self.nx
        if self.dynamics.supports_lanes and not self.is_linear:
            # A trailing batch of one keeps intermediates 1-D: forward-mode
            # AD promotes a 0-d float32 tangent times a python float to
            # float64.
            step = lambda x, u: self.step(x[:, None], u[:, None], p)[:, 0]
        else:
            step = lambda x, u: self.step(x, u, p)
        joint = lambda w: step(w[:nx], w[nx:])

        def one(x, u, xn_target):
            w = torch.cat([x, u])
            J = jacfwd(joint)(w)
            return J[:, :nx], J[:, nx:], joint(w) - xn_target

        A, B, c = vmap(one)(X[:-1], U, X[1:])
        # A model written on 0-d components still hands back float64
        # tangents; the Jacobians take the iterate's dtype.
        return A.to(X.dtype), B.to(X.dtype), c

    # -- flat-vector adapters (oracle comparison) ----------------------------

    def pack_v(self, X: Tensor, U: Tensor) -> Tensor:
        """Interleave to the reference layout [x_0, u_0, ..., x_N]
        (``ModelGenerator.cpp:86-112``)."""
        head = torch.cat([X[:-1], U], dim=1).reshape(-1)
        return torch.cat([head, X[-1]])

    def unpack_v(self, v: Tensor) -> Tuple[Tensor, Tensor]:
        nx, nu, N = self.nx, self.nu, self.N
        body = v[:N * (nx + nu)].reshape(N, nx + nu)
        X = torch.cat([body[:, :nx], v[None, N * (nx + nu):]], dim=0)
        return X, body[:, nx:]

    def pack_ref_params(self, p: MPCParams) -> Tensor:
        """Flatten to the reference runtime parameter vector
        (``ModelGenerator.cpp:129-187``, ``ModelControl.cpp:120-136``):
        [x_des (N*nx) | Qdiag | Rdiag | Rmdiag |
         (linear: A col-major | B col-major | x_dot0 | x0) | u_prev]."""
        parts = [p.x_des.reshape(-1), p.q, p.r, p.rm]
        if self.is_linear:
            # CasADi's reshape is column-major.
            parts += [p.lin.A.T.reshape(-1), p.lin.B.T.reshape(-1),
                      p.lin.x_dot0, p.lin.x0]
        parts.append(p.u_prev)
        return torch.cat(parts)

    def unpack_ref_params(self, traj: Tensor, base: MPCParams) -> MPCParams:
        nx, nu, N = self.nx, self.nu, self.N
        i = N * nx
        x_des = traj[:i].reshape(N, nx)
        q, r = traj[i:i + nx], traj[i + nx:i + nx + nu]
        rm = traj[i + nx + nu:i + nx + 2 * nu]
        i += nx + 2 * nu
        lin = base.lin
        if self.is_linear:
            A = traj[i:i + nx * nx].reshape(nx, nx).T
            i += nx * nx
            B = traj[i:i + nx * nu].reshape(nu, nx).T
            i += nx * nu
            x_dot0, x0l = traj[i:i + nx], traj[i + nx:i + 2 * nx]
            i += 2 * nx
            lin = LinPoint(A, B, x_dot0, x0l, traj[i:i + nu])
        u_prev = traj[i:i + nu]
        return base._replace(x_des=x_des, q=q, r=r, rm=rm, u_prev=u_prev,
                             lin=lin._replace(u0=u_prev) if self.is_linear
                             else lin)

    def bounds_v(self, p: MPCParams) -> Tuple[Tensor, Tensor]:
        """Decision-vector bounds in the flat layout: node 0 pinched to the
        measurement (``ModelControl.cpp:144-145``), controls at the limits
        (``:148-154``), every other state at the state bounds
        (``:37-50``)."""
        N = self.N
        xs_min = torch.cat([p.x0[None], p.x_min.expand(N, self.nx)])
        xs_max = torch.cat([p.x0[None], p.x_max.expand(N, self.nx)])
        return (self.pack_v(xs_min, p.u_min.expand(N, self.nu)),
                self.pack_v(xs_max, p.u_max.expand(N, self.nu)))


def make_problem(mp: ModelParameters, dynamics: Dynamics) -> ShootingProblem:
    """Build a ShootingProblem from a ModelParameters config."""
    if mp.num_x != dynamics.nx or mp.num_u != dynamics.nu:
        raise ValueError(
            f"model '{dynamics.name}' has nx={dynamics.nx}, nu={dynamics.nu}; "
            f"params say {mp.num_x}, {mp.num_u}")
    return ShootingProblem(dynamics=dynamics, N=mp.num_shooting_nodes,
                           dt=mp.step_size, is_linear=mp.is_linear,
                           integrator=mp.integrator)
