"""Serial-manipulator dynamics (port of ``mahi_mpc_tpu/models/arm.py``).

Forward kinematics, the explicit geometric-Jacobian mass matrix, the
recursive Newton-Euler bias ``h(q, qd) = C(q, qd) qd + grav(q)`` and
``qdd = M(q)^{-1} (tau - h - damping qd)``, all in the component-leading,
trailing-batch tensor form of the JAX package: ``f((nx, ...), (nu, ...)) ->
(nx, ...)``.  The same chain is written once more in CUDA C++ for the fused
kernel (``csrc/arm_dynamics.cuh``); ``arm_constants`` hands it the chain
constants as plain floats.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..ops.linalg import spd_solve_lanes
from .base import Dynamics, register

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One revolute joint + rigid link.

    axis: joint rotation axis, unit 3-vector in the parent frame.
    offset: translation from the parent joint to this joint, in the parent
        link frame (applied before the joint rotation).
    com: center-of-mass position in this link's frame.
    mass: link mass (kg).
    inertia: principal rotational inertia about the COM, in the link frame
        (3-vector diagonal).
    """

    axis: Tuple[float, float, float]
    offset: Tuple[float, float, float]
    com: Tuple[float, float, float]
    mass: float
    inertia: Tuple[float, float, float]


def _const(a, like: Tensor, shape) -> Tensor:
    """A static numpy constant as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                           device=like.device).reshape(shape)


def _rodrigues(axis, angle: Tensor) -> Tensor:
    """Rotation about a unit axis: angle (...) gives R (3, 3, ...)."""
    kx, ky, kz = (float(v) for v in axis)
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])
    ext = (3, 3) + (1,) * angle.dim()
    return (_const(np.eye(3), angle, ext)
            + torch.sin(angle) * _const(K, angle, ext)
            + (1.0 - torch.cos(angle)) * _const(K @ K, angle, ext))


def _mm3(A: Tensor, B: Tensor) -> Tensor:
    """(3,3,...) @ (3,3,...) as broadcast-multiply-reduce."""
    return torch.sum(A[:, :, None] * B[None, :, :], dim=1)


def _mv3(A: Tensor, b) -> Tensor:
    """(3,3,...) @ (3[,...]); a numpy ``b`` is a static 3-vector."""
    if isinstance(b, np.ndarray):
        return torch.sum(A * _const(b, A, (1, 3) + (1,) * (A.dim() - 2)),
                         dim=1)
    return torch.sum(A * b[None], dim=1)


def _cross3(a: Tensor, b: Tensor) -> Tensor:
    """Cross product of (3, ...) vectors along dim 0."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]], dim=0)


def make_serial_arm(name: str, links: List[LinkSpec],
                    g: float = 9.81, gravity_dir=(0.0, 0.0, -1.0),
                    joint_damping: float = 0.0) -> Dynamics:
    n = len(links)
    axes = np.array([l.axis for l in links], dtype=np.float64)
    offsets = np.array([l.offset for l in links], dtype=np.float64)
    coms = np.array([l.com for l in links], dtype=np.float64)
    masses = np.array([l.mass for l in links], dtype=np.float64)
    inertias = np.array([l.inertia for l in links], dtype=np.float64)
    gvec = g * np.array(gravity_dir, dtype=np.float64)

    def fk_full(q: Tensor):
        """World-frame joint origins o_i, joint axes z_i, COM positions c_i
        and rotations R_i: q (n, ...) gives lists of (3, ...) / (3, 3, ...)."""
        S = q.shape[1:]
        R = _const(np.eye(3), q, (3, 3) + (1,) * len(S)).expand((3, 3) + S)
        p = q.new_zeros((3,) + S)
        os_, zs, cs, Rs = [], [], [], []
        for i in range(n):
            p = p + _mv3(R, offsets[i])
            z = _mv3(R, axes[i])     # joint axis is fixed in the parent frame
            R = _mm3(R, _rodrigues(axes[i], q[i]))
            os_.append(p)
            zs.append(z)
            cs.append(p + _mv3(R, coms[i]))
            Rs.append(R)
        return os_, zs, cs, Rs

    def fk(q: Tensor) -> Tuple[Tensor, Tensor]:
        """COM world positions (n,3[,...]) and link rotations (n,3,3[,...])."""
        _, _, cs, Rs = fk_full(q)
        return torch.stack(cs), torch.stack(Rs)

    def _iw(Ri: Tensor, i: int) -> Tensor:
        """World-frame link inertia R diag(I) R'."""
        S = Ri.shape[2:]
        return _mm3(Ri * _const(inertias[i], Ri, (1, 3) + (1,) * len(S)),
                    Ri.transpose(0, 1))

    def _mass_and_gravity(q: Tensor, with_g: bool = True
                          ) -> Tuple[Tensor, Tensor]:
        """M = sum_i m_i Jv_i' Jv_i + Jw_i' (R_i I_i R_i') Jw_i and
        G_j = -sum_i m_i gvec . Jv_i[:, j]."""
        o, z, c, R = fk_full(q)
        S = q.shape[1:]
        zero3 = q.new_zeros((3,) + S)
        gv = _const(gvec, q, (3,) + (1,) * len(S))
        Mrows = [[None] * n for _ in range(n)]
        G = [q.new_zeros(S) for _ in range(n)]
        for i in range(n):
            Jv = [(_cross3(z[j], c[i] - o[j]) if j <= i else zero3)
                  for j in range(n)]
            Jw = [(z[j] if j <= i else zero3) for j in range(n)]
            Iw = _iw(R[i], i)
            IwJw = [_mv3(Iw, Jw[k]) for k in range(n)]
            for a in range(n):
                if with_g:
                    G[a] = G[a] - float(masses[i]) * torch.sum(Jv[a] * gv,
                                                               dim=0)
                for b in range(a, n):
                    contrib = (float(masses[i]) * torch.sum(Jv[a] * Jv[b], dim=0)
                               + torch.sum(Jw[a] * IwJw[b], dim=0))
                    Mrows[a][b] = contrib if Mrows[a][b] is None \
                        else Mrows[a][b] + contrib
        for a in range(n):
            for b in range(a):
                Mrows[a][b] = Mrows[b][a]
        M = torch.stack([torch.stack(row, dim=0) for row in Mrows], dim=0)
        return M, torch.stack(G, dim=0)

    def mass_matrix(q: Tensor) -> Tensor:
        return _mass_and_gravity(q)[0]

    def bias(q: Tensor, qd: Tensor) -> Tensor:
        """h(q, qd) = C(q, qd) qd + grav(q) by recursive Newton-Euler with
        qdd = 0 in the world frame; gravity enters as a base acceleration
        of -gvec."""
        o, z, c, R = fk_full(q)
        S = q.shape[1:]
        zero3 = q.new_zeros((3,) + S)
        w_prev, al_prev = zero3, zero3
        a_prev = _const(-gvec, q, (3,) + (1,) * len(S)).expand((3,) + S)
        o_prev = zero3
        ws, als, acs = [], [], []
        for i in range(n):
            d = o[i] - o_prev                  # segment rigid in link i-1
            a_oi = (a_prev + _cross3(al_prev, d)
                    + _cross3(w_prev, _cross3(w_prev, d)))
            w_i = w_prev + z[i] * qd[i]
            al_i = al_prev + _cross3(w_prev, z[i] * qd[i])
            rc = c[i] - o[i]                   # COM offset rigid in link i
            a_ci = (a_oi + _cross3(al_i, rc)
                    + _cross3(w_i, _cross3(w_i, rc)))
            ws.append(w_i)
            als.append(al_i)
            acs.append(a_ci)
            w_prev, al_prev, a_prev, o_prev = w_i, al_i, a_oi, o[i]

        taus: list = [None] * n
        f_child = zero3
        n_child = zero3
        o_child = o[n - 1]                     # placeholder, f_child = 0
        for i in reversed(range(n)):
            Iw = _iw(R[i], i)
            F_i = float(masses[i]) * acs[i]
            N_i = _mv3(Iw, als[i]) + _cross3(ws[i], _mv3(Iw, ws[i]))
            n_i = (N_i + _cross3(c[i] - o[i], F_i)
                   + n_child + _cross3(o_child - o[i], f_child))
            f_i = F_i + f_child
            taus[i] = torch.sum(z[i] * n_i, dim=0)
            f_child, n_child, o_child = f_i, n_i, o[i]
        return torch.stack(taus, dim=0)

    def f(x: Tensor, u: Tensor) -> Tensor:
        q, qd = x[:n], x[n:]
        M, _ = _mass_and_gravity(q, with_g=False)
        h = bias(q, qd)
        qdd = spd_solve_lanes(M, u - h - joint_damping * qd)
        return torch.cat([qd, qdd], dim=0)

    dyn = Dynamics(name, nx=2 * n, nu=n, f=f, supports_lanes=True, nq=n)
    # Expose internals for tests and the kernel (frozen dataclass).
    object.__setattr__(dyn, "mass_matrix", mass_matrix)
    object.__setattr__(dyn, "bias", bias)
    object.__setattr__(dyn, "fk", fk)
    object.__setattr__(dyn, "chain", {
        "axes": axes, "offsets": offsets, "coms": coms, "masses": masses,
        "inertias": inertias, "neg_g": -gvec,
        "damping": float(joint_damping)})
    return dyn


def arm_constants(dyn: Dynamics) -> dict:
    """The chain constants of a serial arm as plain floats, in the order the
    CUDA kernel's ``ArmConsts`` reads them: axes, offsets, COMs (n x 3
    each), masses (n), inertias (n x 3), -g (3), joint damping."""
    chain = getattr(dyn, "chain", None)
    if chain is None:
        raise ValueError(f"dynamics {dyn.name!r} is not a serial arm")
    out = {k: np.asarray(v, dtype=np.float64).tolist()
           for k, v in chain.items() if k != "damping"}
    out["damping"] = chain["damping"]
    return out


@register("two_link_arm")
def make_two_link_arm(l1: float = 1.0, l2: float = 1.0, m1: float = 1.0,
                      m2: float = 1.0, g: float = 9.81) -> Dynamics:
    """Planar 2-DOF arm in the x-z plane, rotating about y, with uniform-rod
    links (benchmark config #3)."""
    rod = lambda m, l: (m * l * l / 12.0,) * 3
    links = [
        LinkSpec(axis=(0, 1, 0), offset=(0, 0, 0), com=(l1 / 2, 0, 0),
                 mass=m1, inertia=rod(m1, l1)),
        LinkSpec(axis=(0, 1, 0), offset=(l1, 0, 0), com=(l2 / 2, 0, 0),
                 mass=m2, inertia=rod(m2, l2)),
    ]
    return make_serial_arm("two_link_arm", links, g=g)


@register("mahi_arm")
def make_mahi_arm(g: float = 9.81) -> Dynamics:
    """4-DOF MAHI-exoskeleton arm (nx=8, nu=4): elbow flexion, forearm
    pronation/supination, wrist flexion/extension, wrist radial/ulnar
    deviation — the same chain and inertial values as the JAX package's
    ``make_mahi_arm``."""
    links = [
        LinkSpec(axis=(1, 0, 0), offset=(0, 0, 0), com=(0, 0, 0.10),
                 mass=1.5, inertia=(0.010, 0.010, 0.002)),
        LinkSpec(axis=(0, 1, 0), offset=(0, 0, 0.15), com=(0, 0.05, 0),
                 mass=0.5, inertia=(0.002, 0.001, 0.002)),
        LinkSpec(axis=(0, 0, 1), offset=(0, 0, 0), com=(0, 0.03, 0),
                 mass=0.4, inertia=(0.0012, 0.0012, 0.0008)),
        LinkSpec(axis=(0, -1, 0), offset=(0, 0, 0), com=(0, -0.05, 0),
                 mass=0.45, inertia=(0.0012, 0.0006, 0.0012)),
    ]
    return make_serial_arm("mahi_arm", links, g=g, joint_damping=0.05)
