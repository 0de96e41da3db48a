"""Plain serial-arm dynamics: x_dot = f(x, u) for a chain of revolute joints.

A frozen copy of the port's ``models/arm.py`` equations, written anew in
batch-leading form (any leading batch, the vector index last) and in any
floating dtype, bfloat16 included: every operation is elementwise or a
small sum, and the mass matrix is solved by a Cholesky factor written out
here.  Forward kinematics, the geometric-Jacobian mass matrix, the
recursive Newton-Euler bias h(q, qd) = C(q, qd) qd + g(q), and
qdd = M(q)^-1 (u - h - damping qd).  The chain's constants come from the
configuration file (``chain``), never from the program.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _mv(R: Tensor, v: Tensor) -> Tensor:
    """(..., 3, 3) times (..., 3)."""
    return (R * v[..., None, :]).sum(-1)


def _mm(A: Tensor, B: Tensor) -> Tensor:
    """(..., 3, 3) times (..., 3, 3)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def chol_solve(M: Tensor, b: Tensor) -> Tensor:
    """Solve M x = b for SPD M (..., n, n), b (..., n)."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


class Arm:
    """The chain of ``chain`` (a configuration's ``chain`` entry: per link
    ``axis``, ``offset``, ``com``, ``mass``, ``inertia``; ``g``,
    ``gravity_dir``, ``damping``) in ``dtype`` on ``device``."""

    def __init__(self, chain: dict, dtype=torch.float64, device="cpu"):
        kw = dict(dtype=dtype, device=device)
        links = chain["links"]
        self.n = len(links)
        self.nx, self.nu = 2 * self.n, self.n
        col = lambda key: torch.tensor([l[key] for l in links], **kw)
        self.axes, self.offsets, self.coms = (col("axis"), col("offset"),
                                              col("com"))
        self.masses, self.inertias = col("mass"), col("inertia")
        self.gvec = float(chain["g"]) * torch.tensor(chain["gravity_dir"],
                                                     **kw)
        self.damping = float(chain["damping"])
        self.eye3 = torch.eye(3, **kw)
        skew = []
        for a in self.axes:
            z = torch.zeros((), **kw)
            skew.append(torch.stack([torch.stack([z, -a[2], a[1]]),
                                     torch.stack([a[2], z, -a[0]]),
                                     torch.stack([-a[1], a[0], z])]))
        self.K = torch.stack(skew)                  # (n, 3, 3)
        self.K2 = self.K @ self.K

    def _fk(self, q: Tensor):
        """Joint origins o_i, axes z_i, COMs c_i (..., 3) and rotations
        R_i (..., 3, 3) in the world frame."""
        S = q.shape[:-1]
        R = self.eye3.expand(S + (3, 3))
        p = q.new_zeros(S + (3,))
        os_, zs, cs, Rs = [], [], [], []
        for i in range(self.n):
            p = p + _mv(R, self.offsets[i])
            z = _mv(R, self.axes[i])
            th = q[..., i, None, None]
            rot = self.eye3 + torch.sin(th) * self.K[i] \
                + (1.0 - torch.cos(th)) * self.K2[i]
            R = _mm(R, rot)
            os_.append(p)
            zs.append(z)
            cs.append(p + _mv(R, self.coms[i]))
            Rs.append(R)
        return os_, zs, cs, Rs

    def _inertia_world(self, R: Tensor, i: int) -> Tensor:
        return _mm(R * self.inertias[i], R.transpose(-1, -2))

    def mass_matrix(self, q: Tensor) -> Tensor:
        o, z, c, R = self._fk(q)
        n = self.n
        M = [[None] * n for _ in range(n)]
        for i in range(n):
            Jv = [_cross(z[j], c[i] - o[j]) for j in range(i + 1)]
            Iw = self._inertia_world(R[i], i)
            IwJw = [_mv(Iw, z[j]) for j in range(i + 1)]
            for a in range(i + 1):
                for b in range(a, i + 1):
                    t = (self.masses[i] * (Jv[a] * Jv[b]).sum(-1)
                         + (z[a] * IwJw[b]).sum(-1))
                    M[a][b] = t if M[a][b] is None else M[a][b] + t
        for a in range(n):
            for b in range(a):
                M[a][b] = M[b][a]
        return torch.stack([torch.stack(row, -1) for row in M], -2)

    def bias(self, q: Tensor, qd: Tensor) -> Tensor:
        """h(q, qd) by Newton-Euler with qdd = 0, gravity as a base
        acceleration of -g."""
        o, z, c, R = self._fk(q)
        zero = q.new_zeros(q.shape[:-1] + (3,))
        w_p, al_p, o_p = zero, zero, zero
        a_p = (-self.gvec).expand_as(zero)
        ws, als, acs = [], [], []
        for i in range(self.n):
            d = o[i] - o_p
            a_o = a_p + _cross(al_p, d) + _cross(w_p, _cross(w_p, d))
            zq = z[i] * qd[..., i, None]
            w = w_p + zq
            al = al_p + _cross(w_p, zq)
            rc = c[i] - o[i]
            ws.append(w)
            als.append(al)
            acs.append(a_o + _cross(al, rc) + _cross(w, _cross(w, rc)))
            w_p, al_p, a_p, o_p = w, al, a_o, o[i]
        tau = [None] * self.n
        f_c, n_c, o_c = zero, zero, o[-1]
        for i in reversed(range(self.n)):
            Iw = self._inertia_world(R[i], i)
            F = self.masses[i] * acs[i]
            Nm = _mv(Iw, als[i]) + _cross(ws[i], _mv(Iw, ws[i]))
            n_i = (Nm + _cross(c[i] - o[i], F) + n_c
                   + _cross(o_c - o[i], f_c))
            tau[i] = (z[i] * n_i).sum(-1)
            f_c, n_c, o_c = F + f_c, n_i, o[i]
        return torch.stack(tau, -1)

    def f(self, x: Tensor, u: Tensor) -> Tensor:
        """x (..., 2n), u (..., n) -> x_dot (..., 2n)."""
        n = self.n
        q, qd = x[..., :n], x[..., n:]
        qdd = chol_solve(self.mass_matrix(q),
                         u - self.bias(q, qd) - self.damping * qd)
        return torch.cat([qd, qdd], -1)

    def jacobians(self, x: Tensor, u: Tensor):
        """(f, df/dx, df/du) at M points: x (M, nx), u (M, nu)."""
        one = lambda a, b: self.f(a[None], b[None])[0]
        A, B = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))(x, u)
        return self.f(x, u), A, B
