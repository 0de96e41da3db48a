"""Riccati (block-tridiagonal KKT) solve of LQR subproblems (port of
``mahi_mpc_tpu/solver/riccati.py``).

The multiple-shooting KKT matrix is stage-banded, so a backward Riccati
sweep and a forward rollout solve it exactly in O(N (nz+nu)^3).
``solve_lqr_scan`` does so for any leading batch, as a Python loop over
the N stages of batched small products; ``solve_lqr_dense`` forms the whole
KKT system and solves it directly — the tests' oracle.  Batched solves on a
CUDA card go to the hand-written kernel of ``solver/riccati_kernel.py``
(``kkt_backend="pallas"``, the JAX package's name for the kernel route).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg import cho_solve_small, chol_small
from ..ops.precision import strict_fp32
from .stage_qp import StageQP

Tensor = torch.Tensor


class LQRSolution(NamedTuple):
    dz: Tensor     # (N+1, nz) state deltas (dz_0 = 0: node 0 is pinned)
    du: Tensor     # (N, nu) control deltas
    lam: Tensor    # (N+1, nz) multiplier estimates (value-function gradients)


def _mv(A: Tensor, v: Tensor) -> Tensor:
    """(..., a, b) @ (..., b) -> (..., a)."""
    return (A @ v[..., None])[..., 0]


def _riccati_sweep(qp: StageQP, chol) -> LQRSolution:
    """Backward Riccati recursion + forward substitution for any leading
    batch, with ``chol`` the factorization of Quu (the scan and the
    kernel's plain version differ only there)."""
    N = qp.Az.shape[-3]
    P, pvec = qp.Hf, qp.gf
    Ks: list = [None] * N
    kffs: list = [None] * N
    for k in reversed(range(N)):
        Az, Bz, r = qp.Az[..., k, :, :], qp.Bz[..., k, :, :], qp.r[..., k, :]
        Pr_p = pvec + _mv(P, r)
        AtP = Az.mT @ P
        Qzz = qp.Hzz[..., k, :, :] + AtP @ Az
        Qzu = qp.Hzu[..., k, :, :] + AtP @ Bz
        Quu = qp.Huu[..., k, :, :] + Bz.mT @ P @ Bz
        qz = qp.gz[..., k, :] + _mv(Az.mT, Pr_p)
        qu = qp.gu[..., k, :] + _mv(Bz.mT, Pr_p)
        L = chol(Quu)
        K = -cho_solve_small(L, Qzu.mT)      # (..., nu, nz)
        kff = -cho_solve_small(L, qu)        # (..., nu)
        P = Qzz + Qzu @ K
        P = 0.5 * (P + P.mT)
        pvec = qz + _mv(Qzu, kff)
        Ks[k], kffs[k] = K, kff

    dz = torch.zeros_like(qp.gf)
    dzs, dus = [dz], []
    for k in range(N):
        du = _mv(Ks[k], dz) + kffs[k]
        dz = (_mv(qp.Az[..., k, :, :], dz) + _mv(qp.Bz[..., k, :, :], du)
              + qp.r[..., k, :])
        dus.append(du)
        dzs.append(dz)
    dz_all = torch.stack(dzs, dim=-2)
    du_all = torch.stack(dus, dim=-2)
    return LQRSolution(dz=dz_all, du=du_all,
                       lam=_multipliers(qp, dz_all, du_all))


@strict_fp32()
def solve_lqr_scan(qp: StageQP) -> LQRSolution:
    """Backward Riccati recursion + forward substitution, batched over any
    leading dims of the QP's fields; Quu is factored by ``chol_small``."""
    return _riccati_sweep(qp, chol_small)


def _multipliers(qp: StageQP, dz: Tensor, du: Tensor) -> Tensor:
    """Adjoint recursion for the continuity duals: lam_N = Hf dz_N + gf and,
    for 1 <= k < N, lam_k = Hzz_k dz_k + Hzu_k du_k + gz_k + Az_k' lam_{k+1};
    lam_0 = 0 (node 0 is pinned).  Any leading batch."""
    N = qp.Az.shape[-3]
    lam = _mv(qp.Hf, dz[..., N, :]) + qp.gf
    lams = [lam]
    for k in reversed(range(1, N)):
        lam = (_mv(qp.Hzz[..., k, :, :], dz[..., k, :])
               + _mv(qp.Hzu[..., k, :, :], du[..., k, :]) + qp.gz[..., k, :]
               + _mv(qp.Az[..., k, :, :].mT, lam))
        lams.append(lam)
    lams.append(torch.zeros_like(lam))
    return torch.stack(lams[::-1], dim=-2)


@strict_fp32()
def solve_lqr_dense(qp: StageQP) -> LQRSolution:
    """Oracle: assemble the full KKT system over w = [du_0..du_{N-1},
    dz_1..dz_N] with equality constraints dz_{k+1} = Az dz_k + Bz du_k + r
    and solve it densely (``torch.linalg.solve``), for any leading batch."""
    N, nz, nu = qp.Az.shape[-3], qp.Az.shape[-2], qp.Bz.shape[-1]
    lead = qp.gf.shape[:-1]
    nw = N * nu + N * nz     # unknowns (dz_0 = 0 eliminated)
    nc = N * nz              # constraints
    kw = dict(dtype=qp.gf.dtype, device=qp.gf.device)
    uix = lambda k: k * nu
    zix = lambda k: N * nu + (k - 1) * nz   # dz_k for k >= 1
    at = lambda t, k: t[..., k, :, :]

    K = torch.zeros(lead + (nw + nc, nw + nc), **kw)
    rhs = torch.zeros(lead + (nw + nc,), **kw)
    H, g = K[..., :nw, :nw], rhs[..., :nw]
    H[..., :nu, :nu] += at(qp.Huu, 0)     # k = 0: dz_0 = 0
    g[..., :nu] += qp.gu[..., 0, :]
    for k in range(1, N):
        zi, ui = zix(k), uix(k)
        H[..., zi:zi + nz, zi:zi + nz] += at(qp.Hzz, k)
        H[..., zi:zi + nz, ui:ui + nu] += at(qp.Hzu, k)
        H[..., ui:ui + nu, zi:zi + nz] += at(qp.Hzu, k).mT
        H[..., ui:ui + nu, ui:ui + nu] += at(qp.Huu, k)
        g[..., zi:zi + nz] += qp.gz[..., k, :]
        g[..., ui:ui + nu] += qp.gu[..., k, :]
    zi = zix(N)
    H[..., zi:zi + nz, zi:zi + nz] += qp.Hf
    g[..., zi:zi + nz] += qp.gf
    rhs[..., :nw] = -g

    C = K[..., nw:, :nw]
    for k in range(N):
        row = k * nz
        C[..., row:row + nz, uix(k):uix(k) + nu] = at(qp.Bz, k)
        if k >= 1:
            C[..., row:row + nz, zix(k):zix(k) + nz] = at(qp.Az, k)
        C[..., row:row + nz, zix(k + 1):zix(k + 1) + nz] = -torch.eye(nz, **kw)
        rhs[..., nw + row:nw + row + nz] = -qp.r[..., k, :]
    K[..., :nw, nw:] = C.mT

    sol = torch.linalg.solve(K, rhs)
    zero = torch.zeros(lead + (1, nz), **kw)
    du = sol[..., :N * nu].reshape(lead + (N, nu))
    dz = torch.cat([zero, sol[..., N * nu:nw].reshape(lead + (N, nz))], dim=-2)
    lam = torch.cat([zero, sol[..., nw:].reshape(lead + (N, nz))], dim=-2)
    return LQRSolution(dz=dz, du=du, lam=lam)


_BACKENDS = {}


def resolve_kkt_backend(backend: str, batched: bool = False, dims=None,
                        device="cpu") -> str:
    """Resolve ``"auto"``: the hand-written Riccati kernel
    (``"pallas"``) for *batched* solves on a CUDA device, when the kernel is
    built for the stage shape ``dims = (N, nz, nu)``; the scan
    (``"riccati"``) everywhere else — the JAX package's rule, with the
    device in place of the TPU backend.  The kernel keeps its QP in global
    memory, so it has no horizon limit."""
    if backend != "auto":
        return backend
    if batched and torch.device(device).type == "cuda":
        if dims is not None:
            from .riccati_kernel import kkt_kernel_supported
            if not kkt_kernel_supported(dims[1], dims[2]):
                return "riccati"
        return "pallas"
    return "riccati"


def solve_lqr(qp: StageQP, backend: str = "riccati") -> LQRSolution:
    """Solve one LQR subproblem, or a batch of them (leading dims), with
    the named backend."""
    backend = resolve_kkt_backend(backend, batched=False)
    if backend == "riccati":
        return solve_lqr_scan(qp)
    if backend == "dense":
        return solve_lqr_dense(qp)
    if backend == "pallas":
        from .riccati_kernel import solve_lqr_kernel_batch
        lead = qp.gf.shape[:-1]
        flat = StageQP(*[a.reshape((-1,) + a.shape[len(lead):]) for a in qp])
        sol = solve_lqr_kernel_batch(flat)
        return LQRSolution(*[a.reshape(lead + a.shape[1:]) for a in sol])
    if backend in _BACKENDS:
        return _BACKENDS[backend](qp)
    raise ValueError(f"unknown KKT backend {backend!r}")


def register_backend(name: str, fn) -> None:
    """Register an additional LQR backend."""
    _BACKENDS[name] = fn
