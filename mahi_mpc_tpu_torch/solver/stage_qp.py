"""Stagewise QP construction for the lanes SQP (port of
``mahi_mpc_tpu/solver/stage_qp.py``).

Each SQP iteration linearizes the multiple-shooting NLP into an
equality-constrained LQR problem over the augmented state
``z_k = [x_k ; u_{k-1}]`` (``u_{-1} = u_prev``), which absorbs the
input-rate cost ``(u_k - u_{k-1})' R (u_k - u_{k-1})`` into a stagewise
cost.  Box bounds enter as log-barrier terms, masked where a bound is
infinite.

The JAX package builds one instance's QP and vmaps it; here
``build_stage_qp`` and ``merit`` are written batch-leading for the whole
batch at once (every tensor has the batch B in front).  The lanes solver
hands ``build_stage_qp`` the stage linearization ``lin = (A, B, c)`` it
computed in lanes; without it (``lin=None``, the SQP of ``solver/sqp.py``)
each instance is linearized by ``ShootingProblem.linearize_stages``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from ..transcribe.shooting import MPCParams, ShootingProblem

Tensor = torch.Tensor


class StageQP(NamedTuple):
    """Quantities of one LQR subproblem (leading axis = horizon N unless
    noted; a batch puts B in front of every shape).  Cost convention:
    J(dw) = g' dw + 1/2 dw' H dw."""

    Az: Tensor   # (N, nz, nz) augmented dynamics dz_{k+1} = Az dz + Bz du + r
    Bz: Tensor   # (N, nz, nu)
    r: Tensor    # (N, nz)   defects [c_k ; 0]
    Hzz: Tensor  # (N, nz, nz)
    Hzu: Tensor  # (N, nz, nu)
    Huu: Tensor  # (N, nu, nu)
    gz: Tensor   # (N, nz)
    gu: Tensor   # (N, nu)
    Hf: Tensor   # (nz, nz) terminal
    gf: Tensor   # (nz,)


def barrier_terms(v: Tensor, lo: Tensor, hi: Tensor, mu
                  ) -> Tuple[Tensor, Tensor]:
    """Gradient and Hessian diagonal of -mu*[log(v-lo)+log(hi-v)], each side
    masked out where its bound is infinite; elementwise, broadcasting."""
    lo_fin = torch.isfinite(lo)
    hi_fin = torch.isfinite(hi)
    slo = torch.where(lo_fin, v - lo, 1.0)
    shi = torch.where(hi_fin, hi - v, 1.0)
    g = torch.where(lo_fin, -mu / slo, 0.0) + torch.where(hi_fin, mu / shi, 0.0)
    h = (torch.where(lo_fin, mu / (slo * slo), 0.0)
         + torch.where(hi_fin, mu / (shi * shi), 0.0))
    return g, h


def barrier_value(v: Tensor, lo: Tensor, hi: Tensor, mu) -> Tensor:
    """-sum(mu*[log(v-lo)+log(hi-v)]) over the last dim (..., n) -> (...);
    ``mu`` broadcasts against ``v``."""
    lo_fin = torch.isfinite(lo)
    hi_fin = torch.isfinite(hi)
    slo = torch.where(lo_fin, torch.clamp(v - lo, min=1e-30), 1.0)
    shi = torch.where(hi_fin, torch.clamp(hi - v, min=1e-30), 1.0)
    return -torch.sum(mu * (torch.where(lo_fin, torch.log(slo), 0.0)
                            + torch.where(hi_fin, torch.log(shi), 0.0)),
                      dim=-1)


def fraction_to_boundary(v: Tensor, dv: Tensor, lo: Tensor, hi: Tensor,
                         tau: float = 0.995) -> Tensor:
    """Largest step alpha <= 1 keeping v + alpha*dv a fraction tau inside the
    (possibly infinite) box, reduced over the last dim (..., n) -> (...)."""
    lo_fin = torch.isfinite(lo) & (dv < 0)
    hi_fin = torch.isfinite(hi) & (dv > 0)
    a_lo = torch.where(lo_fin,
                       -tau * (v - lo) / torch.where(dv < 0, dv, -1.0), 1.0)
    a_hi = torch.where(hi_fin,
                       tau * (hi - v) / torch.where(dv > 0, dv, 1.0), 1.0)
    return torch.minimum(torch.amin(a_lo, dim=-1), torch.amin(a_hi, dim=-1))


def build_stage_qp(prob: ShootingProblem, X: Tensor, U: Tensor, p: MPCParams,
                   mu: Tensor, reg: Tensor, lin=None,
                   n_pin: int = 0) -> StageQP:
    """Linearize + quadraticize a batch at its iterate.

    X (B, N+1, nx), U (B, N, nu), ``p`` with (B, ...) fields, ``mu`` and
    ``reg`` (B,) (barrier parameter and the Levenberg term added to Huu),
    ``lin = (A (B, N, nx, nx), Bm (B, N, nx, nu), c (B, N, nx))``, or None
    to take it from ``prob.linearize_stages`` instance by instance.

    ``n_pin`` freezes the first ``n_pin`` controls at their iterate values
    (the reference's ``m_num_control_inputs_saved``): pinned stages get
    Bz = 0, Hzu = 0, gu = 0, Huu = I, so every KKT backend returns du_k = 0
    exactly."""
    if lin is None:
        lin = vmap(prob.linearize_stages)(X, U, p)
    nx, nu, N = prob.nx, prob.nu, prob.N
    nz = nx + nu
    Bsz = X.shape[0]
    dtype, device = X.dtype, X.device
    kw = dict(dtype=dtype, device=device)
    A, Bm, c = lin
    ix, iu = torch.arange(nx, device=device), torch.arange(nu, device=device)

    # Augmented dynamics dz_{k+1} = [A dx + B du + c ; du].
    Az = torch.zeros(Bsz, N, nz, nz, **kw)
    Az[..., :nx, :nx] = A
    Bz = torch.zeros(Bsz, N, nz, nu, **kw)
    Bz[..., :nx, :] = Bm
    Bz[..., nx:, :] = torch.eye(nu, **kw)
    r = torch.cat([c, torch.zeros(Bsz, N, nu, **kw)], dim=-1)

    twoQ = (2.0 * p.q)[:, None]        # (B, 1, nx)
    twoR = (2.0 * p.r)[:, None]
    twoRm = (2.0 * p.rm)[:, None]

    # Tracking sits on x_k for k >= 1; stage k holds the x_k term.
    e = X[:, :-1] - torch.cat([X[:, :1], p.x_des[:, :-1]], dim=1)
    track_on = (torch.arange(N, device=device) >= 1).to(dtype)[:, None]
    du = U - torch.cat([p.u_prev[:, None], U[:, :-1]], dim=1)

    mu3 = mu[:, None, None]
    gx_b, hx_b = barrier_terms(X[:, :-1], p.x_min[:, None], p.x_max[:, None],
                               mu3)
    gu_b, hu_b = barrier_terms(U, p.u_min[:, None], p.u_max[:, None], mu3)
    # No barrier on node 0 (pinned to the measurement).
    gx_b = gx_b * track_on
    hx_b = hx_b * track_on

    gz = torch.cat([track_on * (twoQ * e) + gx_b, -(twoR * du)], dim=-1)
    gu = twoR * du + twoRm * U + gu_b

    Hzz = torch.zeros(Bsz, N, nz, nz, **kw)
    Hzz[..., ix, ix] = track_on * twoQ + hx_b
    Hzz[..., nx + iu, nx + iu] = twoR.expand(Bsz, N, nu)
    Hzu = torch.zeros(Bsz, N, nz, nu, **kw)
    Hzu[..., nx + iu, iu] = (-twoR).expand(Bsz, N, nu)
    Huu = torch.zeros(Bsz, N, nu, nu, **kw)
    Huu[..., iu, iu] = twoR + twoRm + hu_b + reg[:, None, None]

    # Terminal: tracking on x_N, the terminal cost qf, the terminal barrier.
    xN = X[:, -1]
    eN = xN - p.x_des[:, -1]
    eF = xN - p.xf_des
    twoQf = 2.0 * p.qf
    gN_b, hN_b = barrier_terms(xN, p.x_min, p.x_max, mu[:, None])
    Hf = torch.zeros(Bsz, nz, nz, **kw)
    Hf[:, ix, ix] = twoQ[:, 0] + twoQf + hN_b
    gf = torch.cat([twoQ[:, 0] * eN + twoQf * eF + gN_b,
                    torch.zeros(Bsz, nu, **kw)], dim=-1)

    if n_pin:
        pin = (torch.arange(N, device=device) < n_pin)[:, None, None]
        Bz = torch.where(pin, 0.0, Bz)
        Hzu = torch.where(pin, 0.0, Hzu)
        gu = torch.where(pin[..., 0], 0.0, gu)
        Huu = torch.where(pin, torch.eye(nu, **kw), Huu)

    return StageQP(Az, Bz, r, Hzz, Hzu, Huu, gz, gu, Hf, gf)


def _cost_separable(X: Tensor, U: Tensor, p: MPCParams) -> Tensor:
    """Reference cost in separable form, per instance: (B,)."""
    e = X[:, 1:] - p.x_des
    j_track = torch.einsum("bni,bi->b", e * e, p.q)
    du = torch.diff(U, dim=1, prepend=p.u_prev[:, None, :])
    j_rate = torch.einsum("bni,bi->b", du * du, p.r)
    j_mag = torch.einsum("bni,bi->b", U * U, p.rm)
    ef = X[:, -1] - p.xf_des
    return j_track + j_rate + j_mag + torch.einsum("bi,bi->b", ef * ef, p.qf)


def merit_smooth(X: Tensor, U: Tensor, p: MPCParams, mu: Tensor) -> Tensor:
    """Cost + barrier, the merit without its l1 defect penalty: (B,)."""
    mu3 = mu[:, None, None]
    bar_x = barrier_value(X[:, 1:], p.x_min[:, None], p.x_max[:, None], mu3)
    bar_u = barrier_value(U, p.u_min[:, None], p.u_max[:, None], mu3)
    return (_cost_separable(X, U, p) + bar_x.sum(dim=1)
            + bar_u.sum(dim=1))


def merit(prob: ShootingProblem, X: Tensor, U: Tensor, p: MPCParams,
          mu: Tensor, nu_pen: Tensor) -> Tensor:
    """l1 merit of the barrier subproblem per instance (B,): separable cost
    + barrier + nu_pen * ||defects||_1, with ``mu`` and ``nu_pen`` (B,);
    the defects from ``prob.defects`` instance by instance."""
    c = vmap(prob.defects)(X, U, p)
    return (merit_smooth(X, U, p, mu)
            + nu_pen * torch.sum(torch.abs(c), dim=(1, 2)))
