"""Parallel-in-time Riccati: the LQR solve as log-depth scans (port of
``mahi_mpc_tpu/solver/pariccati.py``).

The backward Riccati recursion of ``riccati.py`` has O(N) depth.  Here the
KKT solve is two inclusive scans of O(log N) depth instead.  Eliminating
du_k from the stage KKT conditions leaves the two-point ("scattering")
relation per stage

    dz_{k+1} = Ã dz_k - C̃ λ_{k+1} + ĉ
    λ_k      = Q̃ dz_k + Ã' λ_{k+1} + q̃

with Ã = A - B R⁻¹ M', C̃ = B R⁻¹ B', Q̃ = Q - M R⁻¹ M',
ĉ = c - B R⁻¹ r_u, q̃ = q - M R⁻¹ r_u  (R = Huu, M = Hzu, Q = Hzz,
q = gz, r_u = gu, c = defect).  Such relations compose by the Redheffer
star product, which is associative, so the suffix products against the
terminal element (λ_N = Hf dz_N + gf) give every cost-to-go gradient
λ_k = S_k dz_k + s_k in one reverse scan; the forward rollout
dz_{k+1} = F_k dz_k + g_k is a second scan, of affine maps.

PyTorch has no associative scan, so ``inclusive_scan`` is one of its own:
Hillis–Steele doubling, each level one batched combine over every stage
pair ``d`` apart.  It combines only pairs that exist, so a horizon that is
not a power of two needs no padding.  Every tensor takes any leading batch
dims in front of the stage axis, as ``solve_lqr_scan`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..ops.linalg import cho_solve_small, chol_small
from ..ops.precision import strict_fp32
from .riccati import LQRSolution, register_backend
from .stage_qp import StageQP

Tensor = torch.Tensor


class _Element(NamedTuple):
    """One scattering element: z_out = A z + B lam' + e; lam = C z + D lam' + f.
    Matrices (..., nz, nz), vectors (..., nz)."""
    A: Tensor
    B: Tensor
    C: Tensor
    D: Tensor
    e: Tensor
    f: Tensor


def _mv(A: Tensor, v: Tensor) -> Tensor:
    """(..., a, b) @ (..., b) -> (..., a)."""
    return (A @ v[..., None])[..., 0]


def solve_small(A: Tensor, b: Tensor) -> Tensor:
    """Solve the general (not symmetric) small systems A x = b, A
    (..., n, n), b (..., n, k); LU with partial pivoting, as the JAX
    package's ``solve_small``, without the host sync that checking for a
    singular A would take (a singular A gives inf or NaN)."""
    return torch.linalg.solve_ex(A, b)[0]


def combine(e1: _Element, e2: _Element) -> _Element:
    """Redheffer star product e1 ⋆ e2 (e1 is the earlier stage), any
    broadcastable leading dims.  Associative."""
    n = e1.A.shape[-1]
    # G = (I - C2 B1)^{-1}: in the LQR instance C2 is PSD and B1 = -C̃ is
    # NSD, so I - C2 B1 = I + C2 C̃ is nonsingular.  One factorization
    # serves the three right-hand sides.
    M = torch.eye(n, dtype=e1.A.dtype, device=e1.A.device) - e2.C @ e1.B
    mix = _mv(e2.C, e1.e) + e2.f
    lead = M.shape[:-2]
    G = solve_small(M, torch.cat([t.expand(lead + t.shape[-2:]) for t in (
        e2.C @ e1.A, e2.D, mix[..., None])], dim=-1))
    G_C2A1, G_D2, G_mix = G[..., :n], G[..., n:2 * n], G[..., 2 * n]
    A12 = e2.A @ (e1.A + e1.B @ G_C2A1)
    B12 = e2.A @ (e1.B @ G_D2) + e2.B
    C12 = e1.C + e1.D @ G_C2A1
    D12 = e1.D @ G_D2
    e12 = _mv(e2.A, e1.e + _mv(e1.B, G_mix)) + e2.e
    f12 = e1.f + _mv(e1.D, G_mix)
    return _Element(A12, B12, C12, D12, e12, f12)


class Affine(NamedTuple):
    """The affine map x -> F x + g."""
    F: Tensor
    g: Tensor


def affine_combine(m1: Affine, m2: Affine) -> Affine:
    """Compose affine maps, m1 earlier: x -> F2 (F1 x + g1) + g2."""
    return Affine(m2.F @ m1.F, _mv(m2.F, m1.g) + m2.g)


def inclusive_scan(fn: Callable, elems: NamedTuple, reverse: bool = False
                   ) -> NamedTuple:
    """Inclusive scan of the associative ``fn(earlier, later)`` over the
    leading axis of every field of ``elems`` (a NamedTuple of tensors):
    out[k] = e_0 ⋆ ... ⋆ e_k, or with ``reverse`` the suffix products
    out[k] = e_k ⋆ ... ⋆ e_{n-1}.  Hillis–Steele: ceil(log2 n) levels, each
    one call of ``fn`` on the n - d pairs (k, k + d)."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        head = type(elems)(*[a[:n - d] for a in elems])
        tail = type(elems)(*[a[d:] for a in elems])
        both = fn(head, tail)
        if reverse:   # out[k] = out[k] ⋆ out[k + d] for k < n - d
            elems = type(elems)(*[torch.cat([c, a[n - d:]])
                                  for c, a in zip(both, elems)])
        else:         # out[k] = out[k - d] ⋆ out[k] for k >= d
            elems = type(elems)(*[torch.cat([a[:d], c])
                                  for c, a in zip(both, elems)])
        d *= 2
    return elems


class _Eliminated(NamedTuple):
    """The stages with du eliminated, stage axis leading (N, ..., ...)."""
    Rinv_Mt: Tensor   # R⁻¹ M'   (N, ..., nu, nz)
    Rinv_Bt: Tensor   # R⁻¹ B'   (N, ..., nu, nz)
    Rinv_ru: Tensor   # R⁻¹ r_u  (N, ..., nu)
    elems: _Element   # A = Ã, B = -C̃, C = Q̃, D = Ã', e = ĉ, f = q̃
    Ct: Tensor        # C̃


def stage_leading(qp: StageQP) -> StageQP:
    """Move the stage axis of the per-stage fields to the front (any
    leading batch behind it); Hf, gf stay as they are."""
    mats = ("Az", "Bz", "Hzz", "Hzu", "Huu")
    vecs = ("r", "gz", "gu")
    return qp._replace(**{k: getattr(qp, k).movedim(-3, 0) for k in mats},
                       **{k: getattr(qp, k).movedim(-2, 0) for k in vecs})


def eliminate(qp: StageQP) -> _Eliminated:
    """Per-stage elimination of du, vectorized over stages; ``qp`` stage
    leading (``stage_leading``)."""
    L = chol_small(qp.Huu)
    Rinv_Mt = cho_solve_small(L, qp.Hzu.mT)
    Rinv_Bt = cho_solve_small(L, qp.Bz.mT)
    Rinv_ru = cho_solve_small(L, qp.gu)
    At = qp.Az - qp.Bz @ Rinv_Mt
    Ct = qp.Bz @ Rinv_Bt
    Qt = qp.Hzz - qp.Hzu @ Rinv_Mt
    ct = qp.r - _mv(qp.Bz, Rinv_ru)
    qt = qp.gz - _mv(qp.Hzu, Rinv_ru)
    elems = _Element(A=At, B=-Ct, C=Qt, D=At.mT, e=ct, f=qt)
    return _Eliminated(Rinv_Mt, Rinv_Bt, Rinv_ru, elems, Ct)


def forward_maps(el: _Eliminated, S_next: Tensor, s_next: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """The rollout's affine maps dz_{k+1} = F_k dz_k + g_k from the next
    stage's cost-to-go (S_{k+1}, s_{k+1})."""
    nz = S_next.shape[-1]
    I = torch.eye(nz, dtype=S_next.dtype, device=S_next.device)
    M_fwd = I + el.Ct @ S_next
    rhs = torch.cat([el.elems.A,
                     (el.elems.e - _mv(el.Ct, s_next))[..., None]], dim=-1)
    Fg = solve_small(M_fwd, rhs)
    return Fg[..., :nz], Fg[..., nz]


def recover_du(el: _Eliminated, dz_here: Tensor, lam_next: Tensor) -> Tensor:
    """du_k = -(R⁻¹ M' dz_k + R⁻¹ B' lam_{k+1} + R⁻¹ r_u), stage leading."""
    return -(_mv(el.Rinv_Mt, dz_here) + _mv(el.Rinv_Bt, lam_next)
             + el.Rinv_ru)


@strict_fp32()
def solve_lqr_parallel(qp: StageQP) -> LQRSolution:
    """O(log N)-depth LQR solve; the interface and results of
    ``solve_lqr_scan``, for any leading batch."""
    ql = stage_leading(qp)
    el = eliminate(ql)
    # Terminal element: lam_N = Hf z_N + gf.
    zero = torch.zeros_like(qp.Hf)
    term = _Element(A=zero, B=zero, C=qp.Hf, D=zero,
                    e=torch.zeros_like(qp.gf), f=qp.gf)
    elems = _Element(*[torch.cat([a, t[None]]) for a, t in zip(el.elems,
                                                               term)])

    # Suffix products: suffix[k] = e_k ⋆ e_{k+1} ⋆ ... ⋆ e_N, so
    # lam_k = S_k z_k + s_k with S = C_suffix, s = f_suffix.
    suffix = inclusive_scan(combine, elems, reverse=True)
    S, s = suffix.C, suffix.f                       # (N+1, ..., nz[, nz])

    # Forward affine rollout dz_{k+1} = F_k dz_k + g_k, dz_0 = 0.
    F, g = forward_maps(el, S[1:], s[1:])
    gc = inclusive_scan(affine_combine, Affine(F, g)).g
    dz = torch.cat([torch.zeros_like(gc[:1]), gc])  # (N+1, ..., nz)

    lam = _mv(S, dz) + s
    du = recover_du(el, dz[:-1], lam[1:])
    lam = torch.cat([torch.zeros_like(lam[:1]), lam[1:]])  # node 0 pinned
    return LQRSolution(dz=dz.movedim(0, -2), du=du.movedim(0, -2),
                       lam=lam.movedim(0, -2))


register_backend("pariccati", solve_lqr_parallel)
