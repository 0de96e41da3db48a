"""Unrolled small SPD solves (port of ``mahi_mpc_tpu/ops/linalg.py``).

Two layouts.  The ``*_lanes`` forms take matrices (n, n, ...) with
component indices leading and any batch trailing; every intermediate is a
(...)-shaped tensor.  The ``*_small`` forms take (..., n, n) with the batch
leading, as the scan KKT backend holds its stage blocks.  n is small (the mass
matrix of a serial arm, n <= ~6), so an unrolled Cholesky-Crout is plain
elementwise work — no LAPACK call, and the same arithmetic order as the
CUDA kernel's ``chol``/``cho_solve`` (``csrc/fused_sqp.cuh``).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def chol_lanes(A: Tensor, jitter: float = 0.0) -> Tensor:
    """Lower Cholesky factor of A (n, n, ...)."""
    n = A.shape[0]
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j] + jitter
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        d = torch.sqrt(s)
        rows[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            rows[i][j] = s * inv_d
    zero = torch.zeros_like(A[0, 0])
    return torch.stack([torch.stack(
        [rows[i][j] if j <= i else zero for j in range(n)], dim=0)
        for i in range(n)], dim=0)


def cho_solve_lanes(L: Tensor, b: Tensor) -> Tensor:
    """Solve (L L') x = b: L (n, n, ...), b (n, ...)."""
    n = L.shape[0]
    ys = []
    for i in range(n):
        s = b[i]
        for j in range(i):
            s = s - L[i, j] * ys[j]
        ys.append(s / L[i, i])
    xs: list = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for j in range(i + 1, n):
            s = s - L[j, i] * xs[j]
        xs[i] = s / L[i, i]
    return torch.stack(xs, dim=0)


def spd_solve_lanes(A: Tensor, b: Tensor, jitter: float = 0.0) -> Tensor:
    """Solve A x = b for SPD A in lanes layout (n, n, ...), b (n, ...)."""
    return cho_solve_lanes(chol_lanes(A, jitter), b)


# ---------------------------------------------------------------------------
# Batch-leading forms (``chol_small`` and friends of the JAX package): the
# matrix indices are the last two dims, any batch leads.  The scan KKT
# backend (solver/riccati.py) uses these.
# ---------------------------------------------------------------------------

def chol_small(A: Tensor, jitter: float = 0.0) -> Tensor:
    """Lower Cholesky factor of a small SPD matrix A (..., n, n), unrolled
    Crout; a pivot that is not positive gives NaN, as ``jnp.sqrt`` does."""
    n = A.shape[-1]
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j] + jitter
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        d = torch.sqrt(s)
        rows[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            rows[i][j] = s * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack(
        [rows[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)], dim=-2)


def tri_solve_lower(L: Tensor, b: Tensor) -> Tensor:
    """Solve L y = b for lower-triangular L (..., n, n) by forward
    substitution; b is (..., n) or (..., n, k)."""
    n = L.shape[-1]
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    ys = []
    for i in range(n):
        s = b[..., i, :]
        for j in range(i):
            s = s - L[..., i, j, None] * ys[j]
        ys.append(s / L[..., i, i, None])
    y = torch.stack(ys, dim=-2)
    return y[..., 0] if vec else y


def tri_solve_upper_t(L: Tensor, y: Tensor) -> Tensor:
    """Solve L' x = y (back substitution on the transpose of lower L)."""
    n = L.shape[-1]
    vec = y.dim() == L.dim() - 1
    if vec:
        y = y[..., None]
    xs: list = [None] * n
    for i in reversed(range(n)):
        s = y[..., i, :]
        for j in range(i + 1, n):
            s = s - L[..., j, i, None] * xs[j]
        xs[i] = s / L[..., i, i, None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def cho_solve_small(L: Tensor, b: Tensor) -> Tensor:
    """Solve (L L') x = b given the factor from ``chol_small``."""
    return tri_solve_upper_t(L, tri_solve_lower(L, b))


def spd_solve_small(A: Tensor, b: Tensor, jitter: float = 0.0) -> Tensor:
    """Solve A x = b for small SPD A (..., n, n) without LAPACK."""
    return cho_solve_small(chol_small(A, jitter), b)
