"""Plain barrier SQP of the fused solve, batch-leading, in any dtype.

A frozen copy of the algorithm of the port's ``solver/fused.py``
(``_solve`` and ``_solve_batch_fused_plain``) and of the policies of
``solver/loop_common.py``, written anew without the kernel's summation
order: per SQP iteration, linearize the discrete step at every stage,
build the stage QP with log-barrier box terms and a control-rate term,
solve it by a block Riccati recursion over the state and the previous
control, roll the step out with the fraction-to-boundary cap, and take the
first rung of a fan that passes Armijo on the l1 merit.  Fixed mode runs
exactly ``n_iter`` iterations at a fixed barrier; adaptive mode adds the
barrier continuation, the regularisation ladder and the per-instance
status, and stops an instance once it is done.

``step`` is the discrete model in increment form: ``step.inc(x, u)`` gives
F(x, u) - x at any leading shape, ``step.linearize(xs, us)`` gives the
increment and its Jacobians (A - I, B) at (M, N) stages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

LS_FAN_FIXED = (1.0, 0.5, 0.25, 0.0625)
LS_FAN_ADAPTIVE = (1.0, 0.5, 0.25, 0.0625, 0.015625, 0.00390625,
                   0.0009765625, 0.000244140625)
ARMIJO_SLOPE = 1e-4
NOISE_FLOOR_MULT = 10.0
REG_GROW, REG_GROW_ABS, REG_SHRINK = 10.0, 1e-6, 0.25
REG_MIN, REG_DIVERGED = 1e-8, 1e8
INNER_MU_MULT = 10.0
FTB_TAU = 0.995
CONVERGED, MAX_ITER, DIVERGED = 0, 1, 2


class Params(NamedTuple):
    """One batch of problem data, (M, ...) each."""
    x0: Tensor
    u_prev: Tensor
    x_des: Tensor       # (M, N, nx)
    q: Tensor
    r: Tensor
    rm: Tensor
    qf: Tensor
    xf_des: Tensor
    u_min: Tensor
    u_max: Tensor
    x_min: Tensor
    x_max: Tensor


class Result(NamedTuple):
    X: Tensor
    U: Tensor
    status: Tensor
    iters: Tensor


def mu_floor(tol: float, mu_min: float) -> float:
    return max(mu_min, 0.1 * tol)


def _barrier(v, lo, hi, mu):
    """Gradient and Hessian diagonal of -mu [log(v - lo) + log(hi - v)]."""
    lf, hf = torch.isfinite(lo), torch.isfinite(hi)
    slo = torch.where(lf, v - lo, 1.0)
    shi = torch.where(hf, hi - v, 1.0)
    g = torch.where(lf, -mu / slo, 0.0) + torch.where(hf, mu / shi, 0.0)
    h = (torch.where(lf, mu / (slo * slo), 0.0)
         + torch.where(hf, mu / (shi * shi), 0.0))
    return g, h


def _barrier_value(v, lo, hi, mu):
    lf, hf = torch.isfinite(lo), torch.isfinite(hi)
    slo = torch.where(lf, torch.clamp(v - lo, min=1e-30), 1.0)
    shi = torch.where(hf, torch.clamp(hi - v, min=1e-30), 1.0)
    return -(mu * (torch.where(lf, torch.log(slo), 0.0)
                   + torch.where(hf, torch.log(shi), 0.0))).sum(-1)


def _ftb(v, dv, lo, hi, amax):
    """The largest step in (0, amax] that keeps v + a dv a fraction
    FTB_TAU of the way to each bound."""
    neg, pos = dv < 0, dv > 0
    a_lo = torch.where(torch.isfinite(lo) & neg,
                       (-FTB_TAU * (v - lo)) / torch.where(neg, dv, -1.0), 1.0)
    a_hi = torch.where(torch.isfinite(hi) & pos,
                       (FTB_TAU * (hi - v)) / torch.where(pos, dv, 1.0), 1.0)
    return torch.minimum(amax, torch.minimum(a_lo, a_hi).amin(-1))


def _chol(A: Tensor) -> list:
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    return L


def _cho_solve(L: list, Y: Tensor) -> Tensor:
    """Solve (L L') X = Y for Y (..., n, C)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = Y[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    return torch.stack(x, -2)


def _mv(A: Tensor, v: Tensor) -> Tensor:
    return (A @ v[..., None])[..., 0]


def strict_interior(v, lo, hi, delta=1e-3):
    inf = torch.full_like(lo, float("inf"))
    width = torch.where(torch.isfinite(lo) & torch.isfinite(hi), hi - lo, inf)
    d = torch.clamp(0.25 * width, max=delta)
    lo_c = torch.where(torch.isfinite(lo), lo + d, -inf)
    hi_c = torch.where(torch.isfinite(hi), hi - d, inf)
    return torch.minimum(torch.maximum(v, lo_c), hi_c)


def sqp(step, p: Params, X: Tensor, U: Tensor, mu: Tensor, n_iter: int,
        fan, adaptive: bool, tol: float, mu_min: float, kappa: float):
    """The SQP from (X, U); returns X, U and the per-instance (stepn, feas,
    done, iters) of its last iteration."""
    M, N, nx = X.shape[0], X.shape[1] - 1, X.shape[2]
    nu = U.shape[2]
    nz = nx + nu
    dtype, device = X.dtype, X.device
    floor = mu_floor(tol, mu_min)
    full = lambda v: torch.full((M,), v, dtype=dtype, device=device)
    fan_t = torch.as_tensor(fan, dtype=dtype, device=device)
    eye_x = torch.eye(nx, dtype=dtype, device=device)
    q, r, rm, qf = p.q, p.r, p.rm, p.qf
    q2, r2, rm2, qf2 = 2 * q, 2 * r, 2 * rm, 2 * qf
    xlo, xhi = p.x_min[:, None], p.x_max[:, None]
    ulo, uhi = p.u_min[:, None], p.u_max[:, None]
    xdes = p.x_des
    xdes_prev = torch.cat([xdes[:, :1], xdes[:, :-1]], 1)
    tk = (torch.arange(N, device=device) >= 1)[:, None]         # (N, 1)

    def stage_cost(x, u, du, e, mu_b, w):
        """Stage cost with barriers, and its rate part; ``w`` lifts a
        (M, n) weight to x's shape."""
        rate = (w(r) * du * du + w(rm) * u * u).sum(-1)
        c = torch.where(tk[..., 0], (w(q) * e * e).sum(-1)
                        + _barrier_value(x, w(p.x_min), w(p.x_max), mu_b), 0.0)
        c = c + _barrier_value(u, w(p.u_min), w(p.u_max), mu_b)
        return c + rate, rate

    X, U = X.clone(), U.clone()
    reg, nu_pen = full(REG_MIN), full(1.0)
    done, iters = full(0.0), full(0.0)
    stepn = feas = full(float("inf"))
    for _ in range(n_iter):
        live = done < 0.5
        if adaptive and not bool(live.any()):
            break
        if not adaptive:
            live = torch.ones_like(live)
        mu3 = mu[:, None, None]
        xs = X[:, :N]
        inc, AmI, Bm = step.linearize(xs, U)
        A = eye_x + AmI
        ck = (xs - X[:, 1:]) + inc
        ukm1 = torch.cat([p.u_prev[:, None], U[:, :-1]], 1)
        e = xs - xdes_prev
        du = U - ukm1
        gx_b, hx_b = _barrier(xs, xlo, xhi, mu3)
        gu_b, hu_b = _barrier(U, ulo, uhi, mu3)
        gzx = torch.where(tk, q2[:, None] * e + gx_b, 0.0)
        gzv = -(r2[:, None] * du)
        gu = r2[:, None] * du + rm2[:, None] * U + gu_b
        Dx = torch.where(tk, q2[:, None] + hx_b, 0.0)
        Du = (r2 + rm2)[:, None] + hu_b + reg[:, None, None]
        w3 = lambda t: t[:, None]
        sc, _ = stage_cost(xs, U, du, e, mu[:, None, None], w3)

        xN = X[:, N]
        eN, eF = xN - xdes[:, N - 1], xN - p.xf_des
        gN_b, hN_b = _barrier(xN, p.x_min, p.x_max, mu[:, None])
        Pxx = torch.diag_embed(q2 + qf2 + hN_b)
        Pxv = torch.zeros(M, nx, nu, dtype=dtype, device=device)
        Pvv = torch.zeros(M, nu, nu, dtype=dtype, device=device)
        px = q2 * eN + qf2 * eF + gN_b
        pv = torch.zeros(M, nu, dtype=dtype, device=device)
        G_N = px
        cost0 = (_barrier_value(xN, p.x_min, p.x_max, mu[:, None])
                 + (q * eN * eN + qf * eF * eF).sum(-1) + sc.sum(-1))
        feas_i = ck.abs().amax(dim=(1, 2))
        c_l1 = ck.abs().sum(dim=(1, 2))
        pmax = px.abs().amax(-1)

        K = torch.empty(M, N, nu, nz, dtype=dtype, device=device)
        kff = torch.empty(M, N, nu, dtype=dtype, device=device)
        eye_r2 = torch.diag_embed(r2)
        for k in reversed(range(N)):
            Ak, Bk, ckk = A[:, k], Bm[:, k], ck[:, k]
            Prp_x = px + _mv(Pxx, ckk)
            Prp_v = pv + _mv(Pxv.mT, ckk)
            PxxB = Pxx @ Bk
            Qxx = Ak.mT @ Pxx @ Ak
            Qxx = 0.5 * (Qxx + Qxx.mT) + torch.diag_embed(Dx[:, k])
            Qxu = Ak.mT @ (PxxB + Pxv)
            BtPxv = Bk.mT @ Pxv
            Quu = (Bk.mT @ PxxB + BtPxv + BtPxv.mT + Pvv
                   + torch.diag_embed(Du[:, k]))
            qz_x = gzx[:, k] + _mv(Ak.mT, Prp_x)
            qu = gu[:, k] + _mv(Bk.mT, Prp_x) + Prp_v
            rhs = torch.cat([-Qxu.mT, eye_r2, -qu[..., None]], -1)
            Y = _cho_solve(_chol(Quu), rhs)
            Kx, Kv, kf = Y[..., :nx], Y[..., nx:nz], Y[..., nz]
            Pxx = Qxx + Qxu @ Kx
            Pxx = 0.5 * (Pxx + Pxx.mT)
            Pxv = 0.5 * (Qxu @ Kv - r2[:, None, :] * Kx.mT)
            RK = r2[:, :, None] * Kv
            Pvv = -0.5 * (RK + RK.mT) + eye_r2
            px = qz_x + _mv(Qxu, kf)
            pv = gzv[:, k] - r2 * kf
            K[:, k], kff[:, k] = Y[..., :nz], kf
            pmax = torch.maximum(pmax, torch.maximum(px.abs().amax(-1),
                                                     pv.abs().amax(-1)))
        nu_pen_new = torch.maximum(nu_pen, 2.0 * pmax + 1.0)
        m0 = cost0 + nu_pen_new * c_l1

        dX = torch.zeros_like(X)
        dU = torch.empty_like(U)
        dx = torch.zeros(M, nx, dtype=dtype, device=device)
        dv = torch.zeros(M, nu, dtype=dtype, device=device)
        amax, ddir, stepn_i = full(1.0), full(0.0), full(0.0)
        for k in range(N):
            du_k = _mv(K[:, k], torch.cat([dx, dv], -1)) + kff[:, k]
            ddir = ddir + (gzx[:, k] * dx).sum(-1) + (gzv[:, k] * dv).sum(-1) \
                + (gu[:, k] * du_k).sum(-1)
            dxn = dx + _mv(AmI[:, k], dx) + _mv(Bm[:, k], du_k) + ck[:, k]
            amax = _ftb(U[:, k], du_k, p.u_min, p.u_max, amax)
            amax = _ftb(X[:, k + 1], dxn, p.x_min, p.x_max, amax)
            stepn_i = torch.maximum(stepn_i, torch.maximum(
                du_k.abs().amax(-1), dxn.abs().amax(-1)))
            dU[:, k], dX[:, k + 1] = du_k, dxn
            dx, dv = dxn, du_k
        ddir = ddir + (G_N * dx).sum(-1) - nu_pen_new * c_l1

        al = amax[:, None] * fan_t                               # (M, T)
        a4 = al[:, :, None, None]
        dukm1 = torch.cat([torch.zeros_like(dU[:, :1]), dU[:, :-1]], 1)
        xt = X[:, None, :N] + a4 * dX[:, None, :N]
        ut = U[:, None] + a4 * dU[:, None]
        dut = ut - (ukm1[:, None] + a4 * dukm1[:, None])
        w4 = lambda t: t[:, None, None]
        sc_t, _ = stage_cost(xt, ut, dut, xt - xdes_prev[:, None],
                             mu[:, None, None, None], w4)
        d_t = ((X[:, None, :N] - X[:, None, 1:])
               + a4 * (dX[:, None, :N] - dX[:, None, 1:])) + step.inc(xt, ut)
        xtN = X[:, None, N] + al[..., None] * dX[:, None, N]
        eNt, eFt = xtN - xdes[:, None, N - 1], xtN - p.xf_des[:, None]
        cost_t = (sc_t.sum(-1)
                  + (q[:, None] * eNt * eNt + qf[:, None] * eFt * eFt).sum(-1)
                  + _barrier_value(xtN, p.x_min[:, None], p.x_max[:, None],
                                   mu[:, None, None]))
        m_t = cost_t + nu_pen_new[:, None] * d_t.abs().sum(dim=(2, 3))
        eps_m = NOISE_FLOOR_MULT * torch.finfo(dtype).eps * (1.0 + m0.abs())
        passed = torch.isfinite(m_t) & (
            m_t <= m0[:, None] + ARMIJO_SLOPE * al * ddir[:, None]
            + eps_m[:, None])
        first = passed.to(torch.int32).argmax(1, keepdim=True)
        alpha_new = torch.where(passed.any(1), al.gather(1, first)[:, 0], 0.0)
        alpha_new = torch.where(live, alpha_new, 0.0)
        move = (alpha_new > 0)[:, None, None]
        X = torch.where(move, X + alpha_new[:, None, None] * dX, X)
        U = torch.where(move, U + alpha_new[:, None, None] * dU, U)

        if not adaptive:
            nu_pen, stepn, feas = nu_pen_new, stepn_i, feas_i
            continue
        crawl = ((alpha_new == 0.0) | ~torch.isfinite(alpha_new)
                 | (alpha_new < 0.01 * amax))
        grow = torch.clamp(reg * REG_GROW + REG_GROW_ABS, max=REG_DIVERGED)
        reg_new = torch.where(crawl, grow,
                              torch.clamp(reg * REG_SHRINK, min=REG_MIN))
        inner_done = ((stepn_i < torch.clamp(INNER_MU_MULT * mu, min=tol))
                      & (feas_i < INNER_MU_MULT * tol))
        mu_new = torch.where(inner_done, torch.clamp(kappa * mu, min=floor),
                             mu)
        conv = (stepn_i < tol) & (feas_i < tol) & (mu <= 2.0 * floor)
        div = reg_new >= REG_DIVERGED
        done_new = torch.where(conv, 1.0, torch.where(div, 2.0, 0.0))
        sel = lambda new, old: torch.where(live, new, old)
        mu, reg, nu_pen = sel(mu_new, mu), sel(reg_new, reg), \
            sel(nu_pen_new, nu_pen)
        done = sel(done_new.to(dtype), done)
        stepn, feas = sel(stepn_i, stepn), sel(feas_i, feas)
        iters = iters + live.to(dtype)
    return X, U, stepn, feas, done, iters, mu


def solve(step, p: Params, X0, U0, mu0: float, n_iter: int, adaptive: bool,
          tol: float, mu_min: float, kappa: float) -> Result:
    """The service's solve of one batch: the warm start clipped into the
    strict interior with X[:, 0] = x0, the barrier started at mu0 (clamped
    to the floor for a bounded instance), the SQP, and the status rules."""
    M = p.x0.shape[0]
    dtype, device = p.x0.dtype, p.x0.device
    X0 = torch.cat([p.x0[:, None], strict_interior(
        X0[:, 1:], p.x_min[:, None], p.x_max[:, None])], 1)
    U0 = strict_interior(U0, p.u_min[:, None], p.u_max[:, None])
    fin = lambda t: torch.isfinite(t).any(-1)
    bounded = fin(p.u_min) | fin(p.u_max) | fin(p.x_min) | fin(p.x_max)
    floor = mu_floor(tol, mu_min)
    mu0_t = torch.full((M,), float(mu0), dtype=dtype, device=device)
    mu = torch.where(bounded, torch.clamp(mu0_t, min=floor),
                     torch.full_like(mu0_t, mu_min))
    fan = LS_FAN_ADAPTIVE if adaptive else LS_FAN_FIXED
    X, U, stepn, feas, done, iters, mu_end = sqp(
        step, p, X0, U0, mu, n_iter, fan, adaptive, tol, mu_min, kappa)
    finite = (torch.isfinite(stepn) & torch.isfinite(feas)
              & torch.isfinite(X.reshape(M, -1)).all(1))
    code = lambda c: torch.full((M,), c, dtype=torch.int64, device=device)
    if adaptive:
        status = torch.where((done >= 1.5) | ~finite, code(DIVERGED),
                             torch.where(done >= 0.5, code(CONVERGED),
                                         code(MAX_ITER)))
        iters = iters.to(torch.int64)
    else:
        conv = (stepn < tol) & (feas < tol) & (mu <= 2.0 * floor)
        status = torch.where(~finite, code(DIVERGED),
                             torch.where(conv, code(CONVERGED),
                                         code(MAX_ITER)))
        iters = code(n_iter)
    return Result(X, U, status, iters)


def failed_rule(status, X, U):
    """The service's rule for a failed instance (DIVERGED, or a plan that
    is not finite): a zero control now and a zero warm start next step.
    Returns (ok, the control (M, nu), the next warm start X, U)."""
    ok = ((status != DIVERGED) & torch.isfinite(X).flatten(1).all(1)
          & torch.isfinite(U).flatten(1).all(1))
    okx = ok[:, None, None]
    return (ok, torch.where(ok[:, None], U[:, 0], 0.0),
            torch.where(okx, X, 0.0), torch.where(okx, U, 0.0))
