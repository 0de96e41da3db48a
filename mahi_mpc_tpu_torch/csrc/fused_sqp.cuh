// One instance's whole SQP solve: the body of the fused kernel, written
// once for the device (csrc/fused_sqp.cu) and the host (fused_sqp_cpu.cpp,
// built only by the tests, like Pallas' interpret mode).
//
// It computes what `_make_kernel` in mahi_mpc_tpu/solver/fused.py computes:
// per iteration a backward sweep (linearize, stage gradients and barrier
// terms, block Riccati step over (Pxx, Pxv, Pvv, px, pv) with an unrolled
// nu x nu Cholesky, cost / l1 / max|p| accumulators), a forward rollout
// from the stored linearization (fraction-to-boundary cap, directional
// derivative), and a parallel fan line search on the l1 merit with a
// 0*inf-guarded update.  Fixed mode runs n_iter iterations at fixed mu and
// reg; adaptive mode adds the barrier continuation, the regularization
// ladder, per-instance status and an early exit (exact: a finished
// instance's iterate and stats never change again).
//
// The step policy `Step` is the only model-specific part: it linearizes a
// stage (the step's increment, A, B, and the rows the rollout reuses),
// takes the rollout's next state step, and evaluates the increment at a
// trial point.  The three modes of the Pallas kernel (`fused.py:313-369`):
//   FastNq<Model>   Euler step of a second-order model (the JAX nq-row rule):
//                   NQ dual-number acceleration rows, the rest analytic;
//   Generic<Model>  midpoint or RK4 (any integrator): NX rows of the
//                   increment's Jacobian by dual numbers through the step;
//   Ltv<NX, NU>     the frozen affine step, streamed in batch-innermost as
//                   (Ad - I, Bd, cd) and read row by row where it is used:
//                   no AD and no Jacobian scratch.
// The Model of FastNq and Generic is a hand-written one
// (model_dynamics.cuh) or one generated from a user's traced f
// (gen::Model<S>, models/codegen.py), and Ltv takes any shape: a generated
// build instantiates the one policy it defines (`GeneratedStep`, family
// kGenerated in `dispatch`).
// For the policies `GroupBody` names (the serial arms, LTV at (8, 4), most
// closed forms under midpoint and RK4, the double pendulum under Euler, a
// generated model's generic step where its shape splits over two lanes)
// the card runs the group body of fused_sqp_group.cuh instead, and at
// small batch the block body of fused_sqp_block.cuh for the policies
// `BlockBody` names; the tests run every body of every policy whose shape
// splits over its group.
// Every policy gives the increment F(x, u) - x, never F, and the body forms
// each defect as (x - x') + increment: x and x' differ by about the
// increment, so their float32 rounding (~ulp(x) a component) stays out of
// the l1 merit, which weighs the defects by nu_pen.  As F(x) - x' that
// rounding rejected full steps near the solution and the solve crawled to
// a damped answer (solver/fused.py `_solve_batch_fused_plain`).  The JAX
// Pallas kernel forms F(x) - x' (fused.py:332, :368); in float64 the two
// forms agree to roundoff.
//
// Arrays are batch-innermost: element e of an instance's (..., B) array is
// at p[e * B + b], so neighbouring threads read neighbouring addresses.
// Rules the arithmetic keeps (the CPU tests pin them):
//   * every literal is a constant of the scalar type S, so float code does
//     no FP64 arithmetic;
//   * max/min of accumulators propagate NaN, as jnp.maximum/minimum do
//     (fmaxf/fminf would drop it and could call a blown-up instance
//     converged);
//   * the update stays a select, alpha > 0 ? X + alpha dX : X, so a
//     rejected direction holding inf/NaN never reaches the iterate;
//   * sums run in the order of the JAX kernel's element algebra.
#pragma once

#include <type_traits>

#include "model_dynamics.cuh"

namespace mpc {

// solver/loop_common.py policy constants.
constexpr double kArmijoSlope = 1e-4;
constexpr double kNoiseFloorMult = 10.0;
constexpr double kRegGrow = 10.0;
constexpr double kRegGrowAbs = 1e-6;
constexpr double kRegShrink = 0.25;
constexpr double kRegMin = 1e-8;
constexpr double kRegDiverged = 1e8;
constexpr double kInnerMuMult = 10.0;
constexpr double kFtbTau = 0.995;
constexpr int kMaxFan = 8;
constexpr int kNumPtrs = 27;

template <typename S> struct Eps;
template <> struct Eps<float> { static constexpr float value = 1.1920928955078125e-07f; };
template <> struct Eps<double> { static constexpr double value = 2.220446049250313e-16; };

// NaN-propagating max/min (jnp.maximum / jnp.minimum semantics).
template <typename S> MPC_HD S nmax(S a, S b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename S> MPC_HD S nmin(S a, S b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <typename S>
struct FusedArgs {
  long long B;
  int N, n_iter, n_pin, adaptive, n_fan, integ, ltv;
  S dt, tol, mu_floor, kappa;
  S fan[kMaxFan];
  // inputs, batch-innermost: X0 (N+1,nx,B) U0 (N,nu,B) xdes (N,nx,B),
  // q r rm uprev umin umax xmin xmax qf xfdes (n,B), mu0 (B); LTV only:
  // AdI = Ad - I (nx,nx,B) Bd (nx,nu,B) cd (nx,B)
  const S *X0, *U0, *xdes, *q, *r, *rm, *uprev, *umin, *umax, *xmin, *xmax,
      *qf, *xfdes, *mu0, *AdI, *Bd, *cd;
  // outputs X (N+1,nx,B) U (N,nu,B) stats (8,B)
  S *X, *U, *stats;
  // scratch K (N,nu,nz,B) kff (N,nu,B) dX (N+1,nx,B) dU (N,nu,B)
  // G (N+1,nx+2nu,B) J (N,NJ,nz,B) ck (N,nx,B), NJ the step policy's rows
  S *K, *kff, *dX, *dU, *G, *J, *ck;
};

// Arguments from the flat C interface: kNumPtrs pointers in the order of
// the struct, scalars {dt, tol, mu_floor, kappa}, ints {n_iter, n_pin,
// adaptive, n_fan, integrator, ltv}, and the fan rungs.
template <typename S>
inline FusedArgs<S> make_args(long long B, int N, void* const* ptrs,
                              const S* scal, const int* ints, const S* fan) {
  FusedArgs<S> a;
  a.B = B;
  a.N = N;
  a.n_iter = ints[0];
  a.n_pin = ints[1];
  a.adaptive = ints[2];
  a.n_fan = ints[3] < kMaxFan ? ints[3] : kMaxFan;
  a.integ = ints[4];
  a.ltv = ints[5];
  a.dt = scal[0];
  a.tol = scal[1];
  a.mu_floor = scal[2];
  a.kappa = scal[3];
  for (int j = 0; j < kMaxFan; ++j) a.fan[j] = j < a.n_fan ? fan[j] : S(0);
  const S** in[] = {&a.X0, &a.U0, &a.xdes, &a.q, &a.r, &a.rm, &a.uprev,
                    &a.umin, &a.umax, &a.xmin, &a.xmax, &a.qf, &a.xfdes,
                    &a.mu0, &a.AdI, &a.Bd, &a.cd};
  S** out[] = {&a.X, &a.U, &a.stats, &a.K, &a.kff, &a.dX, &a.dU, &a.G,
               &a.J, &a.ck};
  int t = 0;
  for (const S** p : in) *p = static_cast<const S*>(ptrs[t++]);
  for (S** p : out) *p = static_cast<S*>(ptrs[t++]);
  return a;
}

// One instance's view of a batch-innermost array.
template <typename P>
struct Lane {
  P* p;
  long long B;
  MPC_HD P& operator[](int e) const { return p[(long long)e * B]; }
};

// Barrier gradient / Hessian diagonal of one box component
// (stage_qp.barrier_terms).
template <typename S>
MPC_HD void bar_terms(S v, S lo, S hi, S mu, S& g, S& h) {
  const bool lf = m_isfinite(lo), hf = m_isfinite(hi);
  const S slo = lf ? v - lo : S(1);
  const S shi = hf ? hi - v : S(1);
  g = (lf ? -mu / slo : S(0)) + (hf ? mu / shi : S(0));
  h = (lf ? mu / (slo * slo) : S(0)) + (hf ? mu / (shi * shi) : S(0));
}

// Barrier value -mu sum(log(v - lo) + log(hi - v)) over n components.
template <typename S, typename L>
MPC_HD S bar_value(const S* v, const L& lo, const L& hi, int n, S mu) {
  S acc = S(0);
  for (int i = 0; i < n; ++i) {
    const S l = lo[i], h = hi[i];
    const bool lf = m_isfinite(l), hf = m_isfinite(h);
    const S slo = lf ? nmax(v[i] - l, S(1e-30)) : S(1);
    const S shi = hf ? nmax(h - v[i], S(1e-30)) : S(1);
    acc = acc + -mu * ((lf ? m_log(slo) : S(0)) + (hf ? m_log(shi) : S(0)));
  }
  return acc;
}

// Fraction-to-boundary cap of one component (stage_qp.fraction_to_boundary).
template <typename S>
MPC_HD S ftb(S v, S dv, S lo, S hi, S amax) {
  const S tau = S(kFtbTau);
  const bool neg = dv < S(0), pos = dv > S(0);
  const S a_lo = (m_isfinite(lo) && neg) ? (-tau * (v - lo)) / dv : S(1);
  const S a_hi = (m_isfinite(hi) && pos) ? (tau * (hi - v)) / dv : S(1);
  return nmin(amax, nmin(a_lo, a_hi));
}

// ---- step policies.  Each has sizes NX, NU, the stored rows a stage NJ,
// and `bind(args, b)`, one instance's view with:
//   linearize(k, x, u, dt, val, A, Bm, Js): the increment F(x, u) - x, the
//     step's Jacobians A, Bm, and the rows the rollout reuses written to Js;
//   next_dx(k, dt, dx, du, Js, cks, dxn): dxn = (dx + (A - I) dx + B du)
//     + c_k from what linearize stored;
//   value(x, u, dt, val): the increment F(x, u) - x at a line-search trial
//     point.

// Euler step of a second-order model: the position rows of A are
// [I, dt I], B's are 0, and only the NQ acceleration rows need AD; their
// dt-scaled rows are stored.
template <typename S, typename Model>
struct FastNq {
  static constexpr int NQ = Model::NQ, NX = Model::NX, NU = Model::NU,
                       NZ = NX + NU, NJ = NQ;
  Model m;
  MPC_HD const FastNq& bind(const FusedArgs<S>&, long long) const {
    return *this;
  }
  MPC_HD void linearize(int k, const S* xl, const S* ul, S dt, S* val,
                        S (&A)[NX][NX], S (&Bm)[NX][NU],
                        const Lane<S>& Js) const {
    S fval[NX], Jr[NQ][NZ];
    acc_rows<S, Model>(m, xl, ul, dt, fval, Jr);
    for (int i = 0; i < NX; ++i) val[i] = dt * fval[i];
    for (int i = 0; i < NQ; ++i) {
      for (int j = 0; j < NX; ++j) {
        A[i][j] = S(j == i ? 1 : 0) + (j == i + NQ ? dt : S(0));
        A[NQ + i][j] = S(j == NQ + i ? 1 : 0) + Jr[i][j];
      }
      for (int j = 0; j < NU; ++j) {
        Bm[i][j] = S(0);
        Bm[NQ + i][j] = Jr[i][NX + j];
      }
      for (int j = 0; j < NZ; ++j) Js[(k * NQ + i) * NZ + j] = Jr[i][j];
    }
  }
  MPC_HD void next_dx(int k, S dt, const S* dx, const S* du,
                      const Lane<S>& Js, const Lane<S>& cks, S* dxn) const {
    for (int i = 0; i < NQ; ++i)
      dxn[i] = (dx[i] + dt * dx[NQ + i]) + cks[k * NX + i];
    for (int i = 0; i < NQ; ++i) {
      const int base = (k * NQ + i) * NZ;
      S acc = Js[base] * dx[0];
      for (int j = 1; j < NX; ++j) acc = acc + Js[base + j] * dx[j];
      for (int j = 0; j < NU; ++j) acc = acc + Js[base + NX + j] * du[j];
      dxn[NQ + i] = (dx[NQ + i] + acc) + cks[k * NX + NQ + i];
    }
  }
  MPC_HD void value(const S* xt, const S* ut, S dt, S* val) const {
    S fv[NX];
    model_f(m, xt, ut, fv);
    for (int i = 0; i < NX; ++i) val[i] = fv[i] * dt;
  }
};

// Any integrator: NX rows of the increment's Jacobian [A - I | B] by dual
// numbers through the step, stored as they come, one column a pass; the
// body's A is I + those rows.
template <typename S, typename Model>
struct Generic {
  static constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU,
                       NJ = NX;
  Model m;
  int integ;
  MPC_HD const Generic& bind(const FusedArgs<S>&, long long) const {
    return *this;
  }
  MPC_HD void linearize(int k, const S* xl, const S* ul, S dt, S* val,
                        S (&A)[NX][NX], S (&Bm)[NX][NU],
                        const Lane<S>& Js) const {
    increment_rows(m, integ, dt, xl, ul, val, [&](int d, int i, S v) {
      Js[(k * NX + i) * NZ + d] = v;
    });
    for (int i = 0; i < NX; ++i) {
      for (int j = 0; j < NX; ++j)
        A[i][j] = S(j == i ? 1 : 0) + Js[(k * NX + i) * NZ + j];
      for (int j = 0; j < NU; ++j) Bm[i][j] = Js[(k * NX + i) * NZ + NX + j];
    }
  }
  MPC_HD void next_dx(int k, S, const S* dx, const S* du, const Lane<S>& Js,
                      const Lane<S>& cks, S* dxn) const {
    for (int i = 0; i < NX; ++i) {
      const int base = (k * NX + i) * NZ;
      S acc = Js[base] * dx[0];
      for (int j = 1; j < NX; ++j) acc = acc + Js[base + j] * dx[j];
      for (int j = 0; j < NU; ++j) acc = acc + Js[base + NX + j] * du[j];
      dxn[i] = (dx[i] + acc) + cks[k * NX + i];
    }
  }
  MPC_HD void value(const S* xt, const S* ut, S dt, S* val) const {
    model_increment(m, integ, dt, xt, ut, val);
  }
};

// LTV (reference C8): the exact affine step F = Ad x + Bd u + cd of the
// frozen linearization, computed once per solve on the host and streamed
// in as (Ad - I, Bd, cd), so that the increment F - x = (Ad - I) x + Bd u
// + cd is formed without the difference.  Its rows are read from the
// batch-innermost inputs where they are used (coalesced, L2 resident)
// rather than held in registers for the whole solve.
template <typename S, int NX_, int NU_>
struct Ltv {
  static constexpr int NX = NX_, NU = NU_, NJ = 0;
  struct Bound {
    Lane<const S> AdI, Bd, cd;
    // Row i of (Ad - I) x + Bd u, each dot product left to right.
    MPC_HD S row(const S* x, const S* u, int i) const {
      S ax = AdI[i * NX] * x[0];
      for (int j = 1; j < NX; ++j) ax = ax + AdI[i * NX + j] * x[j];
      S bu = Bd[i * NU] * u[0];
      for (int j = 1; j < NU; ++j) bu = bu + Bd[i * NU + j] * u[j];
      return ax + bu;
    }
    MPC_HD void linearize(int, const S* xl, const S* ul, S, S* val,
                          S (&A)[NX][NX], S (&Bm)[NX][NU],
                          const Lane<S>&) const {
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j)
          A[i][j] = S(j == i ? 1 : 0) + AdI[i * NX + j];
        for (int j = 0; j < NU; ++j) Bm[i][j] = Bd[i * NU + j];
        val[i] = row(xl, ul, i) + cd[i];
      }
    }
    MPC_HD void next_dx(int k, S, const S* dx, const S* du, const Lane<S>&,
                        const Lane<S>& cks, S* dxn) const {
      for (int i = 0; i < NX; ++i)
        dxn[i] = (dx[i] + row(dx, du, i)) + cks[k * NX + i];
    }
    MPC_HD void value(const S* xt, const S* ut, S, S* val) const {
      for (int i = 0; i < NX; ++i) val[i] = row(xt, ut, i) + cd[i];
    }
  };
  MPC_HD Bound bind(const FusedArgs<S>& a, long long b) const {
    return Bound{{a.AdI + b, a.B}, {a.Bd + b, a.B}, {a.cd + b, a.B}};
  }
};

template <typename S, typename Step>
MPC_HD void solve_instance(const FusedArgs<S>& a, const Step& step,
                           long long b) {
  constexpr int NX = Step::NX, NU = Step::NU, NZ = NX + NU,
                NG = NX + 2 * NU;
  const auto& st = step.bind(a, b);
  const long long B = a.B;
  const int N = a.N;
  const S dt = a.dt;
  typedef Lane<const S> CL;
  typedef Lane<S> WL;
  const CL X0{a.X0 + b, B}, U0{a.U0 + b, B}, xdes{a.xdes + b, B};
  const CL q{a.q + b, B}, r{a.r + b, B}, rm{a.rm + b, B};
  const CL uprev{a.uprev + b, B}, umin{a.umin + b, B}, umax{a.umax + b, B};
  const CL xmin{a.xmin + b, B}, xmax{a.xmax + b, B};
  const CL qf{a.qf + b, B}, xfdes{a.xfdes + b, B};
  const WL X{a.X + b, B}, U{a.U + b, B}, stats{a.stats + b, B};
  const WL Ks{a.K + b, B}, kffs{a.kff + b, B}, dXs{a.dX + b, B};
  const WL dUs{a.dU + b, B}, Gs{a.G + b, B}, Js{a.J + b, B}, cks{a.ck + b, B};

  // Stage cost (separable tracking + rate/magnitude + barriers); returns the
  // merit's smooth part and sets the shared rate/magnitude term.
  auto stage_cost = [&](const S* xl, const S* ul, const S* du, const S* e,
                        bool tk, S mu, S& rate_mag) -> S {
    S c = S(0);
    for (int i = 0; i < NX; ++i) c = c + (tk ? q[i] * (e[i] * e[i]) : S(0));
    rate_mag = S(0);
    for (int k = 0; k < NU; ++k) {
      rate_mag = rate_mag + r[k] * (du[k] * du[k]);
      rate_mag = rate_mag + rm[k] * (ul[k] * ul[k]);
    }
    const S bx = bar_value(xl, xmin, xmax, NX, mu);
    c = c + (tk ? bx : S(0));
    c = c + bar_value(ul, umin, umax, NU, mu);
    return c + rate_mag;
  };
  auto load = [&](const auto& src, int base, int n, S* dst) {
    for (int i = 0; i < n; ++i) dst[i] = src[base + i];
  };

  // ---- warm start into the working (output) buffers
  for (int e = 0; e < (N + 1) * NX; ++e) X[e] = X0[e];
  for (int e = 0; e < N * NU; ++e) U[e] = U0[e];

  const S inf = S(INFINITY);
  S mu = a.mu0[b], reg = S(kRegMin), nu_pen = S(1), done = S(0),
    iters = S(0);
  S stepn = inf, feas = inf, jref = inf, alpha = inf;

#pragma unroll 1
  for (int it = 0; it < a.n_iter; ++it) {
    if (a.adaptive && done >= S(0.5)) break;   // per-instance early exit

    // ======================= backward sweep =======================
    S Pxx[NX][NX], Pxv[NX][NU], Pvv[NU][NU], px[NX], pv[NU];
    S cost0, jref_old, pmax = S(0), feas_i = S(0), c_l1 = S(0);
    {
      S xN[NX], eN[NX], eF[NX];
      load(X, N * NX, NX, xN);
      for (int i = 0; i < NX; ++i) {
        eN[i] = xN[i] - xdes[(N - 1) * NX + i];
        eF[i] = xN[i] - xfdes[i];
      }
      for (int i = 0; i < NX; ++i) {
        S g, h;
        bar_terms(xN[i], xmin[i], xmax[i], mu, g, h);
        for (int j = 0; j < NX; ++j) Pxx[i][j] = S(0);
        Pxx[i][i] = (S(2) * q[i] + S(2) * qf[i]) + h;
        px[i] = (S(2) * q[i] * eN[i] + S(2) * qf[i] * eF[i]) + g;
        for (int k = 0; k < NU; ++k) Pxv[i][k] = S(0);
        Gs[N * NG + i] = px[i];
      }
      for (int k = 0; k < NU; ++k) {
        pv[k] = S(0);
        for (int l = 0; l < NU; ++l) Pvv[k][l] = S(0);
      }
      for (int k = 0; k < 2 * NU; ++k) Gs[N * NG + NX + k] = S(0);
      cost0 = bar_value(xN, xmin, xmax, NX, mu);
      jref_old = S(0);
      for (int i = 0; i < NX; ++i) {
        cost0 = cost0 + q[i] * (eN[i] * eN[i]);
        cost0 = cost0 + qf[i] * (eF[i] * eF[i]);
      }
      for (int i = 0; i < NX; ++i) jref_old = jref_old + qf[i] * (eF[i] * eF[i]);
      for (int i = 0; i < NX; ++i) pmax = nmax(pmax, m_abs(px[i]));
    }

#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      const bool tk = k >= 1;
      S xl[NX], ul[NU], xn1[NX], ukm1[NU];
      load(X, k * NX, NX, xl);
      load(U, k * NU, NU, ul);
      load(X, (k + 1) * NX, NX, xn1);
      if (k == 0) load(uprev, 0, NU, ukm1);
      else load(U, (k - 1) * NU, NU, ukm1);
      const int kp = k >= 1 ? k - 1 : 0;

      // ---- linearize: increment, Jacobians, defect (x - x') + increment
      // (the policy stores what the rollout reuses)
      S val[NX], ck[NX], A[NX][NX], Bm[NX][NU];
      st.linearize(k, xl, ul, dt, val, A, Bm, Js);
      for (int i = 0; i < NX; ++i) {
        ck[i] = (xl[i] - xn1[i]) + val[i];
        val[i] = xl[i] + val[i];
        cks[k * NX + i] = ck[i];
      }

      // ---- stage gradients and diagonal (stage_qp.build_stage_qp blocks)
      S gzx[NX], gzv[NU], gu[NU], Dx[NX], Du[NU], du[NU], e[NX];
      for (int i = 0; i < NX; ++i) {
        S g, h;
        e[i] = xl[i] - xdes[kp * NX + i];
        bar_terms(xl[i], xmin[i], xmax[i], mu, g, h);
        gzx[i] = tk ? S(2) * q[i] * e[i] + g : S(0);
        Dx[i] = tk ? S(2) * q[i] + h : S(0);
      }
      for (int l = 0; l < NU; ++l) {
        S g, h;
        const S r2 = S(2) * r[l], rm2 = S(2) * rm[l];
        du[l] = ul[l] - ukm1[l];
        bar_terms(ul[l], umin[l], umax[l], mu, g, h);
        gzv[l] = -(r2 * du[l]);
        gu[l] = (r2 * du[l] + rm2 * ul[l]) + g;
        Du[l] = (r2 + rm2) + (h + reg);
      }
      for (int i = 0; i < NX; ++i) Gs[k * NG + i] = gzx[i];
      for (int l = 0; l < NU; ++l) {
        Gs[k * NG + NX + l] = gzv[l];
        Gs[k * NG + NX + NU + l] = gu[l];
      }

      // ---- merit and feasibility accumulators
      for (int i = 0; i < NX; ++i) {
        feas_i = nmax(feas_i, m_abs(ck[i]));
        c_l1 = c_l1 + m_abs(ck[i]);
      }
      S rmag;
      cost0 = cost0 + stage_cost(xl, ul, du, e, tk, mu, rmag);
      S jr = rmag;
      for (int i = 0; i < NX; ++i) {
        const S er = val[i] - xdes[k * NX + i];
        jr = jr + q[i] * (er * er);
      }
      jref_old = jref_old + jr;

      // ---- block Riccati step: Az = [[A,0],[0,0]], Bz = [[B],[I]],
      // Hzz = diag[Dx, 2R], Hzu = [[0],[-2R]]  (solve_batch_fused docstring)
      S Prp_x[NX], Prp_v[NU];
      for (int i = 0; i < NX; ++i) {
        S acc = Pxx[i][0] * ck[0];
        for (int t = 1; t < NX; ++t) acc = acc + Pxx[i][t] * ck[t];
        Prp_x[i] = px[i] + acc;
      }
      for (int l = 0; l < NU; ++l) {
        S acc = Pxv[0][l] * ck[0];
        for (int t = 1; t < NX; ++t) acc = acc + Pxv[t][l] * ck[t];
        Prp_v[l] = pv[l] + acc;
      }
      S M1[NX][NU], PxxB[NX][NU];
      for (int i = 0; i < NX; ++i)
        for (int l = 0; l < NU; ++l) {
          S acc = Pxx[i][0] * Bm[0][l];
          for (int t = 1; t < NX; ++t) acc = acc + Pxx[i][t] * Bm[t][l];
          PxxB[i][l] = acc;
          M1[i][l] = acc + Pxv[i][l];
        }
      S Qxx[NX][NX];
      {
        S PxxA[NX][NX];
        for (int i = 0; i < NX; ++i)
          for (int j = 0; j < NX; ++j) {
            S acc = Pxx[i][0] * A[0][j];
            for (int t = 1; t < NX; ++t) acc = acc + Pxx[i][t] * A[t][j];
            PxxA[i][j] = acc;
          }
        for (int i = 0; i < NX; ++i)
          for (int j = i; j < NX; ++j) {   // A' Pxx A is symmetric
            S acc = A[0][i] * PxxA[0][j];
            for (int t = 1; t < NX; ++t) acc = acc + A[t][i] * PxxA[t][j];
            Qxx[i][j] = acc;
            Qxx[j][i] = acc;
          }
      }
      for (int i = 0; i < NX; ++i) Qxx[i][i] = Qxx[i][i] + Dx[i];
      S Qxu[NX][NU], Quu[NU][NU];
      for (int i = 0; i < NX; ++i)
        for (int l = 0; l < NU; ++l) {
          S acc = A[0][i] * M1[0][l];
          for (int t = 1; t < NX; ++t) acc = acc + A[t][i] * M1[t][l];
          Qxu[i][l] = acc;
        }
      {
        S BtPxxB[NU][NU], BtPxv[NU][NU];
        for (int l = 0; l < NU; ++l)
          for (int m = 0; m < NU; ++m) {
            S a1 = Bm[0][l] * PxxB[0][m], a2 = Bm[0][l] * Pxv[0][m];
            for (int t = 1; t < NX; ++t) {
              a1 = a1 + Bm[t][l] * PxxB[t][m];
              a2 = a2 + Bm[t][l] * Pxv[t][m];
            }
            BtPxxB[l][m] = a1;
            BtPxv[l][m] = a2;
          }
        for (int l = 0; l < NU; ++l)
          for (int m = 0; m < NU; ++m)
            Quu[l][m] = (BtPxxB[l][m] + (BtPxv[l][m] + BtPxv[m][l])) + Pvv[l][m];
      }
      for (int l = 0; l < NU; ++l) Quu[l][l] = Quu[l][l] + Du[l];
      S qz_x[NX], qu[NU];
      for (int i = 0; i < NX; ++i) {
        S acc = A[0][i] * Prp_x[0];
        for (int t = 1; t < NX; ++t) acc = acc + A[t][i] * Prp_x[t];
        qz_x[i] = gzx[i] + acc;
      }
      for (int l = 0; l < NU; ++l) {
        S acc = Bm[0][l] * Prp_x[0];
        for (int t = 1; t < NX; ++t) acc = acc + Bm[t][l] * Prp_x[t];
        qu[l] = gu[l] + (acc + Prp_v[l]);
      }

      // Cholesky of Quu (Crout order, ops/elem.py chol) and the three
      // solves K_x = -Quu^{-1} Qxu', K_v = Quu^{-1} 2R, kff = -Quu^{-1} qu.
      S Lc[NU][NU], Linv[NU];
      for (int j = 0; j < NU; ++j) {
        S s = Quu[j][j];
        for (int t = 0; t < j; ++t) s = s - Lc[j][t] * Lc[j][t];
        const S d = m_sqrt(s);
        Lc[j][j] = d;
        Linv[j] = S(1) / d;
        for (int i = j + 1; i < NU; ++i) {
          S t2 = Quu[i][j];
          for (int t = 0; t < j; ++t) t2 = t2 - Lc[i][t] * Lc[j][t];
          Lc[i][j] = t2 * Linv[j];
        }
      }
      // Right-hand sides as rows: [ -Qxu' | 2R | -qu ] (NU x (NX + NU + 1)).
      constexpr int NR = NX + NU + 1;
      S Y[NU][NR];
      for (int l = 0; l < NU; ++l) {
        for (int i = 0; i < NX; ++i) Y[l][i] = -Qxu[i][l];
        for (int m = 0; m < NU; ++m) Y[l][NX + m] = m == l ? S(2) * r[l] : S(0);
        Y[l][NX + NU] = -qu[l];
      }
      for (int i = 0; i < NU; ++i) {           // L y = rhs
        for (int t = 0; t < i; ++t)
          for (int c = 0; c < NR; ++c) Y[i][c] = Y[i][c] - Lc[i][t] * Y[t][c];
        for (int c = 0; c < NR; ++c) Y[i][c] = Y[i][c] * Linv[i];
      }
      for (int i = NU - 1; i >= 0; --i) {      // L' x = y
        for (int t = i + 1; t < NU; ++t)
          for (int c = 0; c < NR; ++c) Y[i][c] = Y[i][c] - Lc[t][i] * Y[t][c];
        for (int c = 0; c < NR; ++c) Y[i][c] = Y[i][c] * Linv[i];
      }
      // Y now holds [Kx | Kv | kff].

      if (k < a.n_pin) {
        // Head-control pinning: Bz = 0, Hzu = 0, gu = 0, Huu = I collapse
        // to K = 0, kff = 0, P = [[Qxx, 0], [0, 2R]], p = [qz_x; gzv].
        for (int l = 0; l < NU; ++l) {
          for (int c = 0; c < NR; ++c) Y[l][c] = S(0);
          for (int m = 0; m < NU; ++m) Pvv[l][m] = m == l ? S(2) * r[l] : S(0);
          pv[l] = gzv[l];
        }
        for (int i = 0; i < NX; ++i) {
          for (int j = 0; j < NX; ++j) Pxx[i][j] = Qxx[i][j];
          for (int l = 0; l < NU; ++l) Pxv[i][l] = S(0);
          px[i] = qz_x[i];
        }
      } else {
        for (int i = 0; i < NX; ++i)
          for (int j = 0; j < NX; ++j) {
            S acc = Qxu[i][0] * Y[0][j];
            for (int l = 1; l < NU; ++l) acc = acc + Qxu[i][l] * Y[l][j];
            Qxx[i][j] = Qxx[i][j] + acc;      // Qxx + Qxu Kx
          }
        for (int i = 0; i < NX; ++i)
          for (int j = 0; j < NX; ++j)
            Pxx[i][j] = S(0.5) * (Qxx[i][j] + Qxx[j][i]);
        for (int i = 0; i < NX; ++i)
          for (int l = 0; l < NU; ++l) {
            S acc = Qxu[i][0] * Y[0][NX + l];
            for (int m = 1; m < NU; ++m) acc = acc + Qxu[i][m] * Y[m][NX + l];
            Pxv[i][l] = S(0.5) * (acc + -(S(2) * r[l] * Y[l][i]));
          }
        for (int l = 0; l < NU; ++l) {
          for (int m = 0; m < NU; ++m)
            Pvv[l][m] = S(-0.5) * (S(2) * r[l] * Y[l][NX + m]
                                   + S(2) * r[m] * Y[m][NX + l]);
          Pvv[l][l] = Pvv[l][l] + S(2) * r[l];
        }
        for (int i = 0; i < NX; ++i) {
          S acc = Qxu[i][0] * Y[0][NX + NU];
          for (int l = 1; l < NU; ++l) acc = acc + Qxu[i][l] * Y[l][NX + NU];
          px[i] = qz_x[i] + acc;
        }
        for (int l = 0; l < NU; ++l)
          pv[l] = gzv[l] - S(2) * r[l] * Y[l][NX + NU];
      }
      for (int l = 0; l < NU; ++l) {
        kffs[k * NU + l] = Y[l][NX + NU];
        for (int j = 0; j < NZ; ++j) Ks[(k * NU + l) * NZ + j] = Y[l][j];
      }
      for (int i = 0; i < NX; ++i) pmax = nmax(pmax, m_abs(px[i]));
      for (int l = 0; l < NU; ++l) pmax = nmax(pmax, m_abs(pv[l]));
    }

    const S nu_pen_new = nmax(nu_pen, S(2) * pmax + S(1));
    const S m0 = cost0 + nu_pen_new * c_l1;

    // ======================= forward rollout =======================
    S dx[NX], dv[NU], amax = S(1), ddir = S(0), stepn_i = S(0);
    for (int i = 0; i < NX; ++i) {
      dx[i] = S(0);
      dXs[i] = S(0);
    }
    for (int l = 0; l < NU; ++l) dv[l] = S(0);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      S du[NU], dxn[NX];
      for (int l = 0; l < NU; ++l) {
        const int base = (k * NU + l) * NZ;
        S acc = Ks[base] * dx[0];
        for (int j = 1; j < NX; ++j) acc = acc + Ks[base + j] * dx[j];
        for (int j = 0; j < NU; ++j) acc = acc + Ks[base + NX + j] * dv[j];
        du[l] = acc + kffs[k * NU + l];
      }
      for (int i = 0; i < NX; ++i) ddir = ddir + Gs[k * NG + i] * dx[i];
      for (int l = 0; l < NU; ++l) {
        ddir = ddir + Gs[k * NG + NX + l] * dv[l];
        ddir = ddir + Gs[k * NG + NX + NU + l] * du[l];
      }
      st.next_dx(k, dt, dx, du, Js, cks, dxn);
      for (int l = 0; l < NU; ++l)
        amax = ftb(U[k * NU + l], du[l], umin[l], umax[l], amax);
      for (int i = 0; i < NX; ++i)
        amax = ftb(X[(k + 1) * NX + i], dxn[i], xmin[i], xmax[i], amax);
      for (int l = 0; l < NU; ++l) stepn_i = nmax(stepn_i, m_abs(du[l]));
      for (int i = 0; i < NX; ++i) stepn_i = nmax(stepn_i, m_abs(dxn[i]));
      for (int l = 0; l < NU; ++l) {
        dUs[k * NU + l] = du[l];
        dv[l] = du[l];
      }
      for (int i = 0; i < NX; ++i) {
        dXs[(k + 1) * NX + i] = dxn[i];
        dx[i] = dxn[i];
      }
    }
    for (int i = 0; i < NX; ++i) ddir = ddir + Gs[N * NG + i] * dx[i];
    ddir = ddir - nu_pen_new * c_l1;

    // ================= line search: parallel fan of rungs =================
    const S eps_m = S(kNoiseFloorMult) * Eps<S>::value * (S(1) + m_abs(m0));
    S al[kMaxFan], cost_t[kMaxFan], cl1_t[kMaxFan], jref_t[kMaxFan];
#pragma unroll
    for (int j = 0; j < kMaxFan; ++j) {
      al[j] = amax * a.fan[j];
      cost_t[j] = S(0);
      cl1_t[j] = S(0);
      jref_t[j] = S(0);
    }
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const bool tk = k >= 1;
      const int kp = k >= 1 ? k - 1 : 0;
      S xl[NX], ul[NU], xn1[NX], dxk[NX], duk[NU], dxk1[NX], ukm1[NU],
          dukm1[NU];
      load(X, k * NX, NX, xl);
      load(U, k * NU, NU, ul);
      load(X, (k + 1) * NX, NX, xn1);
      load(dXs, k * NX, NX, dxk);
      load(dUs, k * NU, NU, duk);
      load(dXs, (k + 1) * NX, NX, dxk1);
      if (k == 0) {
        load(uprev, 0, NU, ukm1);
        for (int l = 0; l < NU; ++l) dukm1[l] = S(0);
      } else {
        load(U, (k - 1) * NU, NU, ukm1);
        load(dUs, (k - 1) * NU, NU, dukm1);
      }
#pragma unroll
      for (int j = 0; j < kMaxFan; ++j) {
        if (j >= a.n_fan) break;
        const S aj = al[j];
        S xt[NX], ut[NU], dut[NU], et[NX], vt[NX];
        for (int i = 0; i < NX; ++i) {
          xt[i] = xl[i] + aj * dxk[i];
          et[i] = xt[i] - xdes[kp * NX + i];
        }
        for (int l = 0; l < NU; ++l) {
          ut[l] = ul[l] + aj * duk[l];
          dut[l] = ut[l] - (ukm1[l] + aj * dukm1[l]);
        }
        S rmag;
        const S sc = stage_cost(xt, ut, dut, et, tk, mu, rmag);
        st.value(xt, ut, dt, vt);
        S cl1 = cl1_t[j], jr = rmag;
        for (int i = 0; i < NX; ++i) {
          const S vi = xt[i] + vt[i];
          const S di = ((xl[i] - xn1[i]) + aj * (dxk[i] - dxk1[i])) + vt[i];
          cl1 = cl1 + m_abs(di);
          const S er = vi - xdes[k * NX + i];
          jr = jr + q[i] * (er * er);
        }
        cost_t[j] = cost_t[j] + sc;
        cl1_t[j] = cl1;
        jref_t[j] = jref_t[j] + jr;
      }
    }

    // terminal terms per rung, Armijo test, first passing rung wins
    S alpha_new = S(0), jref_new = jref_old;
    {
      S xN[NX], dxN[NX];
      load(X, N * NX, NX, xN);
      load(dXs, N * NX, NX, dxN);
      bool found = false;
#pragma unroll
      for (int j = 0; j < kMaxFan; ++j) {
        if (j >= a.n_fan) break;
        S xt[NX];
        S ct = cost_t[j], jr = jref_t[j];
        for (int i = 0; i < NX; ++i) {
          xt[i] = xN[i] + al[j] * dxN[i];
          const S eN = xt[i] - xdes[(N - 1) * NX + i];
          const S eF = xt[i] - xfdes[i];
          ct = (ct + q[i] * eN * eN) + qf[i] * eF * eF;
          jr = jr + qf[i] * eF * eF;
        }
        ct = ct + bar_value(xt, xmin, xmax, NX, mu);
        const S mj = ct + nu_pen_new * cl1_t[j];
        const bool pass = m_isfinite(mj)
            && mj <= (m0 + S(kArmijoSlope) * al[j] * ddir) + eps_m;
        if (pass && !found) {
          found = true;
          alpha_new = al[j];
          jref_new = jr;
        }
      }
    }

    // 0*inf-guarded update: a rejected direction may hold inf/NaN.
    if (alpha_new > S(0)) {
      for (int e = 0; e < (N + 1) * NX; ++e) X[e] = X[e] + alpha_new * dXs[e];
      for (int e = 0; e < N * NU; ++e) U[e] = U[e] + alpha_new * dUs[e];
    }

    nu_pen = nu_pen_new;
    stepn = stepn_i;
    feas = feas_i;
    jref = jref_new;
    alpha = alpha_new;
    if (!a.adaptive) continue;

    // ---- adaptive bookkeeping (loop_common policies).  A step that takes
    // only a deep rung (alpha < 1% of the boundary cap) grows reg like a
    // failed search, as the JAX kernel does.
    const bool no_move = alpha_new == S(0) || !m_isfinite(alpha_new);
    const bool crawl = no_move || alpha_new < S(0.01) * amax;
    const S reg_new = crawl
        ? nmin(reg * S(kRegGrow) + S(kRegGrowAbs), S(kRegDiverged))
        : nmax(reg * S(kRegShrink), S(kRegMin));
    const bool inner_done =
        stepn_i < nmax(S(kInnerMuMult) * mu, a.tol)
        && feas_i < S(kInnerMuMult) * a.tol;
    const S mu_new = inner_done ? nmax(a.mu_floor, a.kappa * mu) : mu;
    const bool conv = stepn_i < a.tol && feas_i < a.tol
        && mu <= S(2) * a.mu_floor;
    const bool div = reg_new >= S(kRegDiverged);
    // Status precedence: converged wins over diverged in the same
    // iteration, as in the lanes solver (solver/batched.py:396).  The JAX
    // fused kernel (fused.py:780) lets diverged win instead.
    done = conv ? S(1) : (div ? S(2) : S(0));
    mu = mu_new;
    reg = reg_new;
    iters = iters + S(1);
  }

  stats[0] = stepn;
  stats[1] = feas;
  stats[2] = jref;
  stats[3] = alpha;
  stats[4] = mu;
  stats[5] = done;
  stats[6] = iters;
  stats[7] = S(0);
}

// ---- instantiation: which step policy serves a problem.

// Kernel-model ids (solver/fused.py ARM_IDS, CLOSED_FORM_IDS and
// GENERATED_ID: a model generated from its traced f, models/codegen.py).
enum ModelId {
  kTwoLinkArm = 0, kMahiArm = 1, kPendulum = 2, kCartpole = 3,
  kDoublePendulum = 4, kAcrobot = 5, kGeneratedModel = -2
};

// The instantiation families; a build holds the ones in its mask (one CUDA
// library each, so nvcc builds them concurrently; the CPU test build holds
// all the hand-written ones).  kGenerated: the one step policy of a
// generated build (solver/target.py `kernel_target`), which defines
// `GeneratedStep<S>::make(args)`: FastNq or Generic over a generated model
// gen::Model<S>, or Ltv<S, NX, NU> at a shape outside kLtvShapes.
enum Family { kArmFast = 1, kArmGeneric = 2, kModels = 4, kLtvShapes = 8,
              kAllFamilies = 15, kGenerated = 16 };

template <typename S> struct GeneratedStep;

template <typename Step> struct IsLtv { static constexpr bool value = false; };
template <typename S, int NX, int NU> struct IsLtv<Ltv<S, NX, NU>> {
  static constexpr bool value = true;
};
template <typename Step> struct IsFastNq {
  static constexpr bool value = false;
};
template <typename S, typename M> struct IsFastNq<FastNq<S, M>> {
  static constexpr bool value = true;
};

// Calls fn(step) with the policy that serves (model, nx, nu) under the
// integrator and LTV flag of `a`, among the families of kFamilies; returns
// fn's result, or -1 when no instantiation of this build serves it.
template <typename S, int kFamilies, typename Fn>
int dispatch(const FusedArgs<S>& a, int model, int nx, int nu,
             const double* c, const Fn& fn) {
  auto serve = [&](const auto& step) -> int {
    typedef typename std::decay<decltype(step)>::type Step;
    return (Step::NX == nx && Step::NU == nu) ? fn(step) : -1;
  };
  if constexpr ((kFamilies & kGenerated) != 0) {
    // its own shape and mode only: the nq-row policy under Euler alone
    typedef decltype(GeneratedStep<S>::make(a)) Step;
    if (bool(a.ltv) != IsLtv<Step>::value ||
        (IsFastNq<Step>::value && a.integ != kEuler))
      return -1;
    return serve(GeneratedStep<S>::make(a));
  }
  if (a.ltv) {
    if constexpr ((kFamilies & kLtvShapes) != 0) {
      if (nx == 8 && nu == 4) return serve(Ltv<S, 8, 4>{});
      if (nx == 4 && nu == 2) return serve(Ltv<S, 4, 2>{});
      if (nx == 4 && nu == 1) return serve(Ltv<S, 4, 1>{});
      if (nx == 2 && nu == 1) return serve(Ltv<S, 2, 1>{});
    }
    return -1;
  }
  const bool euler = a.integ == kEuler;
  // One model: the nq-row policy under Euler, the generic one otherwise.
  auto either = [&](const auto& m) -> int {
    typedef typename std::decay<decltype(m)>::type M;
    return euler ? serve(FastNq<S, M>{m}) : serve(Generic<S, M>{m, a.integ});
  };
  if (model == kTwoLinkArm || model == kMahiArm) {
    const bool two = model == kTwoLinkArm;
    if constexpr ((kFamilies & kArmFast) != 0) {
      if (euler && two)
        return serve(FastNq<S, ArmModel<S, 2>>{{load_arm<S, double, 2>(c)}});
      if (euler)
        return serve(FastNq<S, ArmModel<S, 4>>{{load_arm<S, double, 4>(c)}});
    }
    if constexpr ((kFamilies & kArmGeneric) != 0) {
      if (!euler && two)
        return serve(Generic<S, ArmModel<S, 2>>{
            {load_arm<S, double, 2>(c)}, a.integ});
      if (!euler)
        return serve(Generic<S, ArmModel<S, 4>>{
            {load_arm<S, double, 4>(c)}, a.integ});
    }
    return -1;
  }
  if constexpr ((kFamilies & kModels) != 0) {
    switch (model) {
      case kPendulum: return either(Pendulum<S>::load(c));
      case kCartpole: return either(Cartpole<S>::load(c));
      case kDoublePendulum: return either(DoublePendulum<S>::load(c));
      case kAcrobot: return either(Acrobot<S>::load(c));
      default: break;
    }
  }
  return -1;
}

}  // namespace mpc
