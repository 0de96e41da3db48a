// Serial-arm dynamics for the fused SQP kernel, written once for the host
// and the device.
//
// The same chain as models/arm.py (and the JAX package's element-style
// `f_elem`, which its Pallas kernel traces): forward kinematics, the
// explicit geometric-Jacobian mass matrix, the recursive Newton-Euler bias
// h(q, qd) = C(q, qd) qd + grav(q) with gravity as a base acceleration, and
// qdd = M^{-1} (u - h - damping qd) by an unrolled Cholesky solve.  The
// arithmetic order follows `f_elem` term by term.
//
// CUDA has no automatic differentiation, so the stage Jacobian rows that
// the Pallas kernel takes from an in-kernel `jax.vjp` come from forward-mode
// dual numbers here: `Dual<S, K>` carries K tangent directions
// (model_dynamics.cuh runs the passes).  Every function is a template on
// the scalar type T (float, double or a Dual) with the chain constants in
// the plain scalar S.
#pragma once

#include <math.h>

#include <type_traits>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#endif

#if defined(__CUDACC__)
#define MPC_HD __host__ __device__ __forceinline__
#else
#define MPC_HD inline
#endif

namespace mpc {

// ---- scalar math, overloaded for float and double (no FP64 in float code)
MPC_HD float m_sqrt(float x) { return sqrtf(x); }
MPC_HD double m_sqrt(double x) { return sqrt(x); }
MPC_HD float m_sin(float x) { return sinf(x); }
MPC_HD double m_sin(double x) { return sin(x); }
MPC_HD float m_cos(float x) { return cosf(x); }
MPC_HD double m_cos(double x) { return cos(x); }
MPC_HD float m_log(float x) { return logf(x); }
MPC_HD double m_log(double x) { return log(x); }
MPC_HD float m_abs(float x) { return fabsf(x); }
MPC_HD double m_abs(double x) { return fabs(x); }
// The rest of what a generated model (models/codegen.py) emits.
MPC_HD float m_tan(float x) { return tanf(x); }
MPC_HD double m_tan(double x) { return tan(x); }
MPC_HD float m_exp(float x) { return expf(x); }
MPC_HD double m_exp(double x) { return exp(x); }
MPC_HD float m_tanh(float x) { return tanhf(x); }
MPC_HD double m_tanh(double x) { return tanh(x); }
MPC_HD float m_pow(float x, float e) { return powf(x, e); }
MPC_HD double m_pow(double x, double e) { return pow(x, e); }
// The value part of a scalar (a dual number's overload below): what a
// generated comparison reads.
MPC_HD float m_value(float x) { return x; }
MPC_HD double m_value(double x) { return x; }
// False for +-inf and NaN (fabs(NaN) <= max is false).
MPC_HD bool m_isfinite(float x) { return fabsf(x) <= 3.402823466e+38f; }
MPC_HD bool m_isfinite(double x) { return fabs(x) <= 1.7976931348623157e+308; }

// ---- forward-mode dual numbers with K tangent directions
template <typename S, int K>
struct Dual {
  S v;
  S d[K];
  MPC_HD Dual() : v(S(0)) {
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = S(0);
  }
  MPC_HD Dual(S x) : v(x) {
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = S(0);
  }
};

#define MPC_DUAL template <typename S, int K> MPC_HD Dual<S, K>

MPC_DUAL operator+(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r(a.v + b.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
MPC_DUAL operator-(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r(a.v - b.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
MPC_DUAL operator-(const Dual<S, K>& a) {
  Dual<S, K> r(-a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}
MPC_DUAL operator*(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r(a.v * b.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
MPC_DUAL operator/(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r(a.v / b.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}
// Mixed with a plain constant of the scalar type.
MPC_DUAL operator+(const Dual<S, K>& a, S b) { return a + Dual<S, K>(b); }
MPC_DUAL operator+(S a, const Dual<S, K>& b) { return Dual<S, K>(a) + b; }
MPC_DUAL operator-(const Dual<S, K>& a, S b) { return a - Dual<S, K>(b); }
MPC_DUAL operator-(S a, const Dual<S, K>& b) { return Dual<S, K>(a) - b; }
MPC_DUAL operator*(const Dual<S, K>& a, S b) {
  Dual<S, K> r(a.v * b);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b;
  return r;
}
MPC_DUAL operator*(S a, const Dual<S, K>& b) { return b * a; }
MPC_DUAL operator/(S a, const Dual<S, K>& b) { return Dual<S, K>(a) / b; }
MPC_DUAL operator/(const Dual<S, K>& a, S b) { return a / Dual<S, K>(b); }

MPC_DUAL m_sin(const Dual<S, K>& a) {
  Dual<S, K> r(m_sin(a.v));
  const S c = m_cos(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = c * a.d[k];
  return r;
}
MPC_DUAL m_cos(const Dual<S, K>& a) {
  Dual<S, K> r(m_cos(a.v));
  const S s = -m_sin(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = s * a.d[k];
  return r;
}
MPC_DUAL m_sqrt(const Dual<S, K>& a) {
  Dual<S, K> r(m_sqrt(a.v));
  const S h = S(0.5) / r.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = h * a.d[k];
  return r;
}
// The generated models' other ops.  Each tangent is the derivative at the
// value times the input's tangent, as torch.func.jvp forms it.
MPC_DUAL m_log(const Dual<S, K>& a) {
  Dual<S, K> r(m_log(a.v));
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] / a.v;
  return r;
}
MPC_DUAL m_exp(const Dual<S, K>& a) {
  Dual<S, K> r(m_exp(a.v));
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * r.v;
  return r;
}
MPC_DUAL m_tan(const Dual<S, K>& a) {
  Dual<S, K> r(m_tan(a.v));
  const S g = S(1) + r.v * r.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * g;
  return r;
}
MPC_DUAL m_tanh(const Dual<S, K>& a) {
  Dual<S, K> r(m_tanh(a.v));
  const S g = S(1) - r.v * r.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * g;
  return r;
}
// |a|: the tangent times sign(a), 0 at 0.
MPC_DUAL m_abs(const Dual<S, K>& a) {
  Dual<S, K> r(m_abs(a.v));
  const S sg = a.v > S(0) ? S(1) : (a.v < S(0) ? S(-1) : S(0));
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * sg;
  return r;
}
// a^e for a constant e: the tangent times e a^(e - 1).
MPC_DUAL m_pow(const Dual<S, K>& a, S e) {
  Dual<S, K> r(m_pow(a.v, e));
  const S g = e * m_pow(a.v, e - S(1));
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * g;
  return r;
}
template <typename S, int K>
MPC_HD S m_value(const Dual<S, K>& a) { return a.v; }
#undef MPC_DUAL

// Mixed widths: a Dual<S, KA> with KA < KB stands for a Dual<S, KB> whose
// tangents KA .. KB - 1 are zero, and their product forms no 0 * x.  Each
// tangent k < KA is formed as the KA-wide product forms it, each k >= KA as
// a plain scalar times a dual number forms it; so a pass that carries both
// tangents rounds each as the two narrower passes did.
template <typename S, int KA, int KB>
MPC_HD std::enable_if_t<(KA < KB), Dual<S, KB>> operator*(
    const Dual<S, KA>& a, const Dual<S, KB>& b) {
  Dual<S, KB> r(a.v * b.v);
#pragma unroll
  for (int k = 0; k < KA; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
#pragma unroll
  for (int k = KA; k < KB; ++k) r.d[k] = a.v * b.d[k];
  return r;
}
template <typename S, int KA, int KB>
MPC_HD std::enable_if_t<(KB < KA), Dual<S, KA>> operator*(
    const Dual<S, KA>& a, const Dual<S, KB>& b) {
  Dual<S, KA> r(a.v * b.v);
#pragma unroll
  for (int k = 0; k < KB; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
#pragma unroll
  for (int k = KB; k < KA; ++k) r.d[k] = a.d[k] * b.v;
  return r;
}

// minimum / maximum of two scalars of one type (plain or dual), NaN
// propagating as torch.minimum / torch.maximum; a dual number keeps the
// tangent of the operand it picks.
template <typename T>
MPC_HD T m_min(const T& a, const T& b) {
  const auto av = m_value(a), bv = m_value(b);
  return (av != av) ? a : ((bv != bv) ? b : (bv < av ? b : a));
}
template <typename T>
MPC_HD T m_max(const T& a, const T& b) {
  const auto av = m_value(a), bv = m_value(b);
  return (av != av) ? a : ((bv != bv) ? b : (bv > av ? b : a));
}

// ---- chain constants, filled from models/arm.py:arm_constants
template <typename S, int NQ>
struct ArmConsts {
  S axis[NQ][3];
  S off[NQ][3];
  S com[NQ][3];
  S mass[NQ];
  S inertia[NQ][3];
  S neg_g[3];
  S damping;
};

// Unpack the flat host array [axes, offsets, coms, masses, inertias, -g,
// damping] (13 NQ + 4 values).
template <typename S, typename F, int NQ>
inline ArmConsts<S, NQ> load_arm(const F* a) {
  ArmConsts<S, NQ> c;
  int t = 0;
  for (int i = 0; i < NQ; ++i)
    for (int r = 0; r < 3; ++r) c.axis[i][r] = S(a[t++]);
  for (int i = 0; i < NQ; ++i)
    for (int r = 0; r < 3; ++r) c.off[i][r] = S(a[t++]);
  for (int i = 0; i < NQ; ++i)
    for (int r = 0; r < 3; ++r) c.com[i][r] = S(a[t++]);
  for (int i = 0; i < NQ; ++i) c.mass[i] = S(a[t++]);
  for (int i = 0; i < NQ; ++i)
    for (int r = 0; r < 3; ++r) c.inertia[i][r] = S(a[t++]);
  for (int r = 0; r < 3; ++r) c.neg_g[r] = S(a[t++]);
  c.damping = S(a[t++]);
  return c;
}

// The 3-vector helpers take operands of two scalar types (a Dual and a
// plain constant, say); the result has the type of their product.
template <typename R, typename A, typename B>
MPC_HD void cross3(const A* a, const B* b, R* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// World-frame link inertia R diag(I) R'.
template <typename T, typename S>
MPC_HD void link_inertia(const T (&R)[3][3], const S* I, T (&Iw)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T acc = (R[r][0] * I[0]) * R[c][0];
      acc = acc + (R[r][1] * I[1]) * R[c][1];
      acc = acc + (R[r][2] * I[2]) * R[c][2];
      Iw[r][c] = acc;
    }
}

template <typename R, typename A, typename B>
MPC_HD void mv3(const A (&M)[3][3], const B* x, R* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = (M[r][0] * x[0] + M[r][1] * x[1]) + M[r][2] * x[2];
}

template <typename A, typename B>
MPC_HD auto dot3(const A* a, const B* b) -> decltype(a[0] * b[0]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// ---- the chain in one sweep from the base: per link the forward
// kinematics (joint origin o, axis z, COM cm, world inertia Iw), its terms
// of the mass matrix (when kMass), and its step of the RNEA forward sweep
// (velocities, accelerations and the link's force F and moment terms G),
// then the RNEA backward sweep for h(q, qd) with qdd = 0 and gravity as a
// base acceleration.  Only o, z, F and G outlive their link, which keeps a
// dual-number pass in registers.  Kinematics and M are in the scalar K,
// velocities, forces and h in the scalar T of qd: K = T for one pass
// through the whole chain; K plain and T a Dual for the tangent of a qd
// direction, on which the kinematics and M do not depend; K = Dual<S, 1>
// and T = Dual<S, 2> for a q and a qd direction in one pass.
template <bool kMass, typename T, typename K, typename S, int NQ>
MPC_HD void arm_chain(const ArmConsts<S, NQ>& c, const K* q, const T* qd,
                      K (&M)[NQ][NQ], T* h) {
  K o[NQ][3], z[NQ][3], Rc[3][3], p[3], o_prev[3];
  T F[NQ][3], G[NQ][3], w_prev[3], al_prev[3], a_prev[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = K(S(0));
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) Rc[r][cc] = K(S(r == cc ? 1 : 0));
    w_prev[r] = T(S(0));
    al_prev[r] = T(S(0));
    a_prev[r] = T(c.neg_g[r]);
    o_prev[r] = K(S(0));
  }
  if (kMass) {
#pragma unroll
    for (int a = 0; a < NQ; ++a)
#pragma unroll
      for (int b = 0; b < NQ; ++b) M[a][b] = K(S(0));
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    // ---- forward kinematics of link i
    const S* ax = c.axis[i];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      p[r] = p[r] + ((Rc[r][0] * c.off[i][0] + Rc[r][1] * c.off[i][1])
                     + Rc[r][2] * c.off[i][2]);
      z[i][r] = (Rc[r][0] * ax[0] + Rc[r][1] * ax[1]) + Rc[r][2] * ax[2];
    }
    // Rodrigues: I + sin K + (1 - cos) K K with K = skew(axis).
    const S Kx[3][3] = {{S(0), -ax[2], ax[1]},
                        {ax[2], S(0), -ax[0]},
                        {-ax[1], ax[0], S(0)}};
    S KK[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        KK[r][cc] = (Kx[r][0] * Kx[0][cc] + Kx[r][1] * Kx[1][cc])
                    + Kx[r][2] * Kx[2][cc];
    K Iw[3][3], cm[3];
    {
      const K s = m_sin(q[i]);
      const K omc = S(1) - m_cos(q[i]);
      K rot[3][3], Rn[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          rot[r][cc] = S(r == cc ? 1 : 0) + (s * Kx[r][cc] + omc * KK[r][cc]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          Rn[r][cc] = (Rc[r][0] * rot[0][cc] + Rc[r][1] * rot[1][cc])
                      + Rc[r][2] * rot[2][cc];
      link_inertia(Rn, c.inertia[i], Iw);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) Rc[r][cc] = Rn[r][cc];
        o[i][r] = p[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
      cm[r] = p[r] + ((Rc[r][0] * c.com[i][0] + Rc[r][1] * c.com[i][1])
                      + Rc[r][2] * c.com[i][2]);

    // ---- link i's terms of M = sum_i m_i Jv_i' Jv_i + Jw_i' Iw_i Jw_i
    if (kMass) {
      K Jv[NQ][3], IwJw[NQ][3];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        K arm[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) arm[r] = cm[r] - o[j][r];
        cross3(z[j], arm, Jv[j]);
        mv3(Iw, z[j], IwJw[j]);
      }
#pragma unroll
      for (int a = 0; a <= i; ++a)
#pragma unroll
        for (int b = a; b <= i; ++b)
          M[a][b] = M[a][b]
                    + (c.mass[i] * dot3(Jv[a], Jv[b]) + dot3(z[a], IwJw[b]));
    }

    // ---- link i's step of the RNEA forward sweep
    K d[3], rc[3];
    T t1[3], t2[3], t3[3], a_oi[3], zqd[3], w[3], al[3], ac[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) d[r] = o[i][r] - o_prev[r];
    cross3(al_prev, d, t1);
    cross3(w_prev, d, t2);
    cross3(w_prev, t2, t3);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      a_oi[r] = a_prev[r] + (t1[r] + t3[r]);
      zqd[r] = z[i][r] * qd[i];
      w[r] = w_prev[r] + zqd[r];
    }
    cross3(w_prev, zqd, t1);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      al[r] = al_prev[r] + t1[r];
      rc[r] = cm[r] - o[i][r];
    }
    cross3(al, rc, t1);
    cross3(w, rc, t2);
    cross3(w, t2, t3);
#pragma unroll
    for (int r = 0; r < 3; ++r) ac[r] = a_oi[r] + (t1[r] + t3[r]);
    // the link's force and its moment terms about o_i (used toward the base)
    T Iwal[3], Iww[3], wIww[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) F[i][r] = c.mass[i] * ac[r];
    mv3(Iw, al, Iwal);
    mv3(Iw, w, Iww);
    cross3(w, Iww, wIww);
    cross3(rc, F[i], t1);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      G[i][r] = (Iwal[r] + wIww[r]) + t1[r];
      w_prev[r] = w[r];
      al_prev[r] = al[r];
      a_prev[r] = a_oi[r];
      o_prev[r] = o[i][r];
    }
  }
  if (kMass) {
#pragma unroll
    for (int a = 0; a < NQ; ++a)
#pragma unroll
      for (int b = 0; b < a; ++b) M[a][b] = M[b][a];
  }
  // ---- RNEA backward sweep of forces and moments toward the base
  T f_child[3], n_child[3];
  K o_child[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    f_child[r] = T(S(0));
    n_child[r] = T(S(0));
    o_child[r] = o[NQ - 1][r];
  }
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    K carm[3];
    T t2[3], ni[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) carm[r] = o_child[r] - o[i][r];
    cross3(carm, f_child, t2);
#pragma unroll
    for (int r = 0; r < 3; ++r) ni[r] = G[i][r] + (n_child[r] + t2[r]);
    h[i] = dot3(z[i], ni);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      f_child[r] = F[i][r] + f_child[r];
      n_child[r] = ni[r];
      o_child[r] = o[i][r];
    }
  }
}

// ---- unrolled Cholesky M = L L' and the solve L L' x = rhs
// (reciprocal-multiply form); S is the plain scalar of the literals.
template <typename S, typename T, int NQ>
MPC_HD void arm_chol(const T (&M)[NQ][NQ], T (&L)[NQ][NQ]) {
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    T s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const T dj = m_sqrt(s);
    L[j][j] = dj;
    const T inv = S(1) / dj;
#pragma unroll
    for (int i = j + 1; i < NQ; ++i) {
      T t = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
}

template <typename S, typename T, int NQ>
MPC_HD void arm_solve(const T (&L)[NQ][NQ], const T* rhs, T* x) {
  T y[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    T s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * (S(1) / L[i][i]);
  }
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < NQ; ++k) s = s - L[k][i] * x[k];
    x[i] = s * (S(1) / L[i][i]);
  }
}

// qdd = M(q)^{-1} (u - h(q, qd) - damping qd) for one instance, the whole
// chain in the scalar T (a Dual for the dual-number Jacobian rows).
template <typename T, typename S, int NQ>
MPC_HD void arm_qdd(const ArmConsts<S, NQ>& c, const T* q, const T* qd,
                    const T* u, T* qdd) {
  T M[NQ][NQ], L[NQ][NQ], h[NQ], rhs[NQ];
  arm_chain<true>(c, q, qd, M, h);
  arm_chol<S>(M, L);
#pragma unroll
  for (int i = 0; i < NQ; ++i) rhs[i] = (u[i] - h[i]) - c.damping * qd[i];
  arm_solve<S>(L, rhs, qdd);
}

// ---- the folded linearization.  qdd = M^{-1} (u - h - D qd) is affine in
// u and M does not depend on qd, so of the 3 NQ columns of d qdd / d[q, qd,
// u] only the q columns need the whole chain:
//   q_j:  M^{-1} (-dM qdd - dh), dM and dh from one single-tangent pass;
//   qd_j: -M^{-1} (dh + D e_j), dh from the RNEA alone over plain
//         kinematics;
//   u_j:  M^{-1} e_j,
// each solve with the Cholesky factor L of the value part; or q_j and qd_j
// from one sweep that carries both tangents (`arm_q_qd_columns`).

// The value part in plain scalars: L and qdd.
template <typename S, int NQ>
MPC_HD void arm_value(const ArmConsts<S, NQ>& c, const S* q, const S* qd,
                      const S* u, S (&L)[NQ][NQ], S* qdd) {
  S M[NQ][NQ], h[NQ], rhs[NQ];
  arm_chain<true>(c, q, qd, M, h);
  arm_chol<S>(M, L);
#pragma unroll
  for (int i = 0; i < NQ; ++i) rhs[i] = (u[i] - h[i]) - c.damping * qd[i];
  arm_solve<S>(L, rhs, qdd);
}

// The q_j column, with the value part (L, qdd) from the same pass.
template <typename S, int NQ>
MPC_HD void arm_q_column(const ArmConsts<S, NQ>& c, const S* q, const S* qd,
                         const S* u, int j, S (&L)[NQ][NQ], S* qdd,
                         S* col) {
  typedef Dual<S, 1> D;
  D qs[NQ], qds[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    qs[i] = D(q[i]);
    qs[i].d[0] = S(i == j ? 1 : 0);
    qds[i] = D(qd[i]);
  }
  D M[NQ][NQ], h[NQ];
  arm_chain<true>(c, qs, qds, M, h);
  S Mv[NQ][NQ], rhs[NQ];
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int b = 0; b < NQ; ++b) Mv[a][b] = M[a][b].v;
  arm_chol<S>(Mv, L);
#pragma unroll
  for (int i = 0; i < NQ; ++i) rhs[i] = (u[i] - h[i].v) - c.damping * qd[i];
  arm_solve<S>(L, rhs, qdd);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S acc = -h[i].d[0];
#pragma unroll
    for (int t = 0; t < NQ; ++t) acc = acc - M[i][t].d[0] * qdd[t];
    rhs[i] = acc;
  }
  arm_solve<S>(L, rhs, col);
}

// The qd_j column.
template <typename S, int NQ>
MPC_HD void arm_qd_column(const ArmConsts<S, NQ>& c, const S* q, const S* qd,
                          int j, const S (&L)[NQ][NQ], S* col) {
  typedef Dual<S, 1> D;
  S M[NQ][NQ];                         // not formed: M does not depend on qd
  D qds[NQ], h[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    qds[i] = D(qd[i]);
    qds[i].d[0] = S(i == j ? 1 : 0);
  }
  arm_chain<false>(c, q, qds, M, h);
  S rhs[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    rhs[i] = -h[i].d[0] - (i == j ? c.damping : S(0));
  arm_solve<S>(L, rhs, col);
}

// The q_j and qd_j columns and the value part (L, qdd) from one sweep of
// the chain: the kinematics and M carry the q_j tangent, the velocities,
// forces and h the q_j and the qd_j tangents.  Every value and tangent is
// formed by the operations, in the order, of `arm_q_column` and
// `arm_qd_column`, whose qd pass forms the chain's values once more.
template <typename S, int NQ>
MPC_HD void arm_q_qd_columns(const ArmConsts<S, NQ>& c, const S* q,
                             const S* qd, const S* u, int j,
                             S (&L)[NQ][NQ], S* qdd, S* col_q, S* col_qd) {
  typedef Dual<S, 1> K;
  typedef Dual<S, 2> T;
  K qs[NQ], M[NQ][NQ];
  T qds[NQ], h[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    qs[i] = K(q[i]);
    qs[i].d[0] = S(i == j ? 1 : 0);
    qds[i] = T(qd[i]);
    qds[i].d[1] = S(i == j ? 1 : 0);
  }
  arm_chain<true>(c, qs, qds, M, h);
  S Mv[NQ][NQ], rhs[NQ];
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int b = 0; b < NQ; ++b) Mv[a][b] = M[a][b].v;
  arm_chol<S>(Mv, L);
#pragma unroll
  for (int i = 0; i < NQ; ++i) rhs[i] = (u[i] - h[i].v) - c.damping * qd[i];
  arm_solve<S>(L, rhs, qdd);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S acc = -h[i].d[0];
#pragma unroll
    for (int t = 0; t < NQ; ++t) acc = acc - M[i][t].d[0] * qdd[t];
    rhs[i] = acc;
  }
  arm_solve<S>(L, rhs, col_q);
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    rhs[i] = -h[i].d[1] - (i == j ? c.damping : S(0));
  arm_solve<S>(L, rhs, col_qd);
}

// The u_j column.
template <typename S, int NQ>
MPC_HD void arm_u_column(const S (&L)[NQ][NQ], int j, S* col) {
  S rhs[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) rhs[i] = S(i == j ? 1 : 0);
  arm_solve<S>(L, rhs, col);
}

}  // namespace mpc
