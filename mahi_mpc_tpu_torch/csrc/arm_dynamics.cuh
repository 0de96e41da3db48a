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
#undef MPC_DUAL

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

template <typename T>
MPC_HD void cross3(const T* a, const T* b, T* out) {
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

template <typename T>
MPC_HD void mv3(const T (&A)[3][3], const T* x, T* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = (A[r][0] * x[0] + A[r][1] * x[1]) + A[r][2] * x[2];
}

template <typename T>
MPC_HD T dot3(const T* a, const T* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// qdd = M(q)^{-1} (u - h(q, qd) - damping qd) for one instance.
template <typename T, typename S, int NQ>
MPC_HD void arm_qdd(const ArmConsts<S, NQ>& c, const T* q, const T* qd,
                    const T* u, T* qdd) {
  // ---- forward kinematics: joint origins o, axes z, COMs cm, rotations R
  T o[NQ][3], z[NQ][3], cm[NQ][3], R[NQ][3][3];
  T Rc[3][3], p[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = T(S(0));
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) Rc[r][cc] = T(S(r == cc ? 1 : 0));
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
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
    const T s = m_sin(q[i]);
    const T omc = S(1) - m_cos(q[i]);
    T rot[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        rot[r][cc] = S(r == cc ? 1 : 0) + (s * Kx[r][cc] + omc * KK[r][cc]);
    T Rn[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        Rn[r][cc] = (Rc[r][0] * rot[0][cc] + Rc[r][1] * rot[1][cc])
                    + Rc[r][2] * rot[2][cc];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        Rc[r][cc] = Rn[r][cc];
        R[i][r][cc] = Rn[r][cc];
      }
      o[i][r] = p[r];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
      cm[i][r] = p[r] + ((Rc[r][0] * c.com[i][0] + Rc[r][1] * c.com[i][1])
                         + Rc[r][2] * c.com[i][2]);
  }

  // ---- mass matrix: sum_i m_i Jv_i' Jv_i + Jw_i' Iw_i Jw_i (upper, mirror)
  T M[NQ][NQ];
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int b = 0; b < NQ; ++b) M[a][b] = T(S(0));
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    T Jv[NQ][3], IwJw[NQ][3], Iw[3][3];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T arm[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) arm[r] = cm[i][r] - o[j][r];
      cross3(z[j], arm, Jv[j]);
    }
    link_inertia(R[i], c.inertia[i], Iw);
#pragma unroll
    for (int j = 0; j <= i; ++j) mv3(Iw, z[j], IwJw[j]);
#pragma unroll
    for (int a = 0; a <= i; ++a)
#pragma unroll
      for (int b = a; b <= i; ++b)
        M[a][b] = M[a][b]
                  + (c.mass[i] * dot3(Jv[a], Jv[b]) + dot3(z[a], IwJw[b]));
  }
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b) M[a][b] = M[b][a];

  // ---- RNEA bias with qdd = 0: forward sweep of velocities/accelerations
  T w[NQ][3], al[NQ][3], ac[NQ][3];
  T w_prev[3], al_prev[3], a_prev[3], o_prev[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    w_prev[r] = T(S(0));
    al_prev[r] = T(S(0));
    a_prev[r] = T(c.neg_g[r]);
    o_prev[r] = T(S(0));
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    T d[3], t1[3], t2[3], t3[3], a_oi[3], zqd[3], rc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) d[r] = o[i][r] - o_prev[r];
    cross3(al_prev, d, t1);
    cross3(w_prev, d, t2);
    cross3(w_prev, t2, t3);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      a_oi[r] = a_prev[r] + (t1[r] + t3[r]);
      zqd[r] = z[i][r] * qd[i];
      w[i][r] = w_prev[r] + zqd[r];
    }
    cross3(w_prev, zqd, t1);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      al[i][r] = al_prev[r] + t1[r];
      rc[r] = cm[i][r] - o[i][r];
    }
    cross3(al[i], rc, t1);
    cross3(w[i], rc, t2);
    cross3(w[i], t2, t3);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ac[i][r] = a_oi[r] + (t1[r] + t3[r]);
      w_prev[r] = w[i][r];
      al_prev[r] = al[i][r];
      a_prev[r] = a_oi[r];
      o_prev[r] = o[i][r];
    }
  }
  // ---- backward sweep of forces and moments toward the base
  T h[NQ];
  T f_child[3], n_child[3], o_child[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    f_child[r] = T(S(0));
    n_child[r] = T(S(0));
    o_child[r] = o[NQ - 1][r];
  }
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    T Iw[3][3], F[3], Iwal[3], Iww[3], wIww[3], Ni[3], marm[3], carm[3];
    T t1[3], t2[3], ni[3];
    link_inertia(R[i], c.inertia[i], Iw);
#pragma unroll
    for (int r = 0; r < 3; ++r) F[r] = c.mass[i] * ac[i][r];
    mv3(Iw, al[i], Iwal);
    mv3(Iw, w[i], Iww);
    cross3(w[i], Iww, wIww);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      Ni[r] = Iwal[r] + wIww[r];
      marm[r] = cm[i][r] - o[i][r];
      carm[r] = o_child[r] - o[i][r];
    }
    cross3(marm, F, t1);
    cross3(carm, f_child, t2);
#pragma unroll
    for (int r = 0; r < 3; ++r) ni[r] = (Ni[r] + t1[r]) + (n_child[r] + t2[r]);
    h[i] = dot3(z[i], ni);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      f_child[r] = F[r] + f_child[r];
      n_child[r] = ni[r];
      o_child[r] = o[i][r];
    }
  }

  // ---- qdd = M^{-1} rhs by unrolled Cholesky (reciprocal-multiply form)
  T L[NQ][NQ], y[NQ];
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
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    T s = (u[i] - h[i]) - c.damping * qd[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * (S(1) / L[i][i]);
  }
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < NQ; ++k) s = s - L[k][i] * qdd[k];
    qdd[i] = s * (S(1) / L[i][i]);
  }
}

}  // namespace mpc
