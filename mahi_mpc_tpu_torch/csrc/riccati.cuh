// One instance's LQR solve by Riccati recursion: the body of the Riccati
// kernel, written once for the device (csrc/riccati.cu) and the host
// (riccati_cpu.cpp, built only by the tests, like Pallas' interpret mode).
//
// It computes what `_riccati_kernel` in mahi_mpc_tpu/solver/pallas_riccati.py
// computes for one lane: the backward sweep k = N-1..0 forms the Q blocks
// from the cost-to-go (P, p), factors Quu by an unrolled Cholesky, stores
// the gains K = -Quu^-1 Qzu' and kff, and symmetrises the next P; the
// forward rollout from dz_0 = 0 gives du_k = K_k dz_k + kff_k and
// dz_{k+1} = Az dz_k + Bz du_k + r_k.
//
// Arrays are batch-innermost, the lanes layout of `solve_lqr_pallas_lanes`:
// element e of stage k of an array with S elements a stage is at
// p[(k * S + e) * B + b], so neighbouring threads read neighbouring
// addresses.  Rules the arithmetic keeps (the CPU tests pin them):
//   * the Cholesky divides by the pivot and takes sqrt of it as it is, as
//     `_chol_lanes` does: a pivot that is not positive gives NaN, never a
//     clamp, and the SQP's finite-step guard rejects that instance's step;
//   * every literal is a constant of the scalar type T, so float code does
//     no FP64 arithmetic;
//   * sums run in the order of the plain version (riccati_kernel.py), but
//     nvcc contracts a*b+c into fused multiply-adds, so the kernel agrees
//     with the plain version to roundoff, not bitwise: the tests' bands are
//     roundoff bands.
#pragma once

#include <math.h>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#endif

#if defined(__CUDACC__)
#define RIC_HD __host__ __device__ __forceinline__
#else
#define RIC_HD inline
#endif

// The (nz, nu) stage shapes the library is built for: mahi_arm (12, 4);
// two_link_arm and double_pendulum (6, 2); cartpole and acrobot (5, 1);
// pendulum (3, 1).  solver/riccati_kernel.py KERNEL_SHAPES lists the same.
#define MPC_RICCATI_SHAPES(X) X(12, 4) X(6, 2) X(5, 1) X(3, 1)

namespace mpc_riccati {

constexpr int kNumPtrs = 14;

RIC_HD float ric_sqrt(float x) { return sqrtf(x); }
RIC_HD double ric_sqrt(double x) { return sqrt(x); }

template <typename T>
struct RiccatiArgs {
  long long B;
  int N;
  // inputs: Az (N,nz,nz,B) Bz (N,nz,nu,B) r (N,nz,B) Hzz (N,nz,nz,B)
  // Hzu (N,nz,nu,B) Huu (N,nu,nu,B) gz (N,nz,B) gu (N,nu,B) Hf (nz,nz,B)
  // gf (nz,B)
  const T *Az, *Bz, *r, *Hzz, *Hzu, *Huu, *gz, *gu, *Hf, *gf;
  // outputs dz (N+1,nz,B) du (N,nu,B); scratch K (N,nu,nz,B) kff (N,nu,B)
  T *dz, *du, *K, *kff;
};

// Arguments from the flat C interface: kNumPtrs pointers in the order of
// the struct.
template <typename T>
inline RiccatiArgs<T> make_args(long long B, int N, void* const* ptrs) {
  RiccatiArgs<T> a;
  a.B = B;
  a.N = N;
  const T** in[] = {&a.Az, &a.Bz, &a.r, &a.Hzz, &a.Hzu, &a.Huu,
                    &a.gz, &a.gu, &a.Hf, &a.gf};
  T** out[] = {&a.dz, &a.du, &a.K, &a.kff};
  int t = 0;
  for (const T** p : in) *p = static_cast<const T*>(ptrs[t++]);
  for (T** p : out) *p = static_cast<T*>(ptrs[t++]);
  return a;
}

template <typename T, int NZ, int NU>
RIC_HD void riccati_instance(const RiccatiArgs<T>& a, long long b) {
  const long long B = a.B;
  const int N = a.N;
  // Stage k, element e of an array with S elements a stage.
#define RIC_AT(p, k, S, e) (p)[((long long)(k) * (S) + (e)) * B + b]

  T P[NZ][NZ], p[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    p[i] = RIC_AT(a.gf, 0, NZ, i);
#pragma unroll
    for (int j = 0; j < NZ; ++j) P[i][j] = RIC_AT(a.Hf, 0, NZ * NZ, i * NZ + j);
  }

  // ---- backward sweep
  for (int k = N - 1; k >= 0; --k) {
    T A[NZ][NZ], Bm[NZ][NU], Prp[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j < NZ; ++j) A[i][j] = RIC_AT(a.Az, k, NZ * NZ, i * NZ + j);
#pragma unroll
      for (int c = 0; c < NU; ++c) Bm[i][c] = RIC_AT(a.Bz, k, NZ * NU, i * NU + c);
    }
    // Prp = p + P r
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NZ; ++j) s = s + P[i][j] * RIC_AT(a.r, k, NZ, j);
      Prp[i] = p[i] + s;
    }
    // Qzz = Hzz + (A'P) A and Qzu = Hzu + (A'P) B, one row of A'P at a time
    // (A'P is never held whole).
    T Qzz[NZ][NZ], Qzu[NZ][NU], qz[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T row[NZ];
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + A[m][i] * P[m][j];
        row[j] = s;
      }
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + row[m] * A[m][j];
        Qzz[i][j] = RIC_AT(a.Hzz, k, NZ * NZ, i * NZ + j) + s;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + row[m] * Bm[m][c];
        Qzu[i][c] = RIC_AT(a.Hzu, k, NZ * NU, i * NU + c) + s;
      }
      T s = T(0);
#pragma unroll
      for (int m = 0; m < NZ; ++m) s = s + A[m][i] * Prp[m];
      qz[i] = RIC_AT(a.gz, k, NZ, i) + s;
    }
    // Quu = Huu + (B'P) B and qu = gu + B' Prp.
    T Quu[NU][NU], qu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T row[NZ];
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + Bm[m][i] * P[m][j];
        row[j] = s;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + row[m] * Bm[m][c];
        Quu[i][c] = RIC_AT(a.Huu, k, NU * NU, i * NU + c) + s;
      }
      T s = T(0);
#pragma unroll
      for (int m = 0; m < NZ; ++m) s = s + Bm[m][i] * Prp[m];
      qu[i] = RIC_AT(a.gu, k, NU, i) + s;
    }

    // Cholesky of Quu, `_chol_lanes` order: division by the pivot.
    T L[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s = Quu[i][j];
#pragma unroll
        for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
        L[i][j] = (i == j) ? ric_sqrt(s) : s / L[j][j];
      }
    }
    // [K | kff] = -(L L')^-1 [Qzu' | qu]: forward, then back substitution
    // over NZ + 1 right-hand columns (`_cho_solve_mat`).
    T X[NU][NZ + 1];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int c = 0; c <= NZ; ++c) {
        T s = (c < NZ) ? Qzu[c][i] : qu[i];
#pragma unroll
        for (int m = 0; m < i; ++m) s = s - L[i][m] * X[m][c];
        X[i][c] = s / L[i][i];
      }
    }
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
#pragma unroll
      for (int c = 0; c <= NZ; ++c) {
        T s = X[i][c];
#pragma unroll
        for (int m = i + 1; m < NU; ++m) s = s - L[m][i] * X[m][c];
        X[i][c] = s / L[i][i];
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int c = 0; c <= NZ; ++c) X[i][c] = -X[i][c];
#pragma unroll
      for (int c = 0; c < NZ; ++c) RIC_AT(a.K, k, NU * NZ, i * NZ + c) = X[i][c];
      RIC_AT(a.kff, k, NU, i) = X[i][NZ];
    }

    // P = sym(Qzz + Qzu K), p = qz + Qzu kff.
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        T s = T(0);
#pragma unroll
        for (int c = 0; c < NU; ++c) s = s + Qzu[i][c] * X[c][j];
        Qzz[i][j] = Qzz[i][j] + s;
      }
      T s = T(0);
#pragma unroll
      for (int c = 0; c < NU; ++c) s = s + Qzu[i][c] * X[c][NZ];
      p[i] = qz[i] + s;
    }
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j < NZ; ++j) P[i][j] = T(0.5) * (Qzz[i][j] + Qzz[j][i]);
    }
  }

  // ---- forward rollout, dz_0 = 0 (node 0 is pinned to the measurement)
  T dz[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    dz[i] = T(0);
    RIC_AT(a.dz, 0, NZ, i) = T(0);
  }
  for (int k = 0; k < N; ++k) {
    T du[NU], dzn[NZ];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NZ; ++j) s = s + RIC_AT(a.K, k, NU * NZ, i * NZ + j) * dz[j];
      du[i] = s + RIC_AT(a.kff, k, NU, i);
      RIC_AT(a.du, k, NU, i) = du[i];
    }
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T sa = T(0), sb = T(0);
#pragma unroll
      for (int j = 0; j < NZ; ++j) sa = sa + RIC_AT(a.Az, k, NZ * NZ, i * NZ + j) * dz[j];
#pragma unroll
      for (int c = 0; c < NU; ++c) sb = sb + RIC_AT(a.Bz, k, NZ * NU, i * NU + c) * du[c];
      dzn[i] = (sa + sb) + RIC_AT(a.r, k, NZ, i);
    }
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      dz[i] = dzn[i];
      RIC_AT(a.dz, k + 1, NZ, i) = dz[i];
    }
  }
#undef RIC_AT
}

}  // namespace mpc_riccati
