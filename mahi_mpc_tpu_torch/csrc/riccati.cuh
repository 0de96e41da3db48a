// One instance's LQR solve by Riccati recursion on a group of G threads: the
// body of the Riccati kernel, written once for the device (csrc/riccati.cu)
// and the host (riccati_cpu.cpp, built only by the tests, like Pallas'
// interpret mode).
//
// It computes what `_riccati_kernel` in mahi_mpc_tpu/solver/pallas_riccati.py
// computes for one lane: the backward sweep k = N-1..0 forms the Q blocks
// from the cost-to-go (P, p), factors Quu by an unrolled Cholesky, stores
// the gains K = -Quu^-1 Qzu' and kff, and symmetrises the next P; the
// forward rollout from dz_0 = 0 gives du_k = K_k dz_k + kff_k and
// dz_{k+1} = Az dz_k + Bz du_k + r_k.
//
// Arrays are batch-leading, the layout `build_stage_qp` returns: stage k of
// instance b of a field with S elements a stage is the S contiguous
// elements at p[(b * N + k) * S], so one instance's stage block of a field
// is one contiguous run (576 B for Az at nz = 12).
//
// The group: lane i owns row i of P, p and the Q blocks (i < nz); lane c
// solves right-hand column c of [K | kff] (c <= nz); the lanes c < nu form
// du_c in the rollout.  Per instance the group has a tile in shared memory:
// two stage buffers (the block of stage k is computed on while the block of
// the next stage is copied into the other one, `fetch`), the cost-to-go P,
// the unsymmetrised next P, and the small shared terms (P r + p, P Bz, Quu,
// qu, [K | kff]).  What a lane keeps from one phase to the next (its rows of
// Qzz and Qzu, qz_i, p_i) lives in its `Own` slot.
//
// The body is a sequence of phases.  On the device the G lanes run a phase
// at once and meet at a `__syncwarp` of the group; on the host one thread
// runs the lanes of a phase one after another over a local tile (the copies
// are plain loops there, the shuffles read the lane's slot).  So the g++
// build runs this body's own arithmetic.
//
// Rules the arithmetic keeps (the CPU tests pin them):
//   * the Cholesky divides by the pivot and takes sqrt of it as it is, as
//     `_chol_lanes` does: a pivot that is not positive gives NaN, never a
//     clamp, and the SQP's finite-step guard rejects that instance's step.
//     A NaN stays in its instance: no value crosses between groups;
//   * every literal is a constant of the scalar type T, so float code does
//     no FP64 arithmetic;
//   * no fast-math; each sum runs over its terms in index order, but the
//     products are grouped as B'(P B), not (B'P) B, and nvcc contracts
//     a*b+c into fused multiply-adds, so the kernel agrees with the plain
//     version to roundoff, not bitwise: the tests' bands are roundoff bands.
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
  // inputs: Az (B,N,nz,nz) Bz (B,N,nz,nu) r (B,N,nz) Hzz (B,N,nz,nz)
  // Hzu (B,N,nz,nu) Huu (B,N,nu,nu) gz (B,N,nz) gu (B,N,nu) Hf (B,nz,nz)
  // gf (B,nz), each contiguous and 16-byte aligned
  const T *Az, *Bz, *r, *Hzz, *Hzu, *Huu, *gz, *gu, *Hf, *gf;
  // outputs dz (B,N+1,nz) du (B,N,nu); scratch K (B,N,nu,nz) kff (B,N,nu)
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

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The group size and the tile layout (in elements) of stage shape (NZ, NU).
// Every slot starts on a multiple of four elements, so 16-byte copies land
// aligned.
template <int NZ, int NU>
struct RicShape {
  static constexpr int G = NZ + 1 <= 4 ? 4 : (NZ + 1 <= 8 ? 8 : 16);
  static constexpr int NT = NU * (NU + 1) / 2;   // Quu's lower triangle
  static_assert(NZ + 1 <= G && NT + NU <= G, "group too small");
  // one stage block: Az Bz r Hzz Hzu Huu gz gu (the rollout reuses the
  // Hzz slot for K and the Huu slot for kff)
  static constexpr int kAz = 0, kBz = kAz + pad4(NZ * NZ),
                       kr = kBz + pad4(NZ * NU), kHzz = kr + pad4(NZ),
                       kHzu = kHzz + pad4(NZ * NZ),
                       kHuu = kHzu + pad4(NZ * NU), kgz = kHuu + pad4(NU * NU),
                       kgu = kgz + pad4(NZ), kStage = kgu + pad4(NU);
  static constexpr int kK = kHzz, kkff = kHuu;
  static_assert(NU * NZ <= pad4(NZ * NZ) && NU <= pad4(NU * NU), "reuse");
  // the tile: two stage buffers, P, the next P before symmetrisation, and
  // the shared terms; [K | kff] as X[a][c], row stride NR (a multiple of 4)
  static constexpr int NR = pad4(NZ + 1);
  static constexpr int kP = 2 * kStage, kPn = kP + pad4(NZ * NZ),
                       kPrp = kPn + pad4(NZ * NZ), kPB = kPrp + pad4(NZ),
                       kQuu = kPB + pad4(NZ * NU), kqu = kQuu + pad4(NU * NU),
                       kX = kqu + pad4(NU), kEnd = kX + NU * NR;
  // A tile size = G (mod 32): the broadcast reads of the 32 / G groups of a
  // warp fall on different banks.
  static constexpr int kSize = kEnd + ((G - kEnd % 32) + 32) % 32;
};

#if defined(__CUDA_ARCH__)
// Asynchronous copy of CH bytes global -> shared (cp.async: 16-byte copies
// bypass L1, smaller ones cannot).
template <int CH>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (CH == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(CH)
                 : "memory");
  }
}
#endif

// Close this thread's copies issued since the last commit into a group.
RIC_HD void ric_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until this thread's copies have landed (the group barrier that
// follows makes them visible to the other lanes).
RIC_HD void ric_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// The copy unit of a block of S elements: 16, 8 or 4 bytes, the largest
// that divides it (the wrapper hands 16-byte aligned arrays, so every stage
// block of a field is aligned to its unit), and the block's units.
template <typename T, int S>
__host__ __device__ constexpr int chunk_bytes() {
  return (S * (int)sizeof(T)) % 16 == 0 ? 16
         : (S * (int)sizeof(T)) % 8 == 0 ? 8 : 4;
}
template <typename T, int S>
__host__ __device__ constexpr int chunks() {
  return S * (int)sizeof(T) / chunk_bytes<T, S>();
}

// Lane `lane`'s share of copying S contiguous elements src -> dst (shared):
// unit c goes to lane (c + first) % G, so the fields of a stage spread over
// the lanes.  The host copies elements instead.
template <typename T, int S, int G>
RIC_HD void fetch(T* dst, const T* src, int lane, int first) {
  const int start = ((lane - first) % G + G) % G;
#if defined(__CUDA_ARCH__)
  constexpr int CH = chunk_bytes<T, S>();
  for (int c = start; c < chunks<T, S>(); c += G)
    cp_async<CH>(reinterpret_cast<char*>(dst) + c * CH,
                 reinterpret_cast<const char*>(src) + c * CH);
#else
  for (int e = start; e < S; e += G) dst[e] = src[e];
#endif
}

// The lanes of one instance: `phase(f)` runs f(lane) for each lane and then
// a group barrier; `from_lane(v, src)` is lane src's value of a quantity
// set in an earlier phase (v: this thread's slot on the device, every
// lane's slots on the host).
// V consecutive elements of shared memory, src aligned to V elements (one
// 8- or 16-byte load on the device for float: a group's lanes mostly read
// the same address, so the load is a broadcast).
template <int V, typename T>
RIC_HD void vld(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  if constexpr (V == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
    return;
  } else if constexpr (V == 2 && sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
    return;
  }
#endif
  for (int v = 0; v < V; ++v) dst[v] = src[v];
}

// The widest of 4, 2, 1 elements that divides n.
__host__ __device__ constexpr int vec_width(int n) {
  return n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1);
}

template <int G>
struct RicGroup {
  int lane;
  unsigned mask;
#if defined(__CUDA_ARCH__)
  static constexpr int kHostLanes = 1;   // each thread holds its own lane
#else
  static constexpr int kHostLanes = G;
#endif
  template <typename F>
  RIC_HD void phase(const F& f) const {
#if defined(__CUDA_ARCH__)
    f(lane);
    __syncwarp(mask);
#else
    for (int l = 0; l < G; ++l) f(l);
#endif
  }
  RIC_HD static int slot(int l) {
#if defined(__CUDA_ARCH__)
    return 0;
#else
    return l;
#endif
  }
  template <typename T>
  RIC_HD T from_lane(const T* v, int src) const {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(mask, v[0], src, G);
#else
    return v[src];
#endif
  }
};

template <typename T, int NZ, int NU>
RIC_HD void riccati_group(const RiccatiArgs<T>& a, long long b,
                          const RicGroup<RicShape<NZ, NU>::G>& g, T* tile) {
  typedef RicShape<NZ, NU> Sh;
  constexpr int G = Sh::G, NR = Sh::NR, V = vec_width(NZ),
                VU = vec_width(NU);
  constexpr int kHost = RicGroup<G>::kHostLanes;
  const int N = a.N;
  // This instance's arrays.
  const long long n = N;
  const T* Az = a.Az + b * n * (NZ * NZ);
  const T* Bz = a.Bz + b * n * (NZ * NU);
  const T* r = a.r + b * n * NZ;
  const T* Hzz = a.Hzz + b * n * (NZ * NZ);
  const T* Hzu = a.Hzu + b * n * (NZ * NU);
  const T* Huu = a.Huu + b * n * (NU * NU);
  const T* gz = a.gz + b * n * NZ;
  const T* gu = a.gu + b * n * NU;
  const T* Hf = a.Hf + b * (NZ * NZ);
  const T* gf = a.gf + b * NZ;
  T* dz = a.dz + b * (n + 1) * NZ;
  T* du = a.du + b * n * NU;
  T* K = a.K + b * n * (NU * NZ);
  T* kff = a.kff + b * n * NU;

  T* const P = tile + Sh::kP;
  T* const Pn = tile + Sh::kPn;
  T* const Prp = tile + Sh::kPrp;
  T* const PB = tile + Sh::kPB;
  T* const Quu = tile + Sh::kQuu;
  T* const qu = tile + Sh::kqu;
  T* const X = tile + Sh::kX;
  auto buf = [&](int s) { return tile + (s & 1) * Sh::kStage; };

  // Lane l's copies of the backward sweep's stage k into dst.
  auto fetch_back = [&](int k, T* dst, int l) {
    constexpr int o1 = chunks<T, NZ * NZ>(), o2 = o1 + chunks<T, NZ * NU>(),
                  o3 = o2 + chunks<T, NZ>(), o4 = o3 + chunks<T, NZ * NZ>(),
                  o5 = o4 + chunks<T, NZ * NU>(),
                  o6 = o5 + chunks<T, NU * NU>(), o7 = o6 + chunks<T, NZ>();
    fetch<T, NZ * NZ, G>(dst + Sh::kAz, Az + k * (NZ * NZ), l, 0);
    fetch<T, NZ * NU, G>(dst + Sh::kBz, Bz + k * (NZ * NU), l, o1);
    fetch<T, NZ, G>(dst + Sh::kr, r + k * NZ, l, o2);
    fetch<T, NZ * NZ, G>(dst + Sh::kHzz, Hzz + k * (NZ * NZ), l, o3);
    fetch<T, NZ * NU, G>(dst + Sh::kHzu, Hzu + k * (NZ * NU), l, o4);
    fetch<T, NU * NU, G>(dst + Sh::kHuu, Huu + k * (NU * NU), l, o5);
    fetch<T, NZ, G>(dst + Sh::kgz, gz + k * NZ, l, o6);
    fetch<T, NU, G>(dst + Sh::kgu, gu + k * NU, l, o7);
    ric_commit();
  };
  // ... and of the rollout's stage k: Az, Bz, r and the gains.
  auto fetch_fwd = [&](int k, T* dst, int l) {
    constexpr int o1 = chunks<T, NZ * NZ>(), o2 = o1 + chunks<T, NZ * NU>(),
                  o3 = o2 + chunks<T, NZ>(), o4 = o3 + chunks<T, NU * NZ>();
    fetch<T, NZ * NZ, G>(dst + Sh::kAz, Az + k * (NZ * NZ), l, 0);
    fetch<T, NZ * NU, G>(dst + Sh::kBz, Bz + k * (NZ * NU), l, o1);
    fetch<T, NZ, G>(dst + Sh::kr, r + k * NZ, l, o2);
    fetch<T, NU * NZ, G>(dst + Sh::kK, K + k * (NU * NZ), l, o3);
    fetch<T, NU, G>(dst + Sh::kkff, kff + k * NU, l, o4);
    ric_commit();
  };

  // What a lane keeps between phases: its rows of Qzz and Qzu, qz_i, p_i.
  struct Own {
    T Qzz[NZ], Qzu[NU], qz, p;
  };
  Own own[kHost];

  // ---- the terminal cost-to-go, and stage N-1 into the first buffer
  g.phase([&](int l) {
    if (l < NZ) {
      for (int j = 0; j < NZ; ++j) P[l * NZ + j] = Hf[l * NZ + j];
      own[g.slot(l)].p = gf[l];
    }
    fetch_back(N - 1, buf(0), l);
    ric_wait();
  });

  // ---- backward sweep.  Every sum runs over its terms in index order;
  // where a loop runs over rows m outside the columns j, it accumulates
  // each column's sum in that order all the same.
#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    const T* S = buf(N - 1 - k);
    T* const next = buf(N - k);

    // (1) copy stage k-1 into the other buffer; P r + p, P Bz, and this
    // lane's rows of A'P, Qzz = Hzz + (A'P) A and Qzu = Hzu + (A'P) B
    g.phase([&](int l) {
      if (k > 0) fetch_back(k - 1, next, l);
      if (l < NZ) {
        Own& o = own[g.slot(l)];
        const int i = l;
        T Pi[NZ], v[NZ], ac[NZ], row[NZ], bm[NU];
#pragma unroll
        for (int j = 0; j < NZ; j += V) {
          vld<V>(Pi + j, P + i * NZ + j);
          vld<V>(v + j, S + Sh::kr + j);
        }
        T s = T(0);
#pragma unroll
        for (int j = 0; j < NZ; ++j) s = s + Pi[j] * v[j];
        Prp[i] = o.p + s;
        // row = (A'P)_i: column i of A against the rows of P
#pragma unroll
        for (int m = 0; m < NZ; ++m) ac[m] = S[Sh::kAz + m * NZ + i];
#pragma unroll
        for (int j = 0; j < NZ; ++j) row[j] = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) {
#pragma unroll
          for (int j = 0; j < NZ; j += V) vld<V>(v + j, P + m * NZ + j);
#pragma unroll
          for (int j = 0; j < NZ; ++j) row[j] = row[j] + ac[m] * v[j];
        }
        // (A'P)_i A, and (P B)_i, (A'P B)_i from the same rows of B
        T q[NZ], pb[NU], qb[NU];
#pragma unroll
        for (int j = 0; j < NZ; ++j) q[j] = T(0);
#pragma unroll
        for (int c = 0; c < NU; ++c) pb[c] = qb[c] = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) {
#pragma unroll
          for (int j = 0; j < NZ; j += V)
            vld<V>(v + j, S + Sh::kAz + m * NZ + j);
#pragma unroll
          for (int j = 0; j < NZ; ++j) q[j] = q[j] + row[m] * v[j];
#pragma unroll
          for (int c = 0; c < NU; c += VU)
            vld<VU>(bm + c, S + Sh::kBz + m * NU + c);
#pragma unroll
          for (int c = 0; c < NU; ++c) {
            pb[c] = pb[c] + Pi[m] * bm[c];
            qb[c] = qb[c] + row[m] * bm[c];
          }
        }
#pragma unroll
        for (int j = 0; j < NZ; j += V)
          vld<V>(v + j, S + Sh::kHzz + i * NZ + j);
#pragma unroll
        for (int j = 0; j < NZ; ++j) o.Qzz[j] = v[j] + q[j];
#pragma unroll
        for (int c = 0; c < NU; c += VU)
          vld<VU>(bm + c, S + Sh::kHzu + i * NU + c);
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          o.Qzu[c] = bm[c] + qb[c];
          PB[i * NU + c] = pb[c];
        }
      }
    });

    // (2) qz_i = gz_i + (A' Prp)_i; lanes < NT one entry of Quu's lower
    // triangle, Huu + B'(P B); the next NU lanes qu = gu + B' Prp
    g.phase([&](int l) {
      T pr[NZ];
#pragma unroll
      for (int j = 0; j < NZ; j += V) vld<V>(pr + j, Prp + j);
      if (l < NZ) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + S[Sh::kAz + m * NZ + l] * pr[m];
        own[g.slot(l)].qz = S[Sh::kgz + l] + s;
      }
      if (l < Sh::NT) {
        int i = 0;
        while (l >= (i + 1) * (i + 2) / 2) ++i;
        const int j = l - i * (i + 1) / 2;
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m)
          s = s + S[Sh::kBz + m * NU + i] * PB[m * NU + j];
        Quu[i * NU + j] = S[Sh::kHuu + i * NU + j] + s;
      } else if (l < Sh::NT + NU) {
        const int c = l - Sh::NT;
        T s = T(0);
#pragma unroll
        for (int m = 0; m < NZ; ++m) s = s + S[Sh::kBz + m * NU + c] * pr[m];
        qu[c] = S[Sh::kgu + c] + s;
      }
    });

    // (3) every lane factors Quu (`_chol_lanes` order); lane c <= NZ
    // solves column c of [K | kff] = -Quu^-1 [Qzu' | qu] (`_cho_solve_mat`)
    g.phase([&](int l) {
      if (l <= NZ) {
        T L[NU][NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            T s = Quu[i * NU + j];
#pragma unroll
            for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
            L[i][j] = (i == j) ? ric_sqrt(s) : s / L[j][j];
          }
        }
        T x[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T s = l < NZ ? own[g.slot(l)].Qzu[i] : qu[i];
#pragma unroll
          for (int m = 0; m < i; ++m) s = s - L[i][m] * x[m];
          x[i] = s / L[i][i];
        }
#pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
          T s = x[i];
#pragma unroll
          for (int m = i + 1; m < NU; ++m) s = s - L[m][i] * x[m];
          x[i] = s / L[i][i];
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          X[i * NR + l] = -x[i];
          if (l < NZ) {
            K[(k * NU + i) * NZ + l] = -x[i];
          } else {
            kff[k * NU + i] = -x[i];
          }
        }
      }
    });

    // (4) this lane's row of Qzz + Qzu K, and p_i = qz_i + (Qzu kff)_i
    g.phase([&](int l) {
      if (l < NZ) {
        Own& o = own[g.slot(l)];
        T s[NZ + 1], v[NR];
#pragma unroll
        for (int j = 0; j <= NZ; ++j) s[j] = T(0);
#pragma unroll
        for (int c = 0; c < NU; ++c) {
#pragma unroll
          for (int j = 0; j < NR; j += 4) vld<4>(v + j, X + c * NR + j);
#pragma unroll
          for (int j = 0; j <= NZ; ++j) s[j] = s[j] + o.Qzu[c] * v[j];
        }
#pragma unroll
        for (int j = 0; j < NZ; ++j) Pn[l * NZ + j] = o.Qzz[j] + s[j];
        o.p = o.qz + s[NZ];
      }
    });

    // (5) P = sym(Pn) through the tile's transpose; stage k-1 has landed
    // when the phase ends
    g.phase([&](int l) {
      if (l < NZ) {
        T v[NZ];
#pragma unroll
        for (int j = 0; j < NZ; j += V) vld<V>(v + j, Pn + l * NZ + j);
#pragma unroll
        for (int j = 0; j < NZ; ++j)
          P[l * NZ + j] = T(0.5) * (v[j] + Pn[j * NZ + l]);
      }
      ric_wait();
#if defined(__CUDA_ARCH__)
      // The rollout's copies read the gains other lanes stored.
      if (k == 0) __threadfence();
#endif
    });
  }

  // ---- forward rollout, dz_0 = 0 (node 0 is pinned to the measurement)
  T dzs[kHost], dus[kHost];
  g.phase([&](int l) {
    fetch_fwd(0, buf(0), l);
    dzs[g.slot(l)] = T(0);
    dus[g.slot(l)] = T(0);
    if (l < NZ) dz[l] = T(0);
    ric_wait();
  });
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const T* S = buf(k);
    // dz_k and du_k of every lane, the same in each (so one copy serves
    // every lane on the host)
    T dzk[NZ], duk[NU];
    // (D) copy stage k+1; lanes c < NU form du_c = K_c dz_k + kff_c
    g.phase([&](int l) {
      if (k + 1 < N) fetch_fwd(k + 1, buf(k + 1), l);
#pragma unroll
      for (int j = 0; j < NZ; ++j) dzk[j] = g.from_lane(dzs, j);
      if (l < NU) {
        T v[NZ];
#pragma unroll
        for (int j = 0; j < NZ; j += V) vld<V>(v + j, S + Sh::kK + l * NZ + j);
        T s = T(0);
#pragma unroll
        for (int j = 0; j < NZ; ++j) s = s + v[j] * dzk[j];
        const T u = s + S[Sh::kkff + l];
        dus[g.slot(l)] = u;
        du[k * NU + l] = u;
      }
    });
    // (Z) lane i forms dz_{k+1, i} = (Az dz + Bz du)_i + r_i
    g.phase([&](int l) {
#pragma unroll
      for (int c = 0; c < NU; ++c) duk[c] = g.from_lane(dus, c);
      if (l < NZ) {
        T v[NZ], w[NU];
#pragma unroll
        for (int j = 0; j < NZ; j += V) vld<V>(v + j, S + Sh::kAz + l * NZ + j);
#pragma unroll
        for (int c = 0; c < NU; c += VU)
          vld<VU>(w + c, S + Sh::kBz + l * NU + c);
        T sa = T(0), sb = T(0);
#pragma unroll
        for (int j = 0; j < NZ; ++j) sa = sa + v[j] * dzk[j];
#pragma unroll
        for (int c = 0; c < NU; ++c) sb = sb + w[c] * duk[c];
        const T u = (sa + sb) + S[Sh::kr + l];
        dzs[g.slot(l)] = u;
        dz[(k + 1) * NZ + l] = u;
      }
      ric_wait();
    });
  }
}

}  // namespace mpc_riccati
