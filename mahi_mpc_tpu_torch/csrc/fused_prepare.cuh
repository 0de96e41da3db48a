// The fused route's preparation, written once for the host and the device:
// one launch that turns the caller's batch-leading inputs into the
// batch-innermost arrays the fused kernel reads (FusedArgs' inputs X0 ..
// xfdes and mu0), with row 0 of X set to x0, rows 1..N of X clipped into
// the strict interior of the x box and U into the u box
// (solver/sqp.py `_strict_interior`), and mu0 set to the barrier's start
// (solver/loop_common.py `mu_start`).  It replaces, on the card, the plain
// preparation (solver/sqp.py `_start` and the batch-innermost copies of
// solver/fused.py `_copy_in`): about 60 small PyTorch launches a solve,
// each of which the card waited on the host to issue.
//
// The arithmetic is PyTorch's, rounding for rounding: the bounds' width,
// lo + d and hi - d in S with no contraction (`add_rn`, `sub_rn`,
// `mul_rn`), min and max that propagate NaN as torch.maximum / minimum do
// (a NaN warm start stays NaN; fmaxf / fminf would drop it), and the host
// scalars mu0, floor, mu_min and delta rounded to S once, as
// torch.as_tensor and clamp round them.
//
// What bounds it on the H100: bytes.  An instance reads 2 N nx + N nu +
// 6 nx + 5 nu words and writes (2N + 6) nx + (N + 5) nu + 1: 4,548 bytes at
// nx = 8, nu = 4, N = 25, or 74.5 MB (22 us at 3.35 TB/s) at B = 16384;
// the arithmetic is a few operations a word.
//
// The design (the LTV path's tiles, model_linearize.cuh): a block of
// kPrepareThreads threads owns a tile of T consecutive instances (the
// most, up to 32, whose records fit in kPrepareTileBytes) and holds
// each instance's record (its words of every field, in FusedArgs' order)
// as a row of the tile in shared memory at an odd stride, so a warp's 32
// lanes reading one word of 32 instances hit 32 banks.
// - load: each input's batch-leading span for the tile is contiguous; the
//   block reads the spans as one run of 16-byte vectors, consecutive
//   threads on consecutive vectors, kLoads loads in flight a thread;
// - prepare: `prepare_one` of each instance, kPrepareThreads / T threads
//   an instance taking every (threads / T)-th word of X and U;
// - store: each (field, word) of the tile's T instances is a run of T
//   consecutive words of the batch-innermost output, written as T / 4
//   16-byte vectors.
// A tile short of T instances (the last) or an input or output off a
// 16-byte boundary goes word by word.
// N, nx and nu are runtime values: the one kernel serves every library,
// shape and body, and B need not be a multiple of T.
#pragma once

#include <algorithm>
#include <limits>
#include <vector>

#include "model_linearize.cuh"

namespace mpc {

// The fields of a prepared record, in the order of FusedArgs' inputs.
enum PrepareField {
  kPX, kPU, kPXdes, kPQ, kPR, kPRm, kPUprev, kPUmin, kPUmax, kPXmin,
  kPXmax, kPQf, kPXfdes, kPMu, kPrepareFields
};
// The inputs: the source of each field, batch-leading (X0 (B, N+1, nx)
// with its row 0 unread, U0 (B, N, nu), ..., mu0 (B)), then x0 (B, nx),
// the source of X's row 0.  X0 and U0 may be null (a zero warm start),
// and mu0 (the scalar mu0 for every instance).
constexpr int kPrepareX0 = kPrepareFields;
constexpr int kPrepareIn = kPrepareFields + 1;

// 256 threads and at most 48 KB a block: T = 16 for the arm (36 KB), four
// blocks an SM at its 62 registers.  On the H100 at B = 16384 this took
// 0.045 ms against 0.048 at T = 32 (three blocks an SM, 73 KB), 0.061 at
// T = 8 and 0.049 at 128 threads (PERF.md §6).
constexpr int kPrepareThreads = 256;
constexpr int kPrepareTileBytes = 48 * 1024;
constexpr int kLoads = 6;      // loads in flight a thread

// A record's layout and the tile: the word offset of each field (off[f],
// and its length off[kPrepareFields]), the record's odd stride in the tile,
// and T instances a tile (a power of 2; 0 where one record would not fit
// in a block's shared memory), lgT its log2.
struct PrepareShape {
  int N, nx, nu;
  int off[kPrepareFields + 1];
  int stride, T, lgT;
  MPC_HD int size(int f) const { return off[f + 1] - off[f]; }
};

inline PrepareShape prepare_shape(int N, int nx, int nu, int bytes) {
  PrepareShape sh;
  sh.N = N;
  sh.nx = nx;
  sh.nu = nu;
  const int sizes[kPrepareFields] = {(N + 1) * nx, N * nu, N * nx, nx, nu,
                                     nu, nu, nu, nu, nx, nx, nx, nx, 1};
  sh.off[0] = 0;
  for (int f = 0; f < kPrepareFields; ++f)
    sh.off[f + 1] = sh.off[f] + sizes[f];
  sh.stride = sh.off[kPrepareFields] | 1;
  const long long row = (long long)sh.stride * bytes;
  sh.T = 32;
  sh.lgT = 5;
  while (sh.T > 1 && sh.T * row > kPrepareTileBytes) {
    sh.T /= 2;
    --sh.lgT;
  }
  if (row > kTileSmemMax) sh.T = 0;
  return sh;
}

template <typename S>
struct PrepareArgs {
  long long B;
  PrepareShape sh;
  const S* in[kPrepareIn];
  S* out[kPrepareFields];   // FusedArgs' X0 .. mu0, batch-innermost
  S mu0, floor, mu_min, delta;
  // every source at a 16-byte boundary; every output too, and B a whole
  // number of 16-byte vectors
  bool vec_in, vec_out;
};

// The arguments from the flat C interface: the kPrepareIn sources, the
// kPrepareFields outputs and the host scalars {mu0, floor, mu_min,
// delta}, rounded to S here.
template <typename S>
inline PrepareArgs<S> make_prepare_args(long long B, int N, int nx, int nu,
                                        const void* const* in,
                                        void* const* out,
                                        const double* scal) {
  PrepareArgs<S> a;
  a.B = B;
  a.sh = prepare_shape(N, nx, nu, (int)sizeof(S));
  for (int i = 0; i < kPrepareIn; ++i) a.in[i] = static_cast<const S*>(in[i]);
  for (int f = 0; f < kPrepareFields; ++f) a.out[f] = static_cast<S*>(out[f]);
  const auto aligned = [](const void* q) {
    return reinterpret_cast<unsigned long long>(q) % 16 == 0;
  };
  a.vec_in = true;
  for (int i = 0; i < kPrepareIn; ++i) a.vec_in &= aligned(in[i]);
  a.vec_out = B % (16 / (long long)sizeof(S)) == 0;
  for (int f = 0; f < kPrepareFields; ++f) a.vec_out &= aligned(out[f]);
  a.mu0 = S(scal[0]);
  a.floor = S(scal[1]);
  a.mu_min = S(scal[2]);
  a.delta = S(scal[3]);
  return a;
}

// ---- the arithmetic ---------------------------------------------------------

// Rounded once, never contracted into an FMA.
MPC_HD float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
MPC_HD double add_rn(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
MPC_HD float sub_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
MPC_HD double sub_rn(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}
MPC_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
MPC_HD double mul_rn(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

// `_strict_interior` of one component: v clipped into [lo + d, hi - d],
// d = min(0.25 (hi - lo), delta) where both bounds are finite, else delta;
// an infinite bound leaves its side open.
template <typename S>
MPC_HD S interior(S v, S lo, S hi, S delta) {
  const S inf = S(INFINITY);
  const bool lf = m_isfinite(lo), hf = m_isfinite(hi);
  const S width = (lf && hf) ? sub_rn(hi, lo) : inf;
  S d = mul_rn(S(0.25), width);
  d = (delta < d) ? delta : d;                // torch.clamp(max=delta)
  const S lo_c = lf ? add_rn(lo, d) : -inf;
  const S hi_c = hf ? sub_rn(hi, d) : inf;
  return nmin(nmax(v, lo_c), hi_c);
}

// `mu_start` of one instance: mu0 clamped above the floor where any bound
// is finite, else mu_min (the barrier inert).
template <typename S>
MPC_HD S barrier_start(bool has_bounds, S mu0, S floor, S mu_min) {
  return has_bounds ? ((mu0 < floor) ? floor : mu0) : mu_min;
}

// Words lane, lane + lanes, ... of a run v of n words whose word e lies in
// column e % C of the box [lo, hi], clipped into its strict interior.
template <typename S>
MPC_HD void interior_run(S* v, int n, int C, const S* lo, const S* hi,
                         S delta, int lane, int lanes) {
  const int step = lanes % C;
  int c = lane % C;
  for (int e = lane; e < n; e += lanes) {
    v[e] = interior(v[e], lo[c], hi[c], delta);
    c += step;
    if (c >= C) c -= C;
  }
}

// One instance's preparation, in place on its record `rec` (the words of
// PrepareShape's fields, as loaded: mu holds mu0): rows 1..N of X into the
// x box's strict interior, U into the u box's, and mu the barrier's start.
// Lane `lane` of `lanes` takes every lanes-th word of X and U, lane 0 also
// mu; (0, 1) is the whole instance.
template <typename S>
MPC_HD void prepare_one(const PrepareShape& sh, S* rec, S floor, S mu_min,
                        S delta, int lane, int lanes) {
  const int nx = sh.nx, nu = sh.nu;
  const S *xmin = rec + sh.off[kPXmin], *xmax = rec + sh.off[kPXmax];
  const S *umin = rec + sh.off[kPUmin], *umax = rec + sh.off[kPUmax];
  interior_run(rec + sh.off[kPX] + nx, sh.N * nx, nx, xmin, xmax, delta,
               lane, lanes);
  interior_run(rec + sh.off[kPU], sh.N * nu, nu, umin, umax, delta, lane,
               lanes);
  if (lane != 0) return;
  bool has_bounds = false;
  for (int c = 0; c < nu; ++c)
    has_bounds |= m_isfinite(umin[c]) || m_isfinite(umax[c]);
  for (int c = 0; c < nx; ++c)
    has_bounds |= m_isfinite(xmin[c]) || m_isfinite(xmax[c]);
  S& mu = rec[sh.off[kPMu]];
  mu = barrier_start(has_bounds, mu, floor, mu_min);
}

// ---- the tile's phases ------------------------------------------------------

// Input i's field, and its words an instance.
MPC_HD int input_field(int i) { return i == kPrepareX0 ? kPX : i; }
MPC_HD int input_words(const PrepareShape& sh, int i) {
  return i == kPrepareX0 ? sh.nx : sh.size(i);
}

template <typename S, int U>
struct alignas(U * sizeof(S)) Units {
  S v[U];
};

// Thread t of nt copies its share of the tile's nb instances from the
// inputs into the records, the inputs' spans (input i's: nb rows of its
// words an instance, contiguous) taken as one run of U-word units, kLoads
// loads in flight a thread: word e of input i's span is word e % W of
// instance e / W's field.  A null X0 or U0 gives zeros, a null mu0 the
// scalar mu0; X0's row 0 is left to x0.
template <typename S, int U>
MPC_HD void load_units(int t, int nt, int nb, long long b0,
                       const PrepareArgs<S>& a, S* tile) {
  const PrepareShape& sh = a.sh;
  int i = -1, p = 0, nv = 0;   // input i's span is units p .. p + nv - 1
  const auto next = [&]() {
    p += nv;
    ++i;
    nv = i < kPrepareIn ? nb * input_words(sh, i) / U : 0;
  };
  next();
  for (int v0 = t;; v0 += kLoads * nt) {
    Units<S, U> q[kLoads];
    int iu[kLoads], ju[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = v0 + u * nt;
      while (i < kPrepareIn && v >= p + nv) next();
      iu[u] = i;
      ju[u] = v - p;
      if (i >= kPrepareIn) continue;
      if (a.in[i] != nullptr) {
        q[u] = reinterpret_cast<const Units<S, U>*>(
            a.in[i] + b0 * input_words(sh, i))[v - p];
      } else {
#pragma unroll
        for (int l = 0; l < U; ++l) q[u].v[l] = i == kPMu ? a.mu0 : S(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (iu[u] >= kPrepareIn) return;
      const int W = input_words(sh, iu[u]);
      const int skip = iu[u] == kPX ? sh.nx : 0;
      S* dst = tile + sh.off[input_field(iu[u])];
      int inst = ju[u] * U / W, k = ju[u] * U - inst * W;
#pragma unroll
      for (int l = 0; l < U; ++l) {
        if (k >= skip) dst[inst * sh.stride + k] = q[u].v[l];
        if (++k == W) {
          k = 0;
          ++inst;
        }
      }
    }
  }
}

// The load phase: 16-byte units in a full tile of aligned inputs
// (`vec_in`), words otherwise (the last tile short of T instances).
template <typename S>
MPC_HD void prepare_load(int t, int nt, int nb, long long b0,
                         const PrepareArgs<S>& a, S* tile) {
  constexpr int V = 16 / (int)sizeof(S);
  if (a.vec_in && nb == a.sh.T && a.sh.T % V == 0)
    load_units<S, V>(t, nt, nb, b0, a, tile);
  else
    load_units<S, 1>(t, nt, nb, b0, a, tile);
}

// Thread t of nt runs `prepare_one` of instance t % T, as lane t / T of
// nt / T.
template <typename S>
MPC_HD void prepare_tile(int t, int nt, int nb, const PrepareArgs<S>& a,
                         S* tile) {
  const int b = t & (a.sh.T - 1);
  if (b >= nb) return;
  prepare_one(a.sh, tile + b * a.sh.stride, a.floor, a.mu_min, a.delta,
              t >> a.sh.lgT, nt >> a.sh.lgT);
}

// Thread t of nt writes its share of the tile out batch-innermost: item j
// of a field is word j / T of instance j % T, so a warp's lanes write
// consecutive instances.  In a full tile of aligned outputs (`vec_out`)
// an item is word j / G of instances V (j % G) .. V (j % G) + V - 1, G =
// T / V, written as one 16-byte vector.
template <typename S>
MPC_HD void prepare_store(int t, int nt, int nb, long long b0,
                          const PrepareArgs<S>& a, const S* tile) {
  constexpr int V = 16 / (int)sizeof(S);
  const PrepareShape& sh = a.sh;
  if (a.vec_out && nb == sh.T && sh.T % V == 0) {
    const int G = sh.T / V;
    for (int f = 0; f < kPrepareFields; ++f) {
      const S* src = tile + sh.off[f];
      S* dst = a.out[f] + b0;
      for (int j = t; j < sh.size(f) * G; j += nt) {
        const int g = j % G, k = j / G;
        Vec16<S> q;
#pragma unroll
        for (int l = 0; l < V; ++l) q.v[l] = src[(g * V + l) * sh.stride + k];
        *reinterpret_cast<Vec16<S>*>(dst + (long long)k * a.B + g * V) = q;
      }
    }
    return;
  }
  for (int f = 0; f < kPrepareFields; ++f) {
    const S* src = tile + sh.off[f];
    S* dst = a.out[f] + b0;
    for (int j = t; j < (sh.size(f) << sh.lgT); j += nt) {
      const int b = j & (sh.T - 1), k = j >> sh.lgT;
      if (b < nb) dst[(long long)k * a.B + b] = src[b * sh.stride + k];
    }
  }
}

// ---- the blocks on the host (the g++ builds) --------------------------------

// The card's blocks one after another, each phase's threads one after
// another (last to first when `reverse`); the tile starts each block as
// NaN, so a read before a write shows.  -6 where a record does not fit.
template <typename S>
int prepare_host(const PrepareArgs<S>& a, bool reverse) {
  const PrepareShape& sh = a.sh;
  if (sh.T == 0) return -6;
  std::vector<S> tile((size_t)sh.T * sh.stride);
  const int nt = kPrepareThreads;
  const auto each = [&](const auto& phase) {
    for (int i = 0; i < nt; ++i) phase(reverse ? nt - 1 - i : i);
  };
  for (long long b0 = 0; b0 < a.B; b0 += sh.T) {
    const int nb = (int)std::min<long long>(sh.T, a.B - b0);
    std::fill(tile.begin(), tile.end(),
              S(std::numeric_limits<double>::quiet_NaN()));
    each([&](int t) { prepare_load(t, nt, nb, b0, a, tile.data()); });
    each([&](int t) { prepare_tile(t, nt, nb, a, tile.data()); });
    each([&](int t) { prepare_store(t, nt, nb, b0, a, tile.data()); });
  }
  return 0;
}

}  // namespace mpc
