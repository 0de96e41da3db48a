// The LTV path's two per-instance functions, written once for the host and
// the device as independent column tasks: the frozen linearization of a
// model and the exact affine discrete step of that linearization.
//
// - The linearization replaces the JAX service's jitted
//   `jax.vmap(dynamics.linearize)` (mahi_mpc_tpu/runtime/batch_service.py
//   `self._relin`, and `ModelControl.calc_u`'s `linearize` at B=1):
//   (A, B, x_dot0) = (df/dx, df/du, f) at (x0, u0).  `linearize_task` k of
//   a serial arm is joint k's folded columns (arm_dynamics.cuh
//   `arm_q_column`, which gives the task its own Cholesky factor L and qdd
//   from the value part, then `arm_qd_column` and `arm_u_column` with that
//   L), so A = [[0, I], [dacc/dx]] and B = [[0], [dacc/du]]: NQ tasks.  Task
//   k of a closed form or a generated model is the one-tangent dual pass k
//   of `model_f`: NZ tasks.  Task 0 also writes x_dot0.
// - The discretization replaces `_ltv_discrete`
//   (mahi_mpc_tpu/solver/batched.py:58-82, run inside the jitted fused
//   wrapper): the frozen f(x, u) = A (x - x0) + B (u - u0) + x_dot0 is
//   affine, so every explicit step of it is affine, F(z) = F(0) + rows z.
//   `AffineModel` is that f in the shape `model_f` takes, and
//   `ltv_discrete_task` k is pass k of `increment_rows` (model_dynamics.cuh)
//   at z = 0: column k of [Ad - I | Bd], Ad - I formed directly, never as Ad
//   minus the identity (the increment form of every step policy,
//   fused_sqp.cuh); task 0 also writes the increment cd.  NZ tasks.
// Each task runs the arithmetic of one pass of the one-thread form these
// replaced, so its outputs are that form's.
//
// What bounds them on the H100: neither moves much.  A linearization reads
// nx + nu and writes nx (nx + nu + 1) numbers an instance (7.6 MB at
// B=16384 for the 4-DOF arm), a discretization reads nx (nx + nu + 2) + nu
// and writes nx (nx + nu + 1) (14.4 MB at (8, 4)); the arithmetic is a few
// thousand to a few tens of thousands of operations an instance, the value
// part counted once (21,140 for the arm's linearization, whose tasks do
// 34,888: bound by operations; 4,057 for the (8, 4) Euler discretization,
// whose tasks do 7,500: bound by bytes; flop_count.cpp), so both bounds
// are a few microseconds.
// The design, the same for both (`TileShape`): a block holds a tile of T
// instances x C tasks, one task a thread, thread = task * T + instance, so
// for one task a warp's lanes are 32 consecutive instances (T is 32 or 64,
// 16 or fewer only where C > 12).  The tile's
// batch-leading inputs, each a contiguous span of T rows, are copied into
// shared memory by every thread of the block with coalesced (16-byte where
// aligned) loads, one row an instance at an odd stride so a warp's lanes
// read distinct banks; the discretization's `AffineModel` reads A and B
// there in every pass and stage.  The discretization writes the fused
// kernel's batch-innermost layout (`FusedArgs::AdI`, `Bd`, `cd`) straight
// from the tasks, a warp's 32 lanes on 32 consecutive words; the
// linearization writes batch-leading (the layout `LinPoint` keeps, and the
// JAX package's state_dict), so it stages A, B and x_dot0 in the tile too
// and writes each as the tile's contiguous span.
#pragma once

#include <algorithm>
#include <limits>
#include <utility>
#include <vector>

#include "fused_sqp.cuh"

namespace mpc {

namespace gen {
template <typename S> struct Model;   // a generated build's (codegen.py)
}

template <typename M> struct IsArm { static constexpr bool value = false; };
template <typename S, int NQ> struct IsArm<ArmModel<S, NQ>> {
  static constexpr bool value = true;
};

// ---- the tile ---------------------------------------------------------------

// The shared memory a block can take on the H100 (227 KB).
constexpr int kTileSmemMax = 232448;

// Instances a tile for `tasks` threads an instance and rows of `stride`
// numbers of `bytes` each: a warp's 32 lanes, doubled while the block has
// fewer than 128 threads, halved while it has more than 384 or its tile
// passes kTileSmemMax.
constexpr int tile_instances(int tasks, int stride, int bytes) {
  int t = 32;
  while (t * tasks < 128) t *= 2;
  while (t > 1 && (t * tasks > 384 ||
                   (long long)t * stride * bytes > kTileSmemMax))
    t /= 2;
  return t;
}

// A block of the LTV path's kernels: T instances x kTasks tasks, thread
// task * T + instance; each instance a row of kWords numbers S in shared
// memory at the odd stride kStride (kSmem bytes a tile, dynamic).
template <typename S, int kTasks_, int kWords>
struct TileShape {
  static constexpr int kTasks = kTasks_;
  static constexpr int kStride = kWords | 1;
  static constexpr int T = tile_instances(kTasks, kStride, (int)sizeof(S));
  static constexpr int kThreads = T * kTasks;
  static constexpr int kSmem = T * kStride * (int)sizeof(S);
};

template <typename S>
struct alignas(16) Vec16 {
  S v[16 / sizeof(S)];
};

// Thread t of nt copies its share of a span of nb instances' rows of W
// numbers, contiguous at `src`, to word `off` of each instance's row of the
// tile (stride R): every nt-th 16-byte vector where `src` is 16-byte
// aligned, then every nt-th number of the rest.
template <int W, int R, typename S>
MPC_HD void span_in(int t, int nt, int nb, const S* src, S* tile, int off) {
  constexpr int V = 16 / sizeof(S);
  const int n = nb * W;
  int done = 0;
  if (reinterpret_cast<unsigned long long>(src) % 16 == 0) {
    const Vec16<S>* vs = reinterpret_cast<const Vec16<S>*>(src);
    for (int k = t; k < n / V; k += nt) {
      const Vec16<S> q = vs[k];
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const int e = k * V + l;
        tile[(e / W) * R + off + e % W] = q.v[l];
      }
    }
    done = n / V * V;
  }
  for (int e = done + t; e < n; e += nt)
    tile[(e / W) * R + off + e % W] = src[e];
}

// The reverse of `span_in`: word `off` of nb rows of the tile out to the
// contiguous span at `dst`.
template <int W, int R, typename S>
MPC_HD void span_out(int t, int nt, int nb, const S* tile, int off, S* dst) {
  constexpr int V = 16 / sizeof(S);
  const int n = nb * W;
  int done = 0;
  if (reinterpret_cast<unsigned long long>(dst) % 16 == 0) {
    Vec16<S>* vs = reinterpret_cast<Vec16<S>*>(dst);
    for (int k = t; k < n / V; k += nt) {
      Vec16<S> q;
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const int e = k * V + l;
        q.v[l] = tile[(e / W) * R + off + e % W];
      }
      vs[k] = q;
    }
    done = n / V * V;
  }
  for (int e = done + t; e < n; e += nt)
    dst[e] = tile[(e / W) * R + off + e % W];
}

// ---- the linearization ------------------------------------------------------

// Task k of one instance's (A, B, x_dot0) at (x, u) (row-major A (NX, NX),
// Bm (NX, NU), xdot (NX), written through the pointers): a serial arm's
// joint k (its q, qd and u columns, and the rows of A and B above them), or
// a closed form's or a generated model's column k of [A | B] by one dual
// pass; task 0 also writes x_dot0.
template <typename S, typename Model>
MPC_HD void linearize_task(const Model& m, int k, const S* xs, const S* us,
                           S* A, S* Bm, S* xdot) {
  constexpr int NX = Model::NX, NU = Model::NU;
  S x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[i];
#pragma unroll
  for (int j = 0; j < NU; ++j) u[j] = us[j];
  if constexpr (IsArm<Model>::value) {
    constexpr int NQ = Model::NQ;
    S L[NQ][NQ], qdd[NQ], col[NQ];
    arm_q_column(m.c, x, x + NQ, u, k, L, qdd, col);
#pragma unroll
    for (int i = 0; i < NQ; ++i) A[(NQ + i) * NX + k] = col[i];
    arm_qd_column(m.c, x, x + NQ, k, L, col);
#pragma unroll
    for (int i = 0; i < NQ; ++i) A[(NQ + i) * NX + NQ + k] = col[i];
    arm_u_column(L, k, col);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      Bm[(NQ + i) * NU + k] = col[i];
      A[i * NX + k] = S(0);
      A[i * NX + NQ + k] = S(i == k ? 1 : 0);
      Bm[i * NU + k] = S(0);
    }
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        xdot[i] = x[NQ + i];
        xdot[NQ + i] = qdd[i];
      }
    }
  } else {
    typedef Dual<S, 1> D;
    D xd[NX], ud[NU], out[NX];
    seed<S, 1, NX, NU>(x, u, k, xd, ud);
    model_f(m, xd, ud, out);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (k < NX)
        A[i * NX + k] = out[i].d[0];
      else
        Bm[i * NU + k - NX] = out[i].d[0];
      if (k == 0) xdot[i] = out[i].v;
    }
  }
}

// The linearization's block, phase by phase (barriers between): `load` the
// tile's x0 and u0 spans, each thread's `task` into the tile, `store` the
// tile's A, B and x_dot0 spans.  Instances b0 .. b0 + nb of x0 (B, NX),
// u0 (B, NU) in, A (B, NX, NX), Bm (B, NX, NU), xd0 (B, NX) out.
// The kernel asks for registers for one block an SM: the arm's chain takes
// 253 of them, and two blocks of 128 an SM fit at that count, so asking
// for two gains no block.
template <typename S, typename Model>
struct LinearizeTile {
  static constexpr int NX = Model::NX, NU = Model::NU;
  static constexpr int kX = 0, kU = NX, kA = kU + NU, kB = kA + NX * NX,
                       kXd = kB + NX * NU;
  typedef TileShape<S, IsArm<Model>::value ? Model::NQ : NX + NU, kXd + NX>
      Shape;
  static constexpr int R = Shape::kStride, NT = Shape::kThreads;
  static constexpr int kMinBlocks = 1;

  static MPC_HD void load(int t, int nb, long long b0, const S* x0,
                          const S* u0, S* tile) {
    span_in<NX, R>(t, NT, nb, x0 + b0 * NX, tile, kX);
    span_in<NU, R>(t, NT, nb, u0 + b0 * NU, tile, kU);
  }
  static MPC_HD void task(const Model& m, int t, int nb, S* tile) {
    const int b = t % Shape::T;
    if (b >= nb) return;
    S* row = tile + b * R;
    linearize_task<S>(m, t / Shape::T, row + kX, row + kU, row + kA,
                      row + kB, row + kXd);
  }
  static MPC_HD void store(int t, int nb, long long b0, const S* tile, S* A,
                           S* Bm, S* xd0) {
    span_out<NX * NX, R>(t, NT, nb, tile, kA, A + b0 * NX * NX);
    span_out<NX * NU, R>(t, NT, nb, tile, kB, Bm + b0 * NX * NU);
    span_out<NX, R>(t, NT, nb, tile, kXd, xd0 + b0 * NX);
  }
};

// ---- the discretization -----------------------------------------------------

// The frozen linearization's right-hand side as a first-order model
// (NQ = 0): f(x, u) = A (x - x0) + B (u - u0) + x_dot0, each dot product
// left to right, over one instance's row-major A, B and vectors (in the
// tile).  On the card each call reads them anew: the compiler may not hoist
// the reads out of the integrator's stage loop, where they would hold
// nx (nx + nu + 2) + nu registers (a shared-memory read is cheaper than
// the occupancy, or the spills, they cost).
template <typename S, int NX_, int NU_>
struct AffineModel {
  static constexpr int NQ = 0, NX = NX_, NU = NU_;
  const S *A, *B, *xd0, *x0, *u0;
  template <typename T>
  MPC_HD void f(const T* x, const T* u, T* out) const {
#if defined(__CUDA_ARCH__)
    asm volatile("" ::: "memory");
#endif
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T ax = A[i * NX] * (x[0] - x0[0]);
#pragma unroll
      for (int j = 1; j < NX; ++j) ax = ax + A[i * NX + j] * (x[j] - x0[j]);
      T bu = B[i * NU] * (u[0] - u0[0]);
#pragma unroll
      for (int j = 1; j < NU; ++j) bu = bu + B[i * NU + j] * (u[j] - u0[j]);
      out[i] = (ax + bu) + xd0[i];
    }
  }
};

// Task k of the exact affine step of one instance's frozen linearization
// under `integ`, as its increment: column k of (Ad - I | Bd) by pass k of
// `increment_rows` at z = 0, and from task 0 cd; element e of each at
// out[e * stride] (the fused kernel's batch-innermost layout at stride B).
template <typename S, int NX, int NU>
MPC_HD void ltv_discrete_task(const AffineModel<S, NX, NU>& m, int integ,
                              S dt, int k, S* AdI, S* Bd, S* cd,
                              long long stride) {
  typedef Dual<S, 1> D;
  S zx[NX], zu[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) zx[i] = S(0);
#pragma unroll
  for (int j = 0; j < NU; ++j) zu[j] = S(0);
  D xd[NX], ud[NU], out[NX];
  seed<S, 1, NX, NU>(zx, zu, k, xd, ud);
  model_increment(m, integ, dt, xd, ud, out);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    if (k < NX)
      AdI[(i * NX + k) * stride] = out[i].d[0];
    else
      Bd[(i * NU + k - NX) * stride] = out[i].d[0];
    if (k == 0) cd[i * stride] = out[i].v;
  }
}

// The discretization's block, phase by phase (a barrier between): `load`
// the tile's five spans of the batch-leading frozen point A (B, NX, NX),
// Bm (B, NX, NU), xd0 (B, NX), x0 (B, NX), u0 (B, NU), then each thread's
// `task` from the tile into AdI (NX, NX, B), Bd (NX, NU, B), cd (NX, B).
// In float the kernel asks for registers for two blocks an SM, so one
// block's loads overlap another's passes, for at most a few bytes of
// spills; in double that spills hundreds of bytes, so one.
template <typename S, int NX, int NU>
struct DiscreteTile {
  static constexpr int kA = 0, kB = NX * NX, kXd = kB + NX * NU,
                       kX0 = kXd + NX, kU0 = kX0 + NX;
  typedef TileShape<S, NX + NU, kU0 + NU> Shape;
  static constexpr int R = Shape::kStride, NT = Shape::kThreads;
  static constexpr int kMinBlocks = sizeof(S) <= 4 ? 2 : 1;

  static MPC_HD void load(int t, int nb, long long b0, const S* A,
                          const S* Bm, const S* xd0, const S* x0,
                          const S* u0, S* tile) {
    span_in<NX * NX, R>(t, NT, nb, A + b0 * NX * NX, tile, kA);
    span_in<NX * NU, R>(t, NT, nb, Bm + b0 * NX * NU, tile, kB);
    span_in<NX, R>(t, NT, nb, xd0 + b0 * NX, tile, kXd);
    span_in<NX, R>(t, NT, nb, x0 + b0 * NX, tile, kX0);
    span_in<NU, R>(t, NT, nb, u0 + b0 * NU, tile, kU0);
  }
  static MPC_HD void task(int t, int nb, long long b0, long long B,
                          int integ, S dt, const S* tile, S* AdI, S* Bd,
                          S* cd) {
    const int b = t % Shape::T;
    if (b >= nb) return;
    const S* row = tile + b * R;
    const AffineModel<S, NX, NU> m{row + kA, row + kB, row + kXd, row + kX0,
                                   row + kU0};
    const long long e = b0 + b;
    ltv_discrete_task(m, integ, dt, t / Shape::T, AdI + e, Bd + e, cd + e,
                      B);
  }
};

// ---- the blocks on the host (the g++ builds) --------------------------------

// Runs `phases(b0, nb, tile, each)` tile after tile over B instances, where
// `each(phase)` calls phase(t) for every thread t of a block one after
// another (last to first when `reverse`), as the card runs a phase between
// two barriers.  The tile starts each block as NaN, so a read before a
// write shows.
template <typename S, typename Shape, typename Phases>
void host_tiles(long long B, bool reverse, const Phases& phases) {
  std::vector<S> tile((size_t)Shape::T * Shape::kStride);
  const auto each = [&](const auto& phase) {
    for (int i = 0; i < Shape::kThreads; ++i)
      phase(reverse ? Shape::kThreads - 1 - i : i);
  };
  for (long long b0 = 0; b0 < B; b0 += Shape::T) {
    std::fill(tile.begin(), tile.end(),
              S(std::numeric_limits<double>::quiet_NaN()));
    phases(b0, (int)std::min<long long>(Shape::T, B - b0), tile.data(),
           each);
  }
}

template <typename S, typename Model>
void linearize_host(const Model& m, long long B, const S* x0, const S* u0,
                    S* A, S* Bm, S* xd0, bool reverse) {
  typedef LinearizeTile<S, Model> L;
  host_tiles<S, typename L::Shape>(
      B, reverse, [&](long long b0, int nb, S* tile, const auto& each) {
        each([&](int t) { L::load(t, nb, b0, x0, u0, tile); });
        each([&](int t) { L::task(m, t, nb, tile); });
        each([&](int t) { L::store(t, nb, b0, tile, A, Bm, xd0); });
      });
}

template <typename S, int NX, int NU>
void ltv_discrete_host(long long B, int integ, S dt, const S* A,
                       const S* Bm, const S* xd0, const S* x0, const S* u0,
                       S* AdI, S* Bd, S* cd, bool reverse) {
  typedef DiscreteTile<S, NX, NU> L;
  host_tiles<S, typename L::Shape>(
      B, reverse, [&](long long b0, int nb, S* tile, const auto& each) {
        each([&](int t) { L::load(t, nb, b0, A, Bm, xd0, x0, u0, tile); });
        each([&](int t) {
          L::task(t, nb, b0, B, integ, dt, tile, AdI, Bd, cd);
        });
      });
}

// Calls fn(model) with the model `model` (a ModelId; c its constants) among
// the families of kFamilies, or returns -1: the serial arms with kArmFast
// (the library of the main path, fused_sqp.cu), the closed forms with
// kModels, and a generated build's gen::Model (MPC_GENERATED_MODEL) where
// its step policy is LTV: the LTV unit of a user's model
// (solver/target.py `model_kernel`).
template <typename S, int kFamilies, typename Fn>
int model_dispatch(int model, const double* c, const Fn& fn) {
  if constexpr ((kFamilies & kGenerated) != 0) {
#if defined(MPC_GENERATED_MODEL)
    typedef decltype(GeneratedStep<S>::make(
        std::declval<const FusedArgs<S>&>())) Step;
    if constexpr (IsLtv<Step>::value) {
      if (model == kGeneratedModel) return fn(gen::Model<S>{});
    }
#endif
    (void)model;
    (void)c;
    return -1;
  } else {
    if constexpr ((kFamilies & kArmFast) != 0) {
      if (model == kTwoLinkArm)
        return fn(ArmModel<S, 2>{load_arm<S, double, 2>(c)});
      if (model == kMahiArm)
        return fn(ArmModel<S, 4>{load_arm<S, double, 4>(c)});
    }
    if constexpr ((kFamilies & kModels) != 0) {
      switch (model) {
        case kPendulum: return fn(Pendulum<S>::load(c));
        case kCartpole: return fn(Cartpole<S>::load(c));
        case kDoublePendulum: return fn(DoublePendulum<S>::load(c));
        case kAcrobot: return fn(Acrobot<S>::load(c));
        default: break;
      }
    }
    return -1;
  }
}

// Calls fn(step) with the Ltv<S, nx, nu> policy of kFamilies's builds (the
// four hand-written shapes with kLtvShapes, a generated build's own LTV
// shape), or returns -1.
template <typename S, int kFamilies, typename Fn>
int ltv_dispatch(int nx, int nu, const Fn& fn) {
  if constexpr ((kFamilies & kGenerated) != 0) {
    typedef decltype(GeneratedStep<S>::make(
        std::declval<const FusedArgs<S>&>())) Step;
    if constexpr (IsLtv<Step>::value) {
      if (Step::NX == nx && Step::NU == nu) return fn(Step{});
    }
    return -1;
  } else {
    if constexpr ((kFamilies & kLtvShapes) != 0) {
      if (nx == 8 && nu == 4) return fn(Ltv<S, 8, 4>{});
      if (nx == 4 && nu == 2) return fn(Ltv<S, 4, 2>{});
      if (nx == 4 && nu == 1) return fn(Ltv<S, 4, 1>{});
      if (nx == 2 && nu == 1) return fn(Ltv<S, 2, 1>{});
    }
    return -1;
  }
}

}  // namespace mpc
