// Fused SQP kernel for Hopper (sm_90a): the whole batched MPC solve in one
// launch.
//
// Replaces the Pallas kernel `_make_kernel` in mahi_mpc_tpu/solver/fused.py
// (launched at fused.py:981-1004), in both of its iteration modes (fixed,
// adaptive) and all three of its step modes: the Euler nq-row path, the
// generic nx-row path (midpoint, RK4) and LTV.  Each CUDA library
// (fused_sqp*.cu) instantiates one family of step policies through
// `launch_fused`, so nvcc builds them in parallel; a generated library
// (_build.py `register_generated`: a user's model emitted by
// models/codegen.py, or an LTV shape outside the four) instantiates the
// one policy it defines (family kGenerated, `GeneratedStep`) through the
// same launcher and exports.
//
// What bounds it on this card: operations.  The work is a long FP32 program
// per instance (N=25 stages x [linearization + a block Riccati step] + a
// fan of trial steps per iteration), with no data shared between instances;
// each instance streams its scratch (gains K, kff, steps dX, dU, gradients
// G, Jacobian rows J, defects ck: 13.7 KB at nx=8, nu=4, N=25 on the Euler
// path, 18.5 KB on the generic one) through global memory, batch-innermost,
// three times an iteration (~0.6 ms of HBM time a fixed-3 solve at
// B=16384), far below the arithmetic.  Three bodies, picked by the rule
// `mpc::card_body` (fused_sqp_block.cuh) from the policy, B and N:
//
// - the block body (fused_sqp_block.cuh), at small batch for the policies
//   `BlockBody` names (`FastNq<ArmModel<4>>` in `fused_sqp`,
//   `FastNq<DoublePendulum>` in `fused_sqp_models`, `Ltv<8, 4>` in
//   `fused_sqp_ltv`, a user's model under `FastNq` or `Generic` in its
//   generated library), where B is at most the policy's kMaxBatch and the
//   instance fits in a block's shared memory: one instance a block of 256
//   threads, one block an SM.  At B=1 one group of the group body runs its
//   stages one after another on one SM with nothing to hide its latencies
//   (2.90 ms for the arm, 0.87 for `Ltv<8, 4>`); the block runs what does
//   not depend on the previous stage across its threads (0.52 ms, 0.47;
//   PERF.md §6);
// - the group body (fused_sqp_group.cuh), for the policies `GroupBody`
//   names at every other (B, N): W threads an instance, the Riccati step
//   split over the group on a shared-memory tile, the line-search rungs in
//   parallel, 128 / W instances a 128-thread block.  Four lanes for the
//   serial arms under every integrator (libraries `fused_sqp`, the main
//   path, and `fused_sqp_generic`) and LTV where NX is a multiple of 4 from
//   8 up ((8, 4) in `fused_sqp_ltv`; a generated (12, 6), whose 32 tiles
//   take 135 KB of shared memory: one block an SM): two
//   blocks an SM (255 registers a thread, ~no spills on the Euler arm: at
//   four blocks an SM, 128 registers, the dual-number pass spilled ~1.7 KB
//   a thread and a fixed-3 solve took 19 % longer on the H100, PERF.md).
//   Two lanes for the closed forms under midpoint and RK4 but the pendulum,
//   and the double pendulum under Euler (`fused_sqp_models`): 64 instances
//   a block, 256 blocks at B=16384, one wave at three blocks an SM (150-160
//   registers, no spills);
// - every other policy (`solve_instance`, fused_sqp.cuh: the pendulum, the
//   cart-pole and the acrobot under Euler, the pendulum under midpoint and
//   RK4, every other LTV shape: (4, 2), (4, 1), (2, 1), a generated (6,
//   3)): one thread an instance, 128
//   threads a block, the Riccati carries in registers; what does not fit
//   spills to local memory.
//
// A warp's load of one element of a batch-innermost array is one 128-byte
// transaction (one thread an instance) or one 32-byte sector (four lanes:
// 8 instances a warp; two: 16).  The adaptive mode's per-tile early exit
// of the Pallas kernel becomes a per-instance loop exit (the group leaves
// together).
#pragma once

#include <cuda_runtime.h>

#include "fused_prepare.cuh"
#include "fused_sqp_block.cuh"
#include "model_linearize.cuh"

template <typename Step>
__global__ void __launch_bounds__(128)
fused_sqp_kernel(mpc::FusedArgs<float> a, Step step) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  mpc::solve_instance<float>(a, step, b);
}

// W consecutive threads of a warp an instance (the policy's width),
// mpc::kGroupThreads / W instances a block; each group's tile in dynamic
// shared memory.
using mpc::kGroupThreads;
template <typename Step>
constexpr int kGroupsPerBlock = kGroupThreads / mpc::GroupStep<float, Step>::W;

// Blocks an SM that __launch_bounds__ asks registers for, by width.  Four
// lanes: two (255 registers a thread) for every policy; at three, Ltv<8, 4>
// took 168 registers, spilled 128 B and ran 23 % slower on the H100
// (PERF.md).  Two lanes: three (170 registers a thread; the closed forms
// take 150-160 and spill nothing, as at two; at four, 128 registers, they
// spilled 40-140 B and the double pendulum under RK4 ran 7 % slower at
// B=16384).
template <int W> struct GroupMinBlocks { static constexpr int value = 2; };
template <> struct GroupMinBlocks<2> { static constexpr int value = 3; };

template <typename Step>
__global__ void __launch_bounds__(
    kGroupThreads, GroupMinBlocks<mpc::GroupStep<float, Step>::W>::value)
fused_sqp_group_kernel(mpc::FusedArgs<float> a, Step step) {
  extern __shared__ float tiles[];
  typedef mpc::GroupStep<float, Step> GS;
  constexpr int W = GS::W;
  const int t = threadIdx.x, gi = t / W;
  const long long b = (long long)blockIdx.x * kGroupsPerBlock<Step> + gi;
  if (b >= a.B) return;                 // the whole group leaves together
  const mpc::Group<W> g{t % W, ((1u << W) - 1u) << (t & (32 - W))};
  mpc::solve_group<float>(a, step, b, g, tiles + gi * GS::Tile::kSize);
}

// Dynamic shared memory of a block of the group kernel for Step.
template <typename Step>
size_t group_smem() {
  return sizeof(float) * mpc::GroupStep<float, Step>::Tile::kSize *
         kGroupsPerBlock<Step>;
}

// Lets a kernel take `smem` bytes of dynamic shared memory (above the 48 KB
// default).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Step>
int launch_group(const mpc::FusedArgs<float>& a, const Step& step,
                 cudaStream_t s) {
  const size_t smem = group_smem<Step>();
  const cudaError_t e = allow_smem(fused_sqp_group_kernel<Step>, smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int per_block = kGroupsPerBlock<Step>;
  const unsigned grid = (unsigned)((a.B + per_block - 1) / per_block);
  fused_sqp_group_kernel<Step><<<grid, kGroupThreads, smem, s>>>(a, step);
  return (int)cudaGetLastError();
}

// The block body (fused_sqp_block.cuh): one instance a block of
// kBlockThreads threads, the instance in dynamic shared memory; one block
// an SM (the arm's chain pass takes the 255 registers a thread that a full
// register file leaves 256 threads).
template <typename Step>
__global__ void __launch_bounds__(mpc::kBlockThreads, 1)
fused_sqp_block_kernel(mpc::FusedArgs<float> a, Step step) {
  extern __shared__ float instance[];
  const mpc::Block<mpc::kBlockThreads> blk{(int)threadIdx.x};
  mpc::solve_block<float>(a, step, (long long)blockIdx.x, blk, instance);
}

template <typename Step>
int launch_block(const mpc::FusedArgs<float>& a, const Step& step,
                 cudaStream_t s) {
  const size_t smem = (size_t)mpc::block_smem_bytes<Step>(a.N);
  const cudaError_t e = allow_smem(fused_sqp_block_kernel<Step>, smem);
  if (e != cudaSuccess) return (int)e;
  fused_sqp_block_kernel<Step>
      <<<(unsigned)a.B, mpc::kBlockThreads, smem, s>>>(a, step);
  return (int)cudaGetLastError();
}

// Launch the instantiation of family mask kFamilies that serves (model, nx,
// nu) on `stream`, on the body the rule picks (`mpc::card_body`: the block
// body at small batch for the policies `BlockBody` names, else the group
// body for the policies `GroupBody` names, else the one-thread body).
// Writes the body it launched and that body's threads an instance to
// `launched[0]` and `launched[1]` (-1 and 0 where it launched nothing); does
// not synchronise.  Returns cudaGetLastError(), -1 when this library holds
// no instantiation for the problem.
template <int kFamilies>
int launch_fused(long long B, int N, int model, int nx, int nu,
                 void* const* ptrs, const float* scal, const int* ints,
                 const float* fan, const double* consts, void* stream,
                 int* launched) {
  launched[0] = -1;
  launched[1] = 0;
  if (B <= 0) return 0;
  const mpc::FusedArgs<float> a =
      mpc::make_args<float>(B, N, ptrs, scal, ints, fan);
  const unsigned grid = (unsigned)((B + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mpc::dispatch<float, kFamilies>(
      a, model, nx, nu, consts, [&](const auto& step) -> int {
        typedef typename std::decay<decltype(step)>::type Step;
        const int pick = mpc::card_body<Step>(B, N, nullptr);
        launched[0] = pick;
        launched[1] = mpc::body_threads<Step>(pick);
        if (pick == mpc::kBlockBody) {
          if constexpr (mpc::BlockBody<Step>::value)
            return launch_block(a, step, s);
        } else if (pick == mpc::kGroupBody) {
          if constexpr (mpc::GroupBody<Step>::value)
            return launch_group(a, step, s);
        } else if (pick == mpc::kThreadBody) {
          if constexpr (!mpc::GroupBody<Step>::value) {
            fused_sqp_kernel<Step><<<grid, 128, 0, s>>>(a, step);
            return (int)cudaGetLastError();
          }
        }
        return -4;
      });
}

// Blocks of the kernel that serves (model, nx, nu) under `integ` and `ltv`
// at full occupancy (the group or one-thread body, as `mpc::card_body`
// picks it) that fit on one SM at once (registers and shared memory); -1
// when this library holds no instantiation for it, or the CUDA error code
// negated.
template <int kFamilies>
int blocks_per_sm(int model, int nx, int nu, int integ, int ltv) {
  mpc::FusedArgs<float> a{};
  a.integ = integ;
  a.ltv = ltv;
  static const double consts[256] = {};   // the model's constants: unused
  auto query = [](auto kernel, int threads, size_t smem) -> int {
    cudaError_t e = allow_smem(kernel, smem);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
    return e == cudaSuccess ? n : -(int)e;
  };
  return mpc::dispatch<float, kFamilies>(
      a, model, nx, nu, consts, [&](const auto& step) -> int {
        typedef typename std::decay<decltype(step)>::type Step;
        if constexpr (mpc::GroupBody<Step>::value)
          return query(fused_sqp_group_kernel<Step>, kGroupThreads,
                       group_smem<Step>());
        else
          return query(fused_sqp_kernel<Step>, 128, 0);
      });
}

// The block body's kernel for (model, nx, nu) under `integ` and `ltv` at
// horizon N: its blocks an SM in out[0] and its dynamic shared memory bytes
// in out[1]; -4 when the policy has no block body, -1 no instantiation, or
// the CUDA error code negated.
template <int kFamilies>
int block_info(int model, int nx, int nu, int integ, int ltv, int N,
               int* out) {
  mpc::FusedArgs<float> a{};
  a.integ = integ;
  a.ltv = ltv;
  static const double consts[256] = {};   // the model's constants: unused
  return mpc::dispatch<float, kFamilies>(
      a, model, nx, nu, consts, [&](const auto& step) -> int {
        typedef typename std::decay<decltype(step)>::type Step;
        if constexpr (mpc::BlockBody<Step>::value) {
          const size_t smem = (size_t)mpc::block_smem_bytes<Step>(N);
          cudaError_t e = allow_smem(fused_sqp_block_kernel<Step>, smem);
          int n = 0;
          if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, fused_sqp_block_kernel<Step>, mpc::kBlockThreads, smem);
          out[0] = n;
          out[1] = (int)smem;
          return e == cudaSuccess ? 0 : -(int)e;
        } else {
          return -4;
        }
      });
}

// ---- the LTV path's linearization and discretization (model_linearize.cuh):
// a block a tile of T instances x C tasks (`TileShape`), the tile in
// dynamic shared memory, float or double.

template <typename S, typename Model>
__global__ void __launch_bounds__(
    mpc::LinearizeTile<S, Model>::Shape::kThreads,
    mpc::LinearizeTile<S, Model>::kMinBlocks)
linearize_tile_kernel(long long B, Model m, const S* x0, const S* u0, S* A,
                      S* Bm, S* xd0) {
  typedef mpc::LinearizeTile<S, Model> L;
  extern __shared__ __align__(16) unsigned char ltv_tile[];
  S* tile = reinterpret_cast<S*>(ltv_tile);
  const long long b0 = (long long)blockIdx.x * L::Shape::T;
  const int nb = (int)(B - b0 < L::Shape::T ? B - b0 : L::Shape::T);
  const int t = (int)threadIdx.x;
  L::load(t, nb, b0, x0, u0, tile);
  __syncthreads();
  L::task(m, t, nb, tile);
  __syncthreads();
  L::store(t, nb, b0, tile, A, Bm, xd0);
}

template <typename S, int NX, int NU>
__global__ void __launch_bounds__(
    mpc::DiscreteTile<S, NX, NU>::Shape::kThreads,
    mpc::DiscreteTile<S, NX, NU>::kMinBlocks)
ltv_discrete_tile_kernel(long long B, int integ, S dt, const S* A,
                         const S* Bm, const S* xd0, const S* x0,
                         const S* u0, S* AdI, S* Bd, S* cd) {
  typedef mpc::DiscreteTile<S, NX, NU> L;
  extern __shared__ __align__(16) unsigned char ltv_tile[];
  S* tile = reinterpret_cast<S*>(ltv_tile);
  const long long b0 = (long long)blockIdx.x * L::Shape::T;
  const int nb = (int)(B - b0 < L::Shape::T ? B - b0 : L::Shape::T);
  const int t = (int)threadIdx.x;
  L::load(t, nb, b0, A, Bm, xd0, x0, u0, tile);
  __syncthreads();
  L::task(t, nb, b0, B, integ, dt, tile, AdI, Bd, cd);
}

// Launches `kernel` of tile shape Sh over B instances on `stream`.
template <typename Sh, typename K, typename... Args>
int launch_tiles(K kernel, long long B, void* stream, Args... args) {
  if (B <= 0) return 0;
  const cudaError_t e = allow_smem(kernel, Sh::kSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((B + Sh::T - 1) / Sh::T);
  kernel<<<grid, Sh::kThreads, Sh::kSmem,
           static_cast<cudaStream_t>(stream)>>>(B, args...);
  return (int)cudaGetLastError();
}

// Launch the linearization of model `model` (an mpc::ModelId, its
// constants `consts`) at B points on `stream`: x0 (B, nx), u0 (B, nu) in,
// A (B, nx, nx), Bm (B, nx, nu), xd0 (B, nx) out, batch-leading.  Returns
// cudaGetLastError(), -1 when this library does not hold the model, -5
// when the model's shape is not (nx, nu).  Does not synchronise.
template <int kFamilies, typename S>
int launch_linearize(long long B, int model, int nx, int nu,
                     const double* consts, const S* x0, const S* u0, S* A,
                     S* Bm, S* xd0, void* stream) {
  return mpc::model_dispatch<S, kFamilies>(
      model, consts, [&](const auto& m) -> int {
        typedef typename std::decay<decltype(m)>::type M;
        if (M::NX != nx || M::NU != nu) return -5;
        return launch_tiles<typename mpc::LinearizeTile<S, M>::Shape>(
            linearize_tile_kernel<S, M>, B, stream, m, x0, u0, A, Bm, xd0);
      });
}

// Launch the LTV discretization at (nx, nu) under integrator `integ` and
// step dt on `stream`: the batch-leading frozen point A (B, nx, nx),
// Bm (B, nx, nu), xd0 (B, nx), x0 (B, nx), u0 (B, nu) in, the increment
// form AdI = Ad - I (nx, nx, B), Bd (nx, nu, B), cd (nx, B) out,
// batch-innermost.  Returns cudaGetLastError(), or -1 when this library
// holds no Ltv policy at (nx, nu).  Does not synchronise.
template <int kFamilies, typename S>
int launch_ltv_discrete(long long B, int nx, int nu, int integ, S dt,
                        const S* A, const S* Bm, const S* xd0, const S* x0,
                        const S* u0, S* AdI, S* Bd, S* cd, void* stream) {
  return mpc::ltv_dispatch<S, kFamilies>(nx, nu, [&](const auto& step) -> int {
    typedef typename std::decay<decltype(step)>::type Step;
    constexpr int NX = Step::NX, NU = Step::NU;
    return launch_tiles<typename mpc::DiscreteTile<S, NX, NU>::Shape>(
        ltv_discrete_tile_kernel<S, NX, NU>, B, stream, integ, dt, A, Bm,
        xd0, x0, u0, AdI, Bd, cd);
  });
}

// Blocks an SM of the float (`f64` 0) or double linearization kernel of
// `model`, or of the discretization kernel at (nx, nu) when `model` is
// kLtvDiscreteQuery, at its block and shared memory; its tile in
// tile[0..3]: instances a tile, threads an instance, threads a block,
// shared bytes a block.  -1 when this library holds neither, or the CUDA
// error code negated.
constexpr int kLtvDiscreteQuery = -100;
template <int kFamilies, typename S>
int ltv_path_blocks_per_sm(int model, int nx, int nu, int* tile) {
  static const double consts[256] = {};   // the model's constants: unused
  auto query = [tile](auto kernel, auto shape) -> int {
    typedef decltype(shape) Sh;
    tile[0] = Sh::T;
    tile[1] = Sh::kTasks;
    tile[2] = Sh::kThreads;
    tile[3] = Sh::kSmem;
    int n = 0;
    cudaError_t e = allow_smem(kernel, Sh::kSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, Sh::kThreads, Sh::kSmem);
    return e == cudaSuccess ? n : -(int)e;
  };
  if (model == kLtvDiscreteQuery)
    return mpc::ltv_dispatch<S, kFamilies>(nx, nu, [&](const auto& step) {
      typedef typename std::decay<decltype(step)>::type Step;
      constexpr int NX = Step::NX, NU = Step::NU;
      return query(ltv_discrete_tile_kernel<S, NX, NU>,
                   typename mpc::DiscreteTile<S, NX, NU>::Shape{});
    });
  return mpc::model_dispatch<S, kFamilies>(model, consts, [&](const auto& m) {
    typedef typename std::decay<decltype(m)>::type M;
    return query(linearize_tile_kernel<S, M>,
                 typename mpc::LinearizeTile<S, M>::Shape{});
  });
}

#define MPC_LTV_PATH_EXPORTS(kFamilies, S, bits)                             \
  extern "C" int mpc_linearize_launch_##bits(                                \
      long long B, int model, int nx, int nu, const double* consts,          \
      const S* x0, const S* u0, S* A, S* Bm, S* xd0, void* stream) {         \
    return launch_linearize<kFamilies, S>(B, model, nx, nu, consts, x0, u0,  \
                                          A, Bm, xd0, stream);               \
  }                                                                          \
  extern "C" int mpc_ltv_discrete_launch_##bits(                             \
      long long B, int nx, int nu, int integ, S dt, const S* A, const S* Bm, \
      const S* xd0, const S* x0, const S* u0, S* AdI, S* Bd, S* cd,          \
      void* stream) {                                                        \
    return launch_ltv_discrete<kFamilies, S>(B, nx, nu, integ, dt, A, Bm,    \
                                             xd0, x0, u0, AdI, Bd, cd,       \
                                             stream);                        \
  }                                                                          \
  extern "C" int mpc_ltv_path_blocks_per_sm_##bits(int model, int nx,        \
                                                   int nu, int* tile) {      \
    return ltv_path_blocks_per_sm<kFamilies, S>(model, nx, nu, tile);        \
  }

// ---- the fused route's preparation (fused_prepare.cuh): a block a tile of
// T instances, their records in dynamic shared memory; float, as the solve.

template <typename S>
__global__ void __launch_bounds__(mpc::kPrepareThreads, 4)
fused_prepare_tile_kernel(mpc::PrepareArgs<S> a) {
  extern __shared__ __align__(16) unsigned char prepare_smem[];
  S* tile = reinterpret_cast<S*>(prepare_smem);
  const long long b0 = (long long)blockIdx.x * a.sh.T;
  const int nb = (int)(a.B - b0 < a.sh.T ? a.B - b0 : a.sh.T);
  const int t = (int)threadIdx.x;
  mpc::prepare_load(t, mpc::kPrepareThreads, nb, b0, a, tile);
  __syncthreads();
  mpc::prepare_tile(t, mpc::kPrepareThreads, nb, a, tile);
  __syncthreads();
  mpc::prepare_store(t, mpc::kPrepareThreads, nb, b0, a, tile);
}

// Launch the preparation of B instances at (N, nx, nu) on `stream`: the
// mpc::kPrepareIn batch-leading sources `in`, the mpc::kPrepareFields
// batch-innermost outputs `out` (FusedArgs' X0 .. mu0) and the host scalars
// {mu0, floor, mu_min, delta}.  Returns cudaGetLastError(), or -6 when one
// instance's record does not fit in a block's shared memory.  Does not
// synchronise.
inline int launch_prepare(long long B, int N, int nx, int nu,
                          const void* const* in, void* const* out,
                          const double* scal, void* stream) {
  if (B <= 0) return 0;
  const mpc::PrepareArgs<float> a =
      mpc::make_prepare_args<float>(B, N, nx, nu, in, out, scal);
  if (a.sh.T == 0) return -6;
  const size_t smem = sizeof(float) * a.sh.T * a.sh.stride;
  const cudaError_t e = allow_smem(fused_prepare_tile_kernel<float>, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((B + a.sh.T - 1) / a.sh.T);
  fused_prepare_tile_kernel<float>
      <<<grid, mpc::kPrepareThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The plain C interface of one library, for ctypes: the launcher (device
// pointers in the order of mpc::FusedArgs, host arrays of scalars, ints,
// fan rungs and model constants, the stream and where to write the body it
// launched and its threads an instance; solver/fused.py `_run_library`),
// the preparation of its inputs
// (`launch_prepare`), and the occupancy of the kernels it launches
// (chip_smoke.py); and the LTV path's linearization of the models this
// library holds and discretization of its Ltv shapes, float and double
// (solver/linearize.py), with their occupancy.
#define MPC_FUSED_LIBRARY(kFamilies)                                         \
  extern "C" int mpc_fused_launch_f32(                                       \
      long long B, int N, int model, int nx, int nu, void* const* ptrs,      \
      const float* scal, const int* ints, const float* fan,                  \
      const double* consts, void* stream, int* launched) {                   \
    return launch_fused<kFamilies>(B, N, model, nx, nu, ptrs, scal, ints,    \
                                   fan, consts, stream, launched);           \
  }                                                                          \
  extern "C" int mpc_fused_prepare_f32(                                      \
      long long B, int N, int nx, int nu, const void* const* in,             \
      void* const* out, const double* scal, void* stream) {                  \
    return launch_prepare(B, N, nx, nu, in, out, scal, stream);              \
  }                                                                          \
  extern "C" int mpc_fused_block_info(int model, int nx, int nu, int integ,  \
                                      int ltv, int N, int* out) {            \
    return block_info<kFamilies>(model, nx, nu, integ, ltv, N, out);         \
  }                                                                          \
  extern "C" int mpc_fused_blocks_per_sm(int model, int nx, int nu,          \
                                         int integ, int ltv) {               \
    return blocks_per_sm<kFamilies>(model, nx, nu, integ, ltv);              \
  }                                                                          \
  MPC_LTV_PATH_EXPORTS(kFamilies, float, f32)                                \
  MPC_LTV_PATH_EXPORTS(kFamilies, double, f64)
