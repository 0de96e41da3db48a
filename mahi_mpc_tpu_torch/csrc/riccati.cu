// Riccati KKT kernel for Hopper (sm_90a): a batch of LQR subproblems of the
// lanes SQP, one launch per SQP iteration.
//
// Replaces the Pallas kernel `_riccati_kernel` in
// mahi_mpc_tpu/solver/pallas_riccati.py (launched by `solve_lqr_pallas_lanes`
// at pallas_riccati.py:231).  The per-instance body is riccati.cuh.
//
// What bounds it on this card: bytes.  At N=25, nz=12, nu=4 an instance's
// stage QP is 10,856 floats (43.4 KB: 428 a stage, Hf and gf) and its
// solution 412 floats, so the function moves 738.5 MB at B=16,384: 0.220 ms
// at 3.35 TB/s.  That is chip_smoke.py's `bound_ms`.  This design moves
// more: the rollout reads Az, Bz and r a second time (5,100 floats an
// instance) and the gains K, kff (1,300) go to global memory in the
// backward sweep and come back in the rollout, ~76 KB an instance, ~1.24 GB
// in all: 0.371 ms (`design_bound_ms`).  The arithmetic, ~5.5k
// multiply-adds a stage at nz=12 (the two 12x12x12 products of Qzz), is
// ~4.7 GFLOP for the batch, 0.07 ms at 67 TFLOP/s of float32.
//
// Design: a group of G threads an instance (G = 16 at nz=12, 8 at nz=5 or
// 6, 4 at nz=3), 128 threads a block; lane i owns row i of P and of the Q
// blocks, lane c a column of the gain solve, so no thread holds a whole
// matrix and nothing spills.  Each group has a tile in shared memory with
// two stage buffers: while the group computes stage k, cp.async copies the
// next stage's blocks (1,712 B at nz=12; each field's block is contiguous
// in the batch-leading QP, so 16-byte copies, coalesced) into the other
// one: at four blocks an SM (128 registers a thread, 41.5 KB of shared
// memory a block at nz=12) up to 55 KB of copies an SM are in flight.
// Three blocks an SM ran slower, five spilled (PERF.md).  The rollout does
// the same with Az, Bz, r, K and kff, and broadcasts dz and du over the
// group with warp shuffles.
#include <cuda_runtime.h>

#include "riccati.cuh"

constexpr int kRicThreads = 128;
constexpr int kRicMinBlocks = 4;

template <int NZ, int NU>
__global__ void __launch_bounds__(kRicThreads, kRicMinBlocks)
riccati_group_kernel(mpc_riccati::RiccatiArgs<float> a) {
  extern __shared__ __align__(16) float ric_tiles[];
  typedef mpc_riccati::RicShape<NZ, NU> Sh;
  const int t = threadIdx.x, gi = t / Sh::G;
  const long long b = (long long)blockIdx.x * (kRicThreads / Sh::G) + gi;
  if (b >= a.B) return;                  // the whole group leaves together
  const unsigned mask = ((1u << Sh::G) - 1u) << ((t & 31) & ~(Sh::G - 1));
  const mpc_riccati::RicGroup<Sh::G> g{t % Sh::G, mask};
  mpc_riccati::riccati_group<float, NZ, NU>(a, b, g,
                                            ric_tiles + gi * Sh::kSize);
}

template <int NZ, int NU>
constexpr int ric_smem_bytes() {
  typedef mpc_riccati::RicShape<NZ, NU> Sh;
  return (int)sizeof(float) * Sh::kSize * (kRicThreads / Sh::G);
}

template <int NZ, int NU>
int ric_prepare() {
  constexpr int smem = ric_smem_bytes<NZ, NU>();
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        riccati_group_kernel<NZ, NU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return 0;
}

// Plain C interface for ctypes: mpc_riccati::kNumPtrs device pointers in the
// order of RiccatiArgs.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the library is
// not built for).
extern "C" int mpc_riccati_launch_f32(long long B, int N, int nz, int nu,
                                      void* const* ptrs, void* stream) {
  if (B <= 0) return 0;
  const mpc_riccati::RiccatiArgs<float> a =
      mpc_riccati::make_args<float>(B, N, ptrs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPC_RICCATI_LAUNCH(NZ_, NU_)                                        \
  if (nz == NZ_ && nu == NU_) {                                             \
    const int e = ric_prepare<NZ_, NU_>();                                  \
    if (e != 0) return e;                                                   \
    constexpr int per = kRicThreads / mpc_riccati::RicShape<NZ_, NU_>::G;   \
    const unsigned grid = (unsigned)((B + per - 1) / per);                  \
    riccati_group_kernel<NZ_, NU_>                                          \
        <<<grid, kRicThreads, ric_smem_bytes<NZ_, NU_>(), s>>>(a);          \
    return (int)cudaGetLastError();                                         \
  }
  MPC_RICCATI_SHAPES(MPC_RICCATI_LAUNCH)
#undef MPC_RICCATI_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the (nz, nu) instantiation takes, in
// bytes; -1 for a shape the library is not built for.
extern "C" int mpc_riccati_smem_bytes(int nz, int nu) {
#define MPC_RICCATI_SMEM(NZ_, NU_) \
  if (nz == NZ_ && nu == NU_) return ric_smem_bytes<NZ_, NU_>();
  MPC_RICCATI_SHAPES(MPC_RICCATI_SMEM)
#undef MPC_RICCATI_SMEM
  return -1;
}

// Blocks of the (nz, nu) instantiation an SM holds at once (the occupancy
// calculator, with its shared memory); -1 on an unbuilt shape or an error.
extern "C" int mpc_riccati_blocks_per_sm(int nz, int nu) {
#define MPC_RICCATI_OCC(NZ_, NU_)                                          \
  if (nz == NZ_ && nu == NU_) {                                            \
    int n = -1;                                                            \
    if (ric_prepare<NZ_, NU_>() != 0 ||                                    \
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
            &n, riccati_group_kernel<NZ_, NU_>, kRicThreads,               \
            ric_smem_bytes<NZ_, NU_>()) != cudaSuccess)                    \
      return -1;                                                           \
    return n;                                                              \
  }
  MPC_RICCATI_SHAPES(MPC_RICCATI_OCC)
#undef MPC_RICCATI_OCC
  return -1;
}
