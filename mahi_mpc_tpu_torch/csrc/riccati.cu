// Riccati KKT kernel for Hopper (sm_90a): a batch of LQR subproblems of the
// lanes SQP, one launch per SQP iteration.
//
// Replaces the Pallas kernel `_riccati_kernel` in
// mahi_mpc_tpu/solver/pallas_riccati.py (launched by `solve_lqr_pallas_lanes`
// at pallas_riccati.py:231).  The per-instance body is riccati.cuh.
//
// What bounds it on this card: each instance reads its QP, 10,856 floats
// (43 KB) at N=25, nz=12, nu=4, reads Az, Bz and r once more in the forward
// rollout (5,100), and writes 412 floats of solution plus 1,300 of gains
// (written in the backward sweep, read back in the forward one): ~76 KB an
// instance, ~1.25 GB at B=16,384, ~0.37 ms at 3.35 TB/s.  The arithmetic is
// ~5.5k multiply-adds a stage at nz=12 (the two 12x12x12 products of Qzz
// dominate), ~4.5 GFLOP for the batch, ~0.07 ms at the card's ~67 TFLOP/s
// of float32 — so the floor is the bytes.  Design: one thread per instance, 128 threads a block, so the
// batch is the parallelism and no padding is needed (threads past B
// return); every array is batch-innermost, so a warp's 32 loads of one
// element are one coalesced 128-byte transaction.  The cost-to-go (P, p)
// and the stage blocks live in per-thread arrays; at nz=12 they exceed the
// 255-register cap and spill to local memory (counts in PERF.md), which is
// cached in L1.  A'P is folded into Qzz and Qzu one row at a time, so it is
// never held whole.
#include <cuda_runtime.h>

#include "riccati.cuh"

template <int NZ, int NU>
__global__ void __launch_bounds__(128)
riccati_kernel(mpc_riccati::RiccatiArgs<float> a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  mpc_riccati::riccati_instance<float, NZ, NU>(a, b);
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
  const unsigned grid = (unsigned)((B + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPC_RICCATI_LAUNCH(NZ_, NU_)                               \
  if (nz == NZ_ && nu == NU_) {                                    \
    riccati_kernel<NZ_, NU_><<<grid, 128, 0, s>>>(a);              \
    return (int)cudaGetLastError();                                \
  }
  MPC_RICCATI_SHAPES(MPC_RICCATI_LAUNCH)
#undef MPC_RICCATI_LAUNCH
  return (int)cudaErrorInvalidValue;
}
