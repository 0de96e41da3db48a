// Fused SQP kernel for Hopper (sm_90a): the whole batched MPC solve in one
// launch.
//
// Replaces the Pallas kernel `_make_kernel` in mahi_mpc_tpu/solver/fused.py
// (launched at fused.py:981-1004), in both of its modes, for serial arms
// with the forward-Euler step.  The per-instance body is fused_sqp.cuh.
//
// What bounds it on this card: the work is a long sequential FP32 program
// per instance (N=25 stages x [3 dual-number dynamics passes + a block
// Riccati step] + a fan of trial dynamics per iteration), with no data
// shared between instances; and each instance streams 13.7 KB of scratch
// (gains K, kff, steps dX, dU, gradients G, Jacobian rows J, defects ck at
// nx=8, nu=4, N=25) through global memory three times per iteration.
// Design: one thread per instance, 128 threads a block, so the card's
// parallelism is the batch; every array is batch-innermost, so a warp's
// 32 loads of one element are one coalesced 128-byte transaction and the
// scratch streams through L2 rather than sitting in shared memory (13.7 KB
// per instance would allow only a few instances per SM there).  The
// Riccati carries (Pxx 8x8, Pxv, Pvv, px, pv) live in registers; what does
// not fit spills to local memory (see PERF.md for the -Xptxas -v counts).
// The adaptive mode's per-tile early exit of the Pallas kernel becomes a
// per-thread loop exit.
#include <cuda_runtime.h>

#include "fused_sqp.cuh"

template <int NQ>
__global__ void __launch_bounds__(128)
fused_sqp_kernel(mpc::FusedArgs<float> a, mpc::ArmConsts<float, NQ> arm) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  mpc::solve_instance<float, NQ>(a, arm, b);
}

// Plain C interface for ctypes: device pointers in the order of
// mpc::FusedArgs, host arrays of scalars, ints, fan rungs and arm constants.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (or cudaErrorInvalidValue for an unsupported nq).
extern "C" int mpc_fused_launch_f32(long long B, int N, int nq,
                                    void* const* ptrs, const float* scal,
                                    const int* ints, const float* fan,
                                    const double* arm, void* stream) {
  if (B <= 0) return 0;
  const mpc::FusedArgs<float> a =
      mpc::make_args<float>(B, N, ptrs, scal, ints, fan);
  const unsigned grid = (unsigned)((B + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 2:
      fused_sqp_kernel<2><<<grid, 128, 0, s>>>(
          a, mpc::load_arm<float, double, 2>(arm));
      break;
    case 4:
      fused_sqp_kernel<4><<<grid, 128, 0, s>>>(
          a, mpc::load_arm<float, double, 4>(arm));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
