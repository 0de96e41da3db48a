// Fused SQP kernel for Hopper (sm_90a): the whole batched MPC solve in one
// launch.
//
// Replaces the Pallas kernel `_make_kernel` in mahi_mpc_tpu/solver/fused.py
// (launched at fused.py:981-1004), in both of its iteration modes (fixed,
// adaptive) and all three of its step modes: the Euler nq-row path, the
// generic nx-row path (midpoint, RK4) and LTV.  The per-instance body is
// fused_sqp.cuh; each CUDA library (fused_sqp*.cu) instantiates one family
// of step policies through `launch_fused`, so nvcc builds them in parallel.
//
// What bounds it on this card: the work is a long sequential FP32 program
// per instance (N=25 stages x [dual-number linearization + a block Riccati
// step] + a fan of trial steps per iteration), with no data shared between
// instances; and each instance streams its scratch (gains K, kff, steps dX,
// dU, gradients G, Jacobian rows J, defects ck: 13.7 KB at nx=8, nu=4, N=25
// on the Euler path, 18.5 KB on the generic one) through global memory three
// times per iteration.  Design: one thread per instance, 128 threads a
// block, so the card's parallelism is the batch; every array is
// batch-innermost, so a warp's 32 loads of one element are one coalesced
// 128-byte transaction and the scratch streams through L2 rather than
// sitting in shared memory (which would hold only a few instances per SM).
// The Riccati carries (Pxx 8x8, Pxv, Pvv, px, pv) live in registers; what
// does not fit spills to local memory (PERF.md has the -Xptxas -v counts).
// The LTV step's Ad/Bd/cd (104 floats at nx=8) are read where they are used
// rather than held, for the same register budget.  The adaptive mode's
// per-tile early exit of the Pallas kernel becomes a per-thread loop exit.
#pragma once

#include <cuda_runtime.h>

#include "fused_sqp.cuh"

template <typename Step>
__global__ void __launch_bounds__(128)
fused_sqp_kernel(mpc::FusedArgs<float> a, Step step) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  mpc::solve_instance<float>(a, step, b);
}

// Launch the instantiation of family mask kFamilies that serves (model, nx,
// nu) on `stream`; does not synchronise.  Returns cudaGetLastError(), or -1
// when this library holds no instantiation for the problem.
template <int kFamilies>
int launch_fused(long long B, int N, int model, int nx, int nu,
                 void* const* ptrs, const float* scal, const int* ints,
                 const float* fan, const double* consts, void* stream) {
  if (B <= 0) return 0;
  const mpc::FusedArgs<float> a =
      mpc::make_args<float>(B, N, ptrs, scal, ints, fan);
  const unsigned grid = (unsigned)((B + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mpc::dispatch<float, kFamilies>(
      a, model, nx, nu, consts, [&](const auto& step) -> int {
        typedef typename std::decay<decltype(step)>::type Step;
        fused_sqp_kernel<Step><<<grid, 128, 0, s>>>(a, step);
        return (int)cudaGetLastError();
      });
}

// The plain C interface of one library, for ctypes: device pointers in the
// order of mpc::FusedArgs, host arrays of scalars, ints, fan rungs and model
// constants (solver/fused.py `_run_library`).
#define MPC_FUSED_LIBRARY(kFamilies)                                         \
  extern "C" int mpc_fused_launch_f32(                                       \
      long long B, int N, int model, int nx, int nu, void* const* ptrs,      \
      const float* scal, const int* ints, const float* fan,                  \
      const double* consts, void* stream) {                                  \
    return launch_fused<kFamilies>(B, N, model, nx, nu, ptrs, scal, ints,    \
                                   fan, consts, stream);                     \
  }
