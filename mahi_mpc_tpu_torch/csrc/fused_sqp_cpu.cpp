// The fused kernel's per-instance body built for the CPU, for the tests
// only: the same fused_sqp.cuh that nvcc compiles for the card, looped over
// instances and instantiated for float and double.  Built with
// `g++ -O2 -shared -fPIC` and loaded with ctypes (solver/fused.py); the
// package's main path never loads it.
#include "fused_sqp.cuh"

namespace {

template <typename S, int NQ>
void solve_all(long long B, int N, void* const* ptrs, const S* scal,
               const int* ints, const S* fan, const double* arm) {
  const mpc::FusedArgs<S> a = mpc::make_args<S>(B, N, ptrs, scal, ints, fan);
  const mpc::ArmConsts<S, NQ> c = mpc::load_arm<S, double, NQ>(arm);
  for (long long b = 0; b < B; ++b) mpc::solve_instance<S, NQ>(a, c, b);
}

template <typename S>
int solve(long long B, int N, int nq, void* const* ptrs, const S* scal,
          const int* ints, const S* fan, const double* arm) {
  switch (nq) {
    case 2: solve_all<S, 2>(B, N, ptrs, scal, ints, fan, arm); return 0;
    case 4: solve_all<S, 4>(B, N, ptrs, scal, ints, fan, arm); return 0;
    default: return -1;
  }
}

// f(x, u) and the dt-scaled acceleration Jacobian rows for M instances;
// x (nx, M), u (nu, M), fval (nx, M), jrows (nq, nz, M): batch-innermost.
template <typename S, int NQ>
void eval_all(long long M, const S* x, const S* u, S dt, const double* arm,
              S* fval, S* jrows) {
  constexpr int NX = 2 * NQ, NZ = 3 * NQ;
  const mpc::ArmConsts<S, NQ> c = mpc::load_arm<S, double, NQ>(arm);
  for (long long m = 0; m < M; ++m) {
    S xl[NX], ul[NQ], fv[NX], J[NQ][NZ];
    for (int i = 0; i < NX; ++i) xl[i] = x[i * M + m];
    for (int i = 0; i < NQ; ++i) ul[i] = u[i * M + m];
    mpc::arm_linearize<S, NQ>(c, xl, ul, dt, fv, J);
    for (int i = 0; i < NX; ++i) fval[i * M + m] = fv[i];
    for (int i = 0; i < NQ; ++i)
      for (int j = 0; j < NZ; ++j) jrows[(i * NZ + j) * M + m] = J[i][j];
  }
}

template <typename S>
int eval(long long M, int nq, const S* x, const S* u, S dt, const double* arm,
         S* fval, S* jrows) {
  switch (nq) {
    case 2: eval_all<S, 2>(M, x, u, dt, arm, fval, jrows); return 0;
    case 4: eval_all<S, 4>(M, x, u, dt, arm, fval, jrows); return 0;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int mpc_fused_solve_cpu_f32(long long B, int N, int nq, void* const* ptrs,
                            const float* scal, const int* ints,
                            const float* fan, const double* arm) {
  return solve<float>(B, N, nq, ptrs, scal, ints, fan, arm);
}

int mpc_fused_solve_cpu_f64(long long B, int N, int nq, void* const* ptrs,
                            const double* scal, const int* ints,
                            const double* fan, const double* arm) {
  return solve<double>(B, N, nq, ptrs, scal, ints, fan, arm);
}

int mpc_arm_eval_cpu_f32(long long M, int nq, const float* x, const float* u,
                         float dt, const double* arm, float* fval,
                         float* jrows) {
  return eval<float>(M, nq, x, u, dt, arm, fval, jrows);
}

int mpc_arm_eval_cpu_f64(long long M, int nq, const double* x,
                         const double* u, double dt, const double* arm,
                         double* fval, double* jrows) {
  return eval<double>(M, nq, x, u, dt, arm, fval, jrows);
}

}  // extern "C"
