// The fused kernel's bodies built for the CPU, for the tests only: the same
// fused_sqp.cuh (one thread an instance), fused_sqp_group.cuh (the W lanes
// of an instance run one after another) and fused_sqp_block.cuh (the
// block's threads run one after another, phase by phase) that nvcc
// compiles for the card, each for every instantiation family that has it,
// looped over instances and built for float and double.  Built with
// `g++ -O2 -shared -fPIC` and loaded with ctypes (solver/fused.py); the
// package's main path never loads it.  A generated build (solver/target.py
// `kernel_target`) includes this file after its step policy with
// MPC_GENERATED defined: it then holds that policy alone (and, with
// MPC_GENERATED_MODEL, evaluates its model under model id kGeneratedModel).
// The LTV path's linearization and discretization (model_linearize.cuh)
// and the fused route's preparation (fused_prepare.cuh) are looped over
// instances here too, as their kernels run them.
#include <limits>
#include <vector>

#include "fused_prepare.cuh"
#include "fused_sqp_block.cuh"
#include "model_linearize.cuh"

#if defined(MPC_GENERATED)
#define MPC_CPU_FAMILIES mpc::kGenerated
#else
#define MPC_CPU_FAMILIES mpc::kAllFamilies
#endif

namespace {

template <typename S>
int solve(long long B, int N, int model, int nx, int nu, void* const* ptrs,
          const S* scal, const int* ints, const S* fan, const double* c) {
  const mpc::FusedArgs<S> a = mpc::make_args<S>(B, N, ptrs, scal, ints, fan);
  return mpc::dispatch<S, MPC_CPU_FAMILIES>(
      a, model, nx, nu, c, [&](const auto& step) -> int {
        for (long long b = 0; b < B; ++b) mpc::solve_instance<S>(a, step, b);
        return 0;
      });
}

// The group body of any policy, at the policy's width (its W lanes run one
// after another, phase by phase).  The tile is followed by guard entries
// that no write may reach (-2 if one did: on the card that write would
// land in the next group's tile); -3 when the policy's shape does not
// split over its group (`group_fits`: a generated shape).
template <typename S>
int solve_group(long long B, int N, int model, int nx, int nu,
                void* const* ptrs, const S* scal, const int* ints,
                const S* fan, const double* c) {
  const mpc::FusedArgs<S> a = mpc::make_args<S>(B, N, ptrs, scal, ints, fan);
  return mpc::dispatch<S, MPC_CPU_FAMILIES>(
      a, model, nx, nu, c, [&](const auto& step) -> int {
        typedef std::decay_t<decltype(step)> Step;
        typedef mpc::GroupStep<S, Step> GS;
        if constexpr (!mpc::group_fits<S, Step>()) {
          return -3;
        } else {
          constexpr int kSize = GS::Tile::kSize, kGuard = 64;
          const S mark = S(-1234.5);
          S tile[kSize + kGuard];
          for (int e = kSize; e < kSize + kGuard; ++e) tile[e] = mark;
          for (long long b = 0; b < B; ++b)
            mpc::solve_group<S>(a, step, b, mpc::Group<GS::W>{0, 0u}, tile);
          for (int e = kSize; e < kSize + kGuard; ++e)
            if (!(tile[e] == mark)) return -2;
          return 0;
        }
      });
}

// The block body of a policy `BlockBody` names.  Every instance starts from
// a buffer of NaN standing in for the block's shared memory, so a value
// read before the body writes it shows in the outputs; guard entries
// follow it (-2 if a write reached one).  -4 when the policy has no block
// body.
template <typename S>
int solve_block(long long B, int N, int model, int nx, int nu,
                void* const* ptrs, const S* scal, const int* ints,
                const S* fan, const double* c) {
  const mpc::FusedArgs<S> a = mpc::make_args<S>(B, N, ptrs, scal, ints, fan);
  return mpc::dispatch<S, MPC_CPU_FAMILIES>(
      a, model, nx, nu, c, [&](const auto& step) -> int {
        typedef std::decay_t<decltype(step)> Step;
        if constexpr (!mpc::BlockBody<Step>::value) {
          return -4;
        } else {
          const int n = mpc::BlockLayout<S, Step>(N).end, kGuard = 64;
          const S mark = S(-1234.5);
          std::vector<S> sh(n + kGuard, mark);
          for (long long b = 0; b < B; ++b) {
            for (int e = 0; e < n; ++e)
              sh[e] = std::numeric_limits<S>::quiet_NaN();
            mpc::solve_block<S>(a, step, b,
                                mpc::Block<mpc::kBlockThreads>{0},
                                sh.data());
          }
          for (int e = n; e < n + kGuard; ++e)
            if (!(sh[e] == mark)) return -2;
          return 0;
        }
      });
}

// For M points (batch-innermost x (nx, M), u (nu, M)) of one model: f and
// its Jacobian d f / d[x; u] (nx, nz, M), and the step F = x + increment
// under `integ` and its Jacobian I + rows (nx, nz, M), through the
// dual-number code the kernel runs (the generic policy's `increment_rows`).
template <typename S, typename Model>
void eval_model(const Model& m, long long M, int integ, const S* x,
                const S* u, S dt, S* fval, S* fjac, S* sval, S* sjac) {
  constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU;
  typedef mpc::Dual<S, 1> D;
  for (long long p = 0; p < M; ++p) {
    S xl[NX], ul[NU], fv[NX], sv[NX];
    for (int i = 0; i < NX; ++i) xl[i] = x[i * M + p];
    for (int j = 0; j < NU; ++j) ul[j] = u[j * M + p];
    mpc::model_f(m, xl, ul, fv);
    for (int d = 0; d < NZ; ++d) {
      D xd[NX], ud[NU], out[NX];
      mpc::seed<S, 1, NX, NU>(xl, ul, d, xd, ud);
      mpc::model_f(m, xd, ud, out);
      for (int i = 0; i < NX; ++i) fjac[(i * NZ + d) * M + p] = out[i].d[0];
    }
    mpc::increment_rows(m, integ, dt, xl, ul, sv, [&](int d, int i, S v) {
      sjac[(i * NZ + d) * M + p] = S(d == i ? 1 : 0) + v;
    });
    for (int i = 0; i < NX; ++i) {
      fval[i * M + p] = fv[i];
      sval[i * M + p] = xl[i] + sv[i];
    }
  }
}

// The increment F - x (nx, M) and its rows [A - I | B] (nx, nz, M) at the
// same points, as the generic policy stores them.
template <typename S, typename Model>
void eval_increment(const Model& m, long long M, int integ, const S* x,
                    const S* u, S dt, S* ival, S* irows) {
  constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU;
  for (long long p = 0; p < M; ++p) {
    S xl[NX], ul[NU], iv[NX];
    for (int i = 0; i < NX; ++i) xl[i] = x[i * M + p];
    for (int j = 0; j < NU; ++j) ul[j] = u[j * M + p];
    mpc::increment_rows(m, integ, dt, xl, ul, iv, [&](int d, int i, S v) {
      irows[(i * NZ + d) * M + p] = v;
    });
    for (int i = 0; i < NX; ++i) ival[i * M + p] = iv[i];
  }
}

// Runs fn on the registered model `model` built from the constants c (in a
// generated build, on its generated model alone, whatever its policy).
template <typename S, typename F>
int with_model(int model, const double* c, const F& fn) {
#if defined(MPC_GENERATED_MODEL)
  if (model == mpc::kGeneratedModel) return fn(mpc::gen::Model<S>{});
#endif
  return mpc::model_dispatch<S, MPC_CPU_FAMILIES>(model, c, fn);
}

template <typename S>
int eval(long long M, int model, int integ, const S* x, const S* u, S dt,
         const double* c, S* fval, S* fjac, S* sval, S* sjac) {
  return with_model<S>(model, c, [&](const auto& m) {
    eval_model<S>(m, M, integ, x, u, dt, fval, fjac, sval, sjac);
    return 0;
  });
}

template <typename S>
int increment(long long M, int model, int integ, const S* x, const S* u,
              S dt, const double* c, S* ival, S* irows) {
  return with_model<S>(model, c, [&](const auto& m) {
    eval_increment<S>(m, M, integ, x, u, dt, ival, irows);
    return 0;
  });
}

// The linearization of B points as the card's blocks run it
// (model_linearize.cuh `linearize_host`: tile after tile, each phase's
// threads one after another, last to first when `reverse`): -1 when the
// build does not hold the model, -5 when its shape is not (nx, nu).
template <typename S>
int linearize_all(long long B, int model, int nx, int nu, const double* c,
                  const S* x0, const S* u0, S* A, S* Bm, S* xd0,
                  int reverse) {
  return mpc::model_dispatch<S, MPC_CPU_FAMILIES>(
      model, c, [&](const auto& m) -> int {
        typedef std::decay_t<decltype(m)> M;
        if (M::NX != nx || M::NU != nu) return -5;
        mpc::linearize_host<S>(m, B, x0, u0, A, Bm, xd0, reverse != 0);
        return 0;
      });
}

// The LTV discretization of B frozen points as the card's blocks run it
// (`ltv_discrete_host`): -1 when the build holds no Ltv policy at (nx, nu).
template <typename S>
int ltv_discrete_all(long long B, int nx, int nu, int integ, S dt,
                     const S* A, const S* Bm, const S* xd0, const S* x0,
                     const S* u0, S* AdI, S* Bd, S* cd, int reverse) {
  return mpc::ltv_dispatch<S, MPC_CPU_FAMILIES>(
      nx, nu, [&](const auto& step) -> int {
        typedef std::decay_t<decltype(step)> Step;
        mpc::ltv_discrete_host<S, Step::NX, Step::NU>(
            B, integ, dt, A, Bm, xd0, x0, u0, AdI, Bd, cd, reverse != 0);
        return 0;
      });
}

#if !defined(MPC_GENERATED)
// f(x, u) and the dt-scaled acceleration Jacobian rows of a serial arm for
// M instances (the nq-row policy's `acc_rows`); x (nx, M), u (nu, M),
// fval (nx, M), jrows (nq, nz, M): batch-innermost.
template <typename S, int NQ>
void arm_rows_all(long long M, const S* x, const S* u, S dt,
                  const double* arm, S* fval, S* jrows) {
  constexpr int NX = 2 * NQ, NZ = 3 * NQ;
  const mpc::ArmModel<S, NQ> m{mpc::load_arm<S, double, NQ>(arm)};
  for (long long p = 0; p < M; ++p) {
    S xl[NX], ul[NQ], fv[NX], J[NQ][NZ];
    for (int i = 0; i < NX; ++i) xl[i] = x[i * M + p];
    for (int i = 0; i < NQ; ++i) ul[i] = u[i * M + p];
    mpc::acc_rows<S>(m, xl, ul, dt, fv, J);
    for (int i = 0; i < NX; ++i) fval[i * M + p] = fv[i];
    for (int i = 0; i < NQ; ++i)
      for (int j = 0; j < NZ; ++j) jrows[(i * NZ + j) * M + p] = J[i][j];
  }
}

// The same through the folded linearization, every column by one call:
// with kSweep the one-sweep columns the four-lane group body runs where NQ
// = 4 (arm_dynamics.cuh `arm_q_qd_columns`, then `arm_u_column`), else a
// pass a column (`arm_q_column`, `arm_qd_column`, `arm_u_column`: the block
// body's, the LTV linearization's and the two-joint group body's); fval
// from the q_0 pass's value part.
template <typename S, int NQ, bool kSweep>
void arm_fold_all(long long M, const S* x, const S* u, S dt,
                  const double* arm, S* fval, S* jrows) {
  constexpr int NX = 2 * NQ, NZ = 3 * NQ;
  const mpc::ArmConsts<S, NQ> c = mpc::load_arm<S, double, NQ>(arm);
  for (long long p = 0; p < M; ++p) {
    S xl[NX], ul[NQ], L[NQ][NQ], qdd[NQ], qdd_j[NQ], col[NQ], col_qd[NQ];
    for (int i = 0; i < NX; ++i) xl[i] = x[i * M + p];
    for (int i = 0; i < NQ; ++i) ul[i] = u[i * M + p];
    auto put = [&](int j, const S* v) {
      for (int i = 0; i < NQ; ++i) jrows[(i * NZ + j) * M + p] = dt * v[i];
    };
    if constexpr (kSweep) {
      for (int j = 0; j < NQ; ++j) {
        mpc::arm_q_qd_columns(c, xl, xl + NQ, ul, j, L,
                              j == 0 ? qdd : qdd_j, col, col_qd);
        put(j, col);
        put(NQ + j, col_qd);
        mpc::arm_u_column(L, j, col);
        put(NX + j, col);
      }
    } else {
      for (int j = NQ - 1; j >= 0; --j) {
        mpc::arm_q_column(c, xl, xl + NQ, ul, j, L, j == 0 ? qdd : qdd_j,
                          col);
        put(j, col);
      }
      for (int j = 0; j < NQ; ++j) {
        mpc::arm_qd_column(c, xl, xl + NQ, j, L, col);
        put(NQ + j, col);
        mpc::arm_u_column(L, j, col);
        put(NX + j, col);
      }
    }
    for (int i = 0; i < NQ; ++i) {
      fval[i * M + p] = xl[NQ + i];
      fval[(NQ + i) * M + p] = qdd[i];
    }
  }
}

// `kind` 0: the dual-number rows; 1: the folded columns; 2: the one-sweep
// columns.
template <typename S>
int arm_rows(long long M, int nq, int kind, const S* x, const S* u, S dt,
             const double* arm, S* fval, S* jrows) {
  typedef void (*All)(long long, const S*, const S*, S, const double*, S*,
                      S*);
  const All two[] = {arm_rows_all<S, 2>, arm_fold_all<S, 2, false>,
                     arm_fold_all<S, 2, true>};
  const All four[] = {arm_rows_all<S, 4>, arm_fold_all<S, 4, false>,
                      arm_fold_all<S, 4, true>};
  if (kind < 0 || kind > 2 || (nq != 2 && nq != 4)) return -1;
  (nq == 2 ? two : four)[kind](M, x, u, dt, arm, fval, jrows);
  return 0;
}
#endif  // !MPC_GENERATED

}  // namespace

extern "C" {

int mpc_fused_solve_cpu_f32(long long B, int N, int model, int nx, int nu,
                            void* const* ptrs, const float* scal,
                            const int* ints, const float* fan,
                            const double* consts) {
  return solve<float>(B, N, model, nx, nu, ptrs, scal, ints, fan, consts);
}

int mpc_fused_solve_cpu_f64(long long B, int N, int model, int nx, int nu,
                            void* const* ptrs, const double* scal,
                            const int* ints, const double* fan,
                            const double* consts) {
  return solve<double>(B, N, model, nx, nu, ptrs, scal, ints, fan, consts);
}

int mpc_fused_solve_group_cpu_f32(long long B, int N, int model, int nx,
                                  int nu, void* const* ptrs,
                                  const float* scal, const int* ints,
                                  const float* fan, const double* consts) {
  return solve_group<float>(B, N, model, nx, nu, ptrs, scal, ints, fan,
                            consts);
}

int mpc_fused_solve_group_cpu_f64(long long B, int N, int model, int nx,
                                  int nu, void* const* ptrs,
                                  const double* scal, const int* ints,
                                  const double* fan, const double* consts) {
  return solve_group<double>(B, N, model, nx, nu, ptrs, scal, ints, fan,
                             consts);
}

int mpc_fused_solve_block_cpu_f32(long long B, int N, int model, int nx,
                                  int nu, void* const* ptrs,
                                  const float* scal, const int* ints,
                                  const float* fan, const double* consts) {
  return solve_block<float>(B, N, model, nx, nu, ptrs, scal, ints, fan,
                            consts);
}

int mpc_fused_solve_block_cpu_f64(long long B, int N, int model, int nx,
                                  int nu, void* const* ptrs,
                                  const double* scal, const int* ints,
                                  const double* fan, const double* consts) {
  return solve_block<double>(B, N, model, nx, nu, ptrs, scal, ints, fan,
                             consts);
}

#if !defined(MPC_GENERATED)
int mpc_arm_eval_cpu_f32(long long M, int nq, const float* x, const float* u,
                         float dt, const double* arm, float* fval,
                         float* jrows) {
  return arm_rows<float>(M, nq, 0, x, u, dt, arm, fval, jrows);
}

int mpc_arm_eval_cpu_f64(long long M, int nq, const double* x,
                         const double* u, double dt, const double* arm,
                         double* fval, double* jrows) {
  return arm_rows<double>(M, nq, 0, x, u, dt, arm, fval, jrows);
}

// The same arguments, through the folded columns.
int mpc_arm_fold_cpu_f32(long long M, int nq, const float* x, const float* u,
                         float dt, const double* arm, float* fval,
                         float* jrows) {
  return arm_rows<float>(M, nq, 1, x, u, dt, arm, fval, jrows);
}

int mpc_arm_fold_cpu_f64(long long M, int nq, const double* x,
                         const double* u, double dt, const double* arm,
                         double* fval, double* jrows) {
  return arm_rows<double>(M, nq, 1, x, u, dt, arm, fval, jrows);
}

// The same arguments, through the one-sweep columns.
int mpc_arm_sweep_cpu_f32(long long M, int nq, const float* x,
                          const float* u, float dt, const double* arm,
                          float* fval, float* jrows) {
  return arm_rows<float>(M, nq, 2, x, u, dt, arm, fval, jrows);
}

int mpc_arm_sweep_cpu_f64(long long M, int nq, const double* x,
                          const double* u, double dt, const double* arm,
                          double* fval, double* jrows) {
  return arm_rows<double>(M, nq, 2, x, u, dt, arm, fval, jrows);
}

#endif  // !MPC_GENERATED

// f (nx, M) and its Jacobian (nx, nz, M), the step F = x + increment and
// its Jacobian, through the dual-number code the kernel runs.
int mpc_model_eval_cpu_f32(long long M, int model, int integ, const float* x,
                           const float* u, float dt, const double* consts,
                           float* fval, float* fjac, float* sval,
                           float* sjac) {
  return eval<float>(M, model, integ, x, u, dt, consts, fval, fjac, sval,
                     sjac);
}

int mpc_model_eval_cpu_f64(long long M, int model, int integ,
                           const double* x, const double* u, double dt,
                           const double* consts, double* fval, double* fjac,
                           double* sval, double* sjac) {
  return eval<double>(M, model, integ, x, u, dt, consts, fval, fjac, sval,
                      sjac);
}

// The generic policy's increment F - x (nx, M) and its rows [A - I | B]
// (nx, nz, M) at the same points, float32 or float64.
int mpc_model_increment_cpu_f32(long long M, int model, int integ,
                                const float* x, const float* u, float dt,
                                const double* consts, float* ival,
                                float* irows) {
  return increment<float>(M, model, integ, x, u, dt, consts, ival, irows);
}

int mpc_model_increment_cpu_f64(long long M, int model, int integ,
                                const double* x, const double* u, double dt,
                                const double* consts, double* ival,
                                double* irows) {
  return increment<double>(M, model, integ, x, u, dt, consts, ival, irows);
}

// The linearization at B points, batch-leading: x0 (B, nx), u0 (B, nu)
// in, A (B, nx, nx), Bm (B, nx, nu), xd0 (B, nx) out; a block's threads
// last to first when `reverse`.
int mpc_linearize_cpu_f32(long long B, int model, int nx, int nu,
                          const double* consts, const float* x0,
                          const float* u0, float* A, float* Bm, float* xd0,
                          int reverse) {
  return linearize_all<float>(B, model, nx, nu, consts, x0, u0, A, Bm, xd0,
                              reverse);
}

int mpc_linearize_cpu_f64(long long B, int model, int nx, int nu,
                          const double* consts, const double* x0,
                          const double* u0, double* A, double* Bm,
                          double* xd0, int reverse) {
  return linearize_all<double>(B, model, nx, nu, consts, x0, u0, A, Bm, xd0,
                               reverse);
}

// The LTV discretization of B batch-leading frozen points into the
// batch-innermost increment form AdI (nx, nx, B), Bd (nx, nu, B), cd (nx, B).
int mpc_ltv_discrete_cpu_f32(long long B, int nx, int nu, int integ,
                             float dt, const float* A, const float* Bm,
                             const float* xd0, const float* x0,
                             const float* u0, float* AdI, float* Bd,
                             float* cd, int reverse) {
  return ltv_discrete_all<float>(B, nx, nu, integ, dt, A, Bm, xd0, x0, u0,
                                 AdI, Bd, cd, reverse);
}

int mpc_ltv_discrete_cpu_f64(long long B, int nx, int nu, int integ,
                             double dt, const double* A, const double* Bm,
                             const double* xd0, const double* x0,
                             const double* u0, double* AdI, double* Bd,
                             double* cd, int reverse) {
  return ltv_discrete_all<double>(B, nx, nu, integ, dt, A, Bm, xd0, x0, u0,
                                  AdI, Bd, cd, reverse);
}

// The fused route's preparation of B instances at (N, nx, nu) as the
// card's blocks run it (`prepare_host`: a block's threads last to first
// when `reverse`): the mpc::kPrepareIn batch-leading sources `in`, the
// batch-innermost FusedArgs inputs `out`, the host scalars {mu0, floor,
// mu_min, delta}; -6 where one instance's record does not fit in a block.
int mpc_fused_prepare_cpu_f32(long long B, int N, int nx, int nu,
                              const void* const* in, void* const* out,
                              const double* scal, int reverse) {
  return mpc::prepare_host(
      mpc::make_prepare_args<float>(B, N, nx, nu, in, out, scal),
      reverse != 0);
}

int mpc_fused_prepare_cpu_f64(long long B, int N, int nx, int nu,
                              const void* const* in, void* const* out,
                              const double* scal, int reverse) {
  return mpc::prepare_host(
      mpc::make_prepare_args<double>(B, N, nx, nu, in, out, scal),
      reverse != 0);
}

}  // extern "C"
