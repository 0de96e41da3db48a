// The LTV path's two per-instance functions, written once for the host and
// the device: the frozen linearization of a model and the exact affine
// discrete step of that linearization.
//
// - `linearize_one` replaces the JAX service's jitted
//   `jax.vmap(dynamics.linearize)` (mahi_mpc_tpu/runtime/batch_service.py
//   `self._relin`, and `ModelControl.calc_u`'s `linearize` at B=1):
//   (A, B, x_dot0) = (df/dx, df/du, f) at (x0, u0).  A closed form or a
//   generated model takes NZ one-tangent dual passes of `model_f` (the
//   first pass also gives f); a serial arm takes its folded columns
//   (arm_dynamics.cuh `arm_q_column`, `arm_qd_column`, `arm_u_column`), so
//   A = [[0, I], [dacc/dx]] and B = [[0], [dacc/du]].
// - `ltv_discrete_one` replaces `_ltv_discrete`
//   (mahi_mpc_tpu/solver/batched.py:58-82, run inside the jitted fused
//   wrapper): the frozen f(x, u) = A (x - x0) + B (u - u0) + x_dot0 is
//   affine, so every explicit step of it is affine, F(z) = F(0) + rows z.
//   `AffineModel` is that f in the shape `model_f` takes, and the step's
//   increment and its rows at z = 0 through `increment_rows` are cd and
//   [Ad - I | Bd]: Ad - I is formed directly, never as Ad minus the
//   identity (the increment form of every step policy, fused_sqp.cuh).
//
// What bounds them on the H100: neither moves much.  A linearization reads
// nx + nu and writes nx (nx + nu + 1) numbers an instance (7.6 MB at
// B=16384 for the 4-DOF arm), a discretization reads nx (nx + nu + 2) + nu
// and writes nx (nx + nu + 1) (14.4 MB at (8, 4)); the arithmetic is a few
// thousand to a few tens of thousands of operations an instance, so both
// bounds are a few microseconds and a launch of either is bound by its
// latency.  One thread an instance, 128 a block; the batch-leading rows an
// instance reads and writes are contiguous, so a warp's accesses are
// strided (uncoalesced) and served through L1.  A linearization writes
// batch-leading, the layout `LinPoint` keeps (and the JAX package's
// state_dict); a discretization writes batch-innermost, the layout the
// fused kernel streams (`FusedArgs::AdI`, `Bd`, `cd`).
#pragma once

#include <utility>

#include "fused_sqp.cuh"

namespace mpc {

namespace gen {
template <typename S> struct Model;   // a generated build's (codegen.py)
}

template <typename M> struct IsArm { static constexpr bool value = false; };
template <typename S, int NQ> struct IsArm<ArmModel<S, NQ>> {
  static constexpr bool value = true;
};

// (A, B, x_dot0) of one model at one point: A (NX, NX), Bm (NX, NU) and
// xdot (NX), row-major, written through the pointers.
template <typename S, typename Model>
MPC_HD void linearize_one(const Model& m, const S* x, const S* u, S* A,
                          S* Bm, S* xdot) {
  constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU;
  if constexpr (IsArm<Model>::value) {
    constexpr int NQ = Model::NQ;
    S L[NQ][NQ], qdd[NQ], qdd_j[NQ], col[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i * NX + j] = S(j == NQ + i ? 1 : 0);
#pragma unroll
      for (int j = 0; j < NU; ++j) Bm[i * NU + j] = S(0);
    }
    // q columns last to first, so L and qdd are the q_0 pass's value part
#pragma unroll 1
    for (int j = NQ - 1; j >= 0; --j) {
      arm_q_column(m.c, x, x + NQ, u, j, L, j == 0 ? qdd : qdd_j, col);
#pragma unroll
      for (int i = 0; i < NQ; ++i) A[(NQ + i) * NX + j] = col[i];
    }
#pragma unroll 1
    for (int j = 0; j < NQ; ++j) {
      arm_qd_column(m.c, x, x + NQ, j, L, col);
#pragma unroll
      for (int i = 0; i < NQ; ++i) A[(NQ + i) * NX + NQ + j] = col[i];
      arm_u_column(L, j, col);
#pragma unroll
      for (int i = 0; i < NQ; ++i) Bm[(NQ + i) * NU + j] = col[i];
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      xdot[i] = x[NQ + i];
      xdot[NQ + i] = qdd[i];
    }
  } else {
    typedef Dual<S, 1> D;
#pragma unroll 1
    for (int d = 0; d < NZ; ++d) {
      D xd[NX], ud[NU], out[NX];
      seed<S, 1, NX, NU>(x, u, d, xd, ud);
      model_f(m, xd, ud, out);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (d == 0) xdot[i] = out[i].v;
        if (d < NX)
          A[i * NX + d] = out[i].d[0];
        else
          Bm[i * NU + d - NX] = out[i].d[0];
      }
    }
  }
}

// The frozen linearization's right-hand side as a first-order model
// (NQ = 0): f(x, u) = A (x - x0) + B (u - u0) + x_dot0, each dot product
// left to right, over one instance's batch-leading rows.
template <typename S, int NX_, int NU_>
struct AffineModel {
  static constexpr int NQ = 0, NX = NX_, NU = NU_;
  const S *A, *B, *xd0, *x0, *u0;
  template <typename T>
  MPC_HD void f(const T* x, const T* u, T* out) const {
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

// The exact affine step of one instance's frozen linearization under
// `integ`, as its increment: (Ad - I, Bd, cd), element e of each at
// out[e * stride] (the fused kernel's batch-innermost layout at stride B).
template <typename S, int NX, int NU>
MPC_HD void ltv_discrete_one(const AffineModel<S, NX, NU>& m, int integ,
                             S dt, S* AdI, S* Bd, S* cd, long long stride) {
  S zx[NX], zu[NU], val[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) zx[i] = S(0);
#pragma unroll
  for (int j = 0; j < NU; ++j) zu[j] = S(0);
  increment_rows(m, integ, dt, zx, zu, val, [&](int d, int i, S v) {
    if (d < NX)
      AdI[(i * NX + d) * stride] = v;
    else
      Bd[(i * NU + d - NX) * stride] = v;
  });
#pragma unroll
  for (int i = 0; i < NX; ++i) cd[i * stride] = val[i];
}

// Instance b of a batch: x0 (B, NX), u0 (B, NU) in; A (B, NX, NX),
// Bm (B, NX, NU), xd0 (B, NX) out.
template <typename S, typename Model>
MPC_HD void linearize_instance(const Model& m, long long b, const S* x0,
                               const S* u0, S* A, S* Bm, S* xd0) {
  constexpr int NX = Model::NX, NU = Model::NU;
  S x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[b * NX + i];
#pragma unroll
  for (int j = 0; j < NU; ++j) u[j] = u0[b * NU + j];
  linearize_one<S>(m, x, u, A + b * NX * NX, Bm + b * NX * NU, xd0 + b * NX);
}

// Instance b of B: the batch-leading frozen point (A, Bm, xd0, x0, u0) in;
// AdI (NX, NX, B), Bd (NX, NU, B), cd (NX, B) out.
template <typename S, int NX, int NU>
MPC_HD void ltv_discrete_instance(long long b, long long B, int integ, S dt,
                                  const S* A, const S* Bm, const S* xd0,
                                  const S* x0, const S* u0, S* AdI, S* Bd,
                                  S* cd) {
  const AffineModel<S, NX, NU> m{A + b * NX * NX, Bm + b * NX * NU,
                                 xd0 + b * NX, x0 + b * NX, u0 + b * NU};
  ltv_discrete_one(m, integ, dt, AdI + b, Bd + b, cd + b, B);
}

// Calls fn(model) with the model `model` (a ModelId; c its constants) among
// the families of kFamilies, or returns -1: the serial arms with kArmFast
// (the library of the main path, fused_sqp.cu), the closed forms with
// kModels, and a generated build's gen::Model (MPC_GENERATED_MODEL) where
// its step policy is LTV: the LTV unit of a user's model
// (solver/fused.py `ltv_unit`).
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
