// The registered models' dynamics, their explicit integrators and their
// forward-mode Jacobians, written once for the host and the device.
//
// A model is a struct with compile-time sizes NX, NU, NQ (x = [q, qd],
// NX = 2 NQ) and the accelerations `acc(x, u, qdd)`, a member template on
// the scalar T (float, double or a Dual) with the constants in the plain
// scalar S, so the same code gives values and dual-number derivatives:
//
// - ArmModel<S, NQ>: the serial arms (arm_dynamics.cuh, models/arm.py);
// - Pendulum, Cartpole: models/pendulum.py;
// - DoublePendulum, Acrobot: models/double_pendulum.py;
// - gen::Model<S>: a user's model, generated from its traced f at first use
//   (models/codegen.py): `acc` as above, or, for a first-order model,
//   NQ = 0 and all of `f(x, u, out)`.
//
// The closed forms follow the tensor `f` of the PyTorch models term by
// term, with the constants that Python folds (m g l, m l^2, ...) computed
// once by the model's factory (models/pendulum.py, double_pendulum.py:
// `with_closed_form`), in the order `load` reads them.
#pragma once

#include "arm_dynamics.cuh"

namespace mpc {

// Integrators (models/integrators.py), passed as a runtime int.
enum Integrator { kEuler = 0, kMidpoint = 1, kRk4 = 2 };

// Tangent directions per dual pass.  One tangent a pass spills least on
// sm_90a (PERF.md has the -Xptxas -v counts of 1, 2, 4 and 12).
constexpr int kDualTangents = 1;

template <typename S, int NQ_>
struct ArmModel {
  static constexpr int NQ = NQ_, NX = 2 * NQ_, NU = NQ_;
  ArmConsts<S, NQ_> c;
  template <typename T>
  MPC_HD void acc(const T* x, const T* u, T* qdd) const {
    arm_qdd<T, S, NQ>(c, x, x + NQ, u, qdd);
  }
};

// Torque-actuated pendulum: constants {b, m g l, m l^2}.
template <typename S>
struct Pendulum {
  static constexpr int NQ = 1, NX = 2, NU = 1;
  S b, mgl, ml2;
  MPC_HD static Pendulum load(const double* c) {
    return {S(c[0]), S(c[1]), S(c[2])};
  }
  template <typename T>
  MPC_HD void acc(const T* x, const T* u, T* qdd) const {
    qdd[0] = ((u[0] - b * x[1]) - mgl * m_sin(x[0])) / ml2;
  }
};

// Cart-pole, force on the cart: constants {mc, mp, l, g, mp l, (mc+mp) g}.
template <typename S>
struct Cartpole {
  static constexpr int NQ = 2, NX = 4, NU = 1;
  S mc, mp, l, g, mpl, mcg;
  MPC_HD static Cartpole load(const double* c) {
    return {S(c[0]), S(c[1]), S(c[2]), S(c[3]), S(c[4]), S(c[5])};
  }
  template <typename T>
  MPC_HD void acc(const T* x, const T* u, T* qdd) const {
    const T s = m_sin(x[1]), co = m_cos(x[1]);
    const T thd = x[3];
    const T den = mc + (mp * s) * s;
    qdd[0] = (u[0] + (mp * s) * ((l * thd) * thd + g * co)) / den;
    qdd[1] = (((-u[0]) * co - (((mpl * thd) * thd) * co) * s) - mcg * s)
             / (l * den);
  }
};

// Double pendulum in manipulator form: constants {m L^2, m g L}.
// `kShoulder` selects the shoulder torque: u[0] for the double pendulum,
// none for the acrobot (u = [TB]).
template <typename S, bool kShoulder>
struct TwoLinkPointMass {
  static constexpr int NQ = 2, NX = 4, NU = kShoulder ? 2 : 1;
  S ml2, mgl;
  MPC_HD static TwoLinkPointMass load(const double* c) {
    return {S(c[0]), S(c[1])};
  }
  template <typename T>
  MPC_HD void acc(const T* x, const T* u, T* qdd) const {
    const T qAd = x[2], qBd = x[3];
    const T cB = m_cos(x[1]), sB = m_sin(x[1]);
    const T m11 = ml2 * (S(3) + S(2) * cB);
    const T m12 = ml2 * (S(1) + cB);
    const T c1 = (-ml2 * sB) * ((S(2) * qAd) * qBd + qBd * qBd);
    const T c2 = ((ml2 * sB) * qAd) * qAd;
    const T cAB = m_cos(x[0] + x[1]);
    const T g1 = mgl * (S(2) * m_cos(x[0]) + cAB);
    const T g2 = mgl * cAB;
    const T TA = kShoulder ? u[0] : T(S(0));
    const T TB = kShoulder ? u[1] : u[0];
    const T rhs1 = (TA - c1) - g1;
    const T rhs2 = (TB - c2) - g2;
    const T det = m11 * ml2 - m12 * m12;
    qdd[0] = (ml2 * rhs1 - m12 * rhs2) / det;
    qdd[1] = (m11 * rhs2 - m12 * rhs1) / det;
  }
};

template <typename S> using DoublePendulum = TwoLinkPointMass<S, true>;
template <typename S> using Acrobot = TwoLinkPointMass<S, false>;

// f(x, u) = [qd, acc(x, u)] for a second-order model; a first-order model
// (NQ = 0, a generated one: models/codegen.py) gives all of f(x, u) itself.
template <typename T, typename Model>
MPC_HD void model_f(const Model& m, const T* x, const T* u, T* out) {
  if constexpr (Model::NQ == 0) {
    m.f(x, u, out);
  } else {
    T qdd[Model::NQ];
    m.acc(x, u, qdd);
#pragma unroll
    for (int i = 0; i < Model::NQ; ++i) {
      out[i] = x[Model::NQ + i];
      out[Model::NQ + i] = qdd[i];
    }
  }
}

// The increment F(x, u) - x of one explicit step (models/integrators.py
// `make_increment`), formed directly and not as a difference: Euler dt f,
// midpoint dt f(x + dt/2 k1), RK4 dt/6 (((k1 + 2 k2) + 2 k3) + k4).  Under
// dual numbers its tangent is the increment's own, built from the stages'
// tangents: the seed of x enters only through the stage points.  The
// stages run in a loop, so f is inlined once whatever the integrator.
template <typename T, typename Model, typename S>
MPC_HD void model_increment(const Model& m, int integ, S dt, const T* x,
                            const T* u, T* out) {
  constexpr int NX = Model::NX;
  const int stages = integ == kRk4 ? 4 : (integ == kMidpoint ? 2 : 1);
  const S half = S(0.5) * dt;
  T xs[NX], k[NX], acc[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = x[i];
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    model_f(m, xs, u, k);
    const S c = (integ == kRk4 && s == 2) ? dt : half;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (integ == kRk4 && s > 0)
        acc[i] = acc[i] + (s == 3 ? k[i] : S(2) * k[i]);
      else
        acc[i] = k[i];          // Euler's one stage; midpoint's last wins
      xs[i] = x[i] + c * k[i];
    }
  }
  const S h = integ == kRk4 ? dt / S(6) : dt;
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = h * acc[i];
}

// Seed dual inputs for pass `pass`: direction d = pass K + k of z = [x; u].
// Seeds by comparison, so no array is indexed by the runtime `pass`.
template <typename S, int K, int NX, int NU>
MPC_HD void seed(const S* x, const S* u, int pass, Dual<S, K>* xd,
                 Dual<S, K>* ud) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    xd[i] = Dual<S, K>(x[i]);
#pragma unroll
    for (int k = 0; k < K; ++k) xd[i].d[k] = S(pass * K + k == i ? 1 : 0);
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    ud[j] = Dual<S, K>(u[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) ud[j].d[k] = S(pass * K + k == NX + j ? 1 : 0);
  }
}

// f(x, u) and the dt-scaled Jacobian rows of the acceleration block,
// Jrows[i] = dt * d acc_i / d[x; u]  (NQ x NZ), for one instance: the
// nq-row path of the Euler step of a second-order model.
template <typename S, typename Model>
MPC_HD void acc_rows(const Model& m, const S* x, const S* u, S dt, S* fval,
                     S (&Jrows)[Model::NQ][Model::NX + Model::NU]) {
  constexpr int NQ = Model::NQ, NX = Model::NX, NU = Model::NU,
                NZ = NX + NU;
  constexpr int K = kDualTangents < NZ ? kDualTangents : NZ;
  constexpr int PASSES = (NZ + K - 1) / K;
  typedef Dual<S, K> D;
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    D xd[NX], ud[NU], qdd[NQ];
    seed<S, K, NX, NU>(x, u, pass, xd, ud);
    m.acc(xd, ud, qdd);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (pass == 0) {
        fval[i] = x[NQ + i];
        fval[NQ + i] = qdd[i].v;
      }
#pragma unroll
      for (int col = 0; col < NZ; ++col)
        if (col / K == pass) Jrows[i][col] = dt * qdd[i].d[col % K];
    }
  }
}

// The step's increment F(x, u) - x and its Jacobian rows d(F - x) / d[x; u]
// = [A - I | B] (NX x NZ) through the integrator: the generic nx-row path.
// Column d of the rows goes to `col(d, i, value)`, so a caller can stream
// it to memory.
template <typename S, typename Model, typename Col>
MPC_HD void increment_rows(const Model& m, int integ, S dt, const S* x,
                           const S* u, S* val, const Col& col) {
  constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU;
  constexpr int K = kDualTangents < NZ ? kDualTangents : NZ;
  constexpr int PASSES = (NZ + K - 1) / K;
  typedef Dual<S, K> D;
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    D xd[NX], ud[NU], out[NX];
    seed<S, K, NX, NU>(x, u, pass, xd, ud);
    model_increment(m, integ, dt, xd, ud, out);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (pass == 0) val[i] = out[i].v;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (pass * K + k < NZ) col(pass * K + k, i, out[i].d[k]);
    }
  }
}

}  // namespace mpc
