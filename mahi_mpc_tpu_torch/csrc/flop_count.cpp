// The fused kernel's floating-point operations, counted: the group body
// (fused_sqp_group.cuh) or the one-thread body (fused_sqp.cuh) of any
// instantiation, instantiated on a scalar that is a double and tallies every
// add or subtract, multiply, divide or square root, and sine, cosine or log
// done on it.  A body runs as it runs for the card (the host loop over the
// group's W lanes does the lanes' work once each), so the tally is the
// work of the kernel's own code for the given inputs.  It also counts the
// work that the body repeats and the function needs once: for the group body
// what its lanes repeat (`group_repeats`), for the one-thread body what a
// stage's linearization repeats (`linearize_repeats`).  The tally less that
// is the function's operations, the numerator of the kernel's roofline
// bound (chip_smoke.py).  Built with g++ and loaded with ctypes
// (solver/fused.py `count_fused_ops`); comparisons, selects, |x| and loads
// are not counted.  A generated build includes it after its step policy,
// with MPC_GENERATED defined, to count that policy (solver/target.py
// `kernel_target`).  It counts the LTV path's linearization and
// discretization (model_linearize.cuh) the same way, with what their tasks
// repeat (`linearize_task_repeats`, `discrete_task_repeats`).
#include <algorithm>
#include <vector>

#include "fused_sqp_block.cuh"
#include "model_linearize.cuh"

#if !defined(MPC_CPU_FAMILIES)
#if defined(MPC_GENERATED)
#define MPC_CPU_FAMILIES mpc::kGenerated
#else
#define MPC_CPU_FAMILIES mpc::kAllFamilies
#endif
#endif

namespace mpc {

struct OpCount {
  double add = 0, mul = 0, div_sqrt = 0, transcendental = 0;
};
static OpCount g_ops;

struct Flop {
  double v;
  Flop() = default;
  constexpr Flop(double x) : v(x) {}
};
static_assert(sizeof(Flop) == sizeof(double), "Flop arrays alias doubles");

inline Flop operator+(Flop a, Flop b) { g_ops.add += 1; return a.v + b.v; }
inline Flop operator-(Flop a, Flop b) { g_ops.add += 1; return a.v - b.v; }
inline Flop operator*(Flop a, Flop b) { g_ops.mul += 1; return a.v * b.v; }
inline Flop operator/(Flop a, Flop b) {
  g_ops.div_sqrt += 1;
  return a.v / b.v;
}
inline Flop operator-(Flop a) { return -a.v; }
inline bool operator<(Flop a, Flop b) { return a.v < b.v; }
inline bool operator>(Flop a, Flop b) { return a.v > b.v; }
inline bool operator<=(Flop a, Flop b) { return a.v <= b.v; }
inline bool operator>=(Flop a, Flop b) { return a.v >= b.v; }
inline bool operator==(Flop a, Flop b) { return a.v == b.v; }
inline bool operator!=(Flop a, Flop b) { return a.v != b.v; }
inline Flop m_sqrt(Flop x) { g_ops.div_sqrt += 1; return sqrt(x.v); }
inline Flop m_sin(Flop x) { g_ops.transcendental += 1; return sin(x.v); }
inline Flop m_cos(Flop x) { g_ops.transcendental += 1; return cos(x.v); }
inline Flop m_log(Flop x) { g_ops.transcendental += 1; return log(x.v); }
inline Flop m_abs(Flop x) { return fabs(x.v); }
inline Flop m_tan(Flop x) { g_ops.transcendental += 1; return tan(x.v); }
inline Flop m_exp(Flop x) { g_ops.transcendental += 1; return exp(x.v); }
inline Flop m_tanh(Flop x) { g_ops.transcendental += 1; return tanh(x.v); }
inline Flop m_pow(Flop x, Flop e) {
  g_ops.transcendental += 1;
  return pow(x.v, e.v);
}
inline Flop m_value(Flop x) { return x; }
inline bool m_isfinite(Flop x) { return m_isfinite(x.v); }

// The float32 epsilon: the counted run takes the card's noise floor.
template <> struct Eps<Flop> {
  static constexpr double value = 1.1920928955078125e-07;
};

inline void add(OpCount& to, const OpCount& n, double times) {
  to.add += times * n.add;
  to.mul += times * n.mul;
  to.div_sqrt += times * n.div_sqrt;
  to.transcendental += times * n.transcendental;
}

// The operations of f() alone.
template <typename F>
OpCount ops_of(const F& f) {
  const OpCount saved = g_ops;
  g_ops = OpCount();
  f();
  const OpCount n = g_ops;
  g_ops = saved;
  return n;
}

// What the group body does more than once in one stage of one iteration,
// where the function needs it once:
//  - the value part (kinematics, M, its Cholesky factor, qdd): every lane
//    forms it, as the values of its q column's dual-number pass or by
//    arm_value, so G - 1 times more than once (G the group's 4 lanes);
//  - where a lane's qd column has a pass of its own (NQ below the group's
//    width: `GroupStep::linearize`), the plain kinematics and RNEA values
//    under each qd column's tangent; where one sweep carries a lane's q
//    and qd tangents (NQ = G), it forms them once;
//  - in the Riccati step: Prp and the Cholesky of Quu, which every lane
//    forms; B' Pxv and Qxu Kx, each entry formed twice; the mirrored
//    entries of Quu, Pxx and Pvv; the adds of A's identity block (`At`
//    adds 1 or 0 to Jr at every use, where the function adds the NQ ones
//    once);
//  - lane 0's merit sums forming the defects and dt f again, and every
//    rung after the first forming the rung-free x - x' and dx - dx'.
// A pinned head stage forms no Qxu Kx, Pxx or Pvv terms.  Each piece that
// is a function of arm_dynamics.cuh is counted by running it; the rest
// follows the loops of fused_sqp_group.cuh.
template <int NQ>
OpCount repeated_ops(const ArmConsts<Flop, NQ>& c, int n_fan, bool pinned) {
  constexpr int NX = 2 * NQ, NU = NQ,
                G = GroupStep<Flop, FastNq<Flop, ArmModel<Flop, NQ>>>::W;
  Flop q[NQ], qd[NQ], u[NQ], L[NQ][NQ], M[NQ][NQ], h[NQ], qdd[NQ];
  for (int i = 0; i < NQ; ++i) q[i] = qd[i] = u[i] = Flop(0.1 * (i + 1));
  OpCount r;
  add(r, ops_of([&] { arm_value(c, q, qd, u, L, qdd); }), G - 1);
  if (NQ != G)
    add(r, ops_of([&] { arm_chain<false>(c, q, qd, M, h); }), NQ);
  const double tri = NU * (NU - 1) / 2.0, xtri = NX * (NX - 1) / 2.0;
  r.mul += (G - 1) * NX * NX;                       // Prp
  r.add += (G - 1) * NX * NX;
  for (int j = 0; j < NU; ++j) {                    // Cholesky of Quu
    r.mul += (G - 1) * (j + (NU - 1 - j) * (j + 1.0));
    r.add += (G - 1) * (j + (NU - 1 - j) * double(j));
    r.div_sqrt += (G - 1) * 2;
  }
  r.mul += (NU * NU + tri) * NQ;                    // B' Pxv, B' Pxx B
  r.add += (NU * NU + tri) * (NQ - 1) + 3 * tri;    // and Quu mirrored
  r.add += (NX * NX + NX * (NX + 1) / 2 + NX + NU * NX) * NQ - NQ;   // At
  if (!pinned) {
    r.mul += NX * NX * NU + xtri + 4 * tri;         // Qxu Kx; Pxx, Pvv
    r.add += NX * NX * (NU - 1) + 3 * xtri + tri;   // mirrored
  }
  r.mul += 2 * NX;                                  // lane 0's merit sums
  r.add += 3 * NX + NU;
  r.add += (n_fan - 1) * 2.0 * NX;                  // the rungs
  return r;
}

// A point to evaluate a step at in the counts below: the operation counts
// of the models' code do not depend on the values.
template <int NX, int NU>
void count_point(Flop (&x)[NX], Flop (&u)[NU]) {
  for (int i = 0; i < NX; ++i) x[i] = Flop(0.1 * (i + 1));
  for (int j = 0; j < NU; ++j) u[j] = Flop(-0.1 * (j + 1));
}

// What the one-thread body does more than once in one stage's
// linearization, where the function needs it once:
//  - the step's value: each of the NZ / K dual passes forms it again (the
//    increment under the generic policy, the accelerations under the
//    nq-row policy), so passes 2..P repeat the value part of the first,
//    which is the same code run on plain scalars;
//  - the adds of A's identity block: A = I + rows adds 1 or 0 to every
//    entry, where the function adds the NX ones of the diagonal (the nq-row
//    policy: the NQ ones of its acceleration rows; its position rows are
//    the constant [I, dt I]).
template <typename Model>
OpCount linearize_repeats(const Generic<Flop, Model>& s, Flop dt) {
  constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU;
  constexpr int K = kDualTangents < NZ ? kDualTangents : NZ;
  Flop x[NX], u[NU], out[NX];
  count_point(x, u);
  OpCount r;
  add(r, ops_of([&] { model_increment(s.m, s.integ, dt, x, u, out); }),
      (NZ + K - 1) / K - 1);
  r.add += NX * NX - NX;
  return r;
}

template <typename Model>
OpCount linearize_repeats(const FastNq<Flop, Model>& s, Flop) {
  constexpr int NX = Model::NX, NU = Model::NU, NQ = Model::NQ,
                NZ = NX + NU;
  constexpr int K = kDualTangents < NZ ? kDualTangents : NZ;
  Flop x[NX], u[NU], qdd[NQ];
  count_point(x, u);
  OpCount r;
  add(r, ops_of([&] { s.m.acc(x, u, qdd); }), (NZ + K - 1) / K - 1);
  r.add += NX * NX - NQ;
  return r;
}

template <int NX, int NU>
OpCount linearize_repeats(const Ltv<Flop, NX, NU>&, Flop) {
  OpCount r;
  r.add += NX * NX - NX;
  return r;
}

// What one instance's linearization tasks (model_linearize.cuh
// `linearize_task`) repeat, where the function needs it once: the value
// part.  A serial arm's NQ q tasks each form it (the chain's values, M's
// Cholesky factor and qdd: `arm_value`), so NQ - 1 times more than once,
// and each of its NQ qd tasks runs the plain kinematics and RNEA values
// again under its tangent (as `repeated_ops` counts them for the group
// body).  Every other model's NZ one-tangent passes each form f's value,
// so NZ - 1 times more.
template <typename Model>
OpCount linearize_task_repeats(const Model& m) {
  constexpr int NX = Model::NX, NU = Model::NU;
  Flop x[NX], u[NU], out[NX];
  count_point(x, u);
  OpCount r;
  if constexpr (IsArm<Model>::value) {
    constexpr int NQ = Model::NQ;
    Flop L[NQ][NQ], M[NQ][NQ], h[NQ];
    add(r, ops_of([&] { arm_value(m.c, x, x + NQ, u, L, out); }), NQ - 1);
    add(r, ops_of([&] { arm_chain<false>(m.c, x, x + NQ, M, h); }), NQ);
  } else {
    add(r, ops_of([&] { model_f(m, x, u, out); }), NX + NU - 1);
  }
  return r;
}

// What one instance's discretization tasks (`ltv_discrete_task`) repeat:
// each of the NZ passes forms the step's value (the increment of the
// frozen model at z = 0), so NZ - 1 times more than once.
template <int NX, int NU>
OpCount discrete_task_repeats(int integ, Flop dt) {
  Flop A[NX * NX], B[NX * NU], xd0[NX], x[NX], u[NU], out[NX];
  count_point(x, u);
  std::fill(A, A + NX * NX, Flop(0.5));
  std::fill(B, B + NX * NU, Flop(0.5));
  std::fill(xd0, xd0 + NX, Flop(0.5));
  const AffineModel<Flop, NX, NU> m{A, B, xd0, x, u};
  OpCount r;
  add(r, ops_of([&] { model_increment(m, integ, dt, x, u, out); }),
      NX + NU - 1);
  return r;
}

// The iterations instance b ran: all of them in fixed mode.
inline double iterations(const FusedArgs<Flop>& a, long long b) {
  return a.adaptive ? a.stats[b + 6 * a.B].v : a.n_iter;
}

// What the group body repeats over the B instances, given its tally.  The
// arms under Euler: `repeated_ops` a stage of each iteration (the folded
// linearization is the group body's own method).  Every other policy (LTV,
// the generic path, the closed forms under Euler): the group body computes
// the one-thread body's function (the same linearization, the same Riccati
// step), whose minimum is the one-thread body's tally less
// `linearize_repeats`; so that is counted by running the one-thread body on
// the same inputs, and the group body repeats the rest of its tally.
template <int NQ>
OpCount group_repeats(const FastNq<Flop, ArmModel<Flop, NQ>>& step,
                      const FusedArgs<Flop>& a, OpCount) {
  double iters = 0;
  for (long long b = 0; b < a.B; ++b) iters += iterations(a, b);
  const int pin = a.n_pin < a.N ? a.n_pin : a.N;
  OpCount r;
  add(r, repeated_ops(step.m.c, a.n_fan, false), iters * (a.N - pin));
  add(r, repeated_ops(step.m.c, a.n_fan, true), iters * pin);
  return r;
}

template <typename Step>
OpCount group_repeats(const Step& step, const FusedArgs<Flop>& a,
                      OpCount tally) {
  double iters = 0;
  OpCount least = ops_of([&] {
    for (long long b = 0; b < a.B; ++b) {
      solve_instance<Flop>(a, step, b);
      iters += iterations(a, b);
    }
  });
  add(least, linearize_repeats(step, a.dt), -iters * a.N);
  add(tally, least, -1.0);
  return tally;
}

// The block body's critical path: the operations of the busiest thread of
// each stretch between two block barriers, summed over the stretches (the
// threads of a stretch run at once; one stretch waits for the one before).
// `PathBlock` stands in for `Block` on the host: `each` runs the tasks one
// after another and keeps the largest task's count, `PathLanes` the group's
// lanes and keeps the largest lane's count, summed over the group's phases
// (each waits at the group barrier for the one before), and `on` counts its
// thread's work; a stretch's path is the largest of the three (they run on
// different threads at once), added to its region's tally at the barrier.
struct PathTally {
  double each = 0, lanes = 0, on = 0, region[kRegions] = {};
};
static PathTally g_path;

inline double total(const OpCount& c) {
  return c.add + c.mul + c.div_sqrt + c.transcendental;
}

template <int W_>
struct PathLanes {
  static constexpr int W = W_, kHostLanes = W;
  template <typename F>
  void phase(const F& f) const {
    double most = 0;
    for (int l = 0; l < W; ++l) {
      const double before = total(g_ops);
      f(l);
      most = std::max(most, total(g_ops) - before);
    }
    g_path.lanes += most;
  }
  static int slot(int l) { return l; }
};

struct PathBlock {
  template <int W> using Lanes = PathLanes<W>;
  template <typename F>
  void each(int n, const F& f) const {
    double most = 0;
    for (int i = 0; i < n; ++i) {
      const double before = total(g_ops);
      f(i);
      most = std::max(most, total(g_ops) - before);
    }
    g_path.each += most;
  }
  void sync(Region r) const {
    g_path.region[r] += std::max(g_path.each, std::max(g_path.lanes,
                                                       g_path.on));
    g_path.each = g_path.lanes = g_path.on = 0;
  }
  template <typename F>
  void on(int, const F& f) const {
    const double before = total(g_ops);
    f();
    g_path.on += total(g_ops) - before;
  }
  bool group(int) const { return true; }
  template <int W>
  PathLanes<W> lanes() const { return PathLanes<W>{}; }
};

}  // namespace mpc

extern "C" {

// Runs the group body (group = 1) or the one-thread body (group = 0) of the
// instantiation that serves the problem (either body, whichever the card
// runs) over the B instances given (the fused kernel's
// arguments, every array float64) and adds its operations to counts[0..3]:
// adds, multiplies, divides and square roots, transcendentals; and the part
// of them that it repeats (`group_repeats` for the group body,
// `linearize_repeats` a stage of each iteration for the one-thread body) to
// counts[4..7].  Returns -1 when no instantiation serves the problem, -3
// when group = 1 and the policy's shape does not split over its group.
int mpc_fused_count_ops(long long B, int N, int model, int nx, int nu,
                        void* const* ptrs, const double* scal,
                        const int* ints, const double* fan,
                        const double* consts, int group, double* counts) {
  using mpc::Flop;
  const mpc::FusedArgs<Flop> a = mpc::make_args<Flop>(
      B, N, ptrs, reinterpret_cast<const Flop*>(scal), ints,
      reinterpret_cast<const Flop*>(fan));
  mpc::g_ops = mpc::OpCount();
  mpc::OpCount repeated;
  auto thread = [&](const auto& step) -> int {
    const mpc::OpCount stage = mpc::linearize_repeats(step, a.dt);
    double iters = 0;
    for (long long b = 0; b < B; ++b) {
      mpc::solve_instance<Flop>(a, step, b);
      iters += mpc::iterations(a, b);
    }
    mpc::add(repeated, stage, iters * a.N);
    return 0;
  };
  auto grouped = [&](const auto& step) -> int {
    typedef std::decay_t<decltype(step)> Step;
    typedef mpc::GroupStep<Flop, Step> GS;
    if constexpr (!mpc::group_fits<Flop, Step>()) {
      return -3;                 // no group body at this shape
    } else {
      Flop tile[GS::Tile::kSize];
      for (long long b = 0; b < B; ++b)
        mpc::solve_group<Flop>(a, step, b, mpc::Group<GS::W>{0, 0u}, tile);
      repeated = mpc::group_repeats(step, a, mpc::g_ops);
      return 0;
    }
  };
  const int rc = group
      ? mpc::dispatch<Flop, MPC_CPU_FAMILIES>(a, model, nx, nu, consts,
                                              grouped)
      : mpc::dispatch<Flop, MPC_CPU_FAMILIES>(a, model, nx, nu, consts,
                                              thread);
  counts[0] += mpc::g_ops.add;
  counts[1] += mpc::g_ops.mul;
  counts[2] += mpc::g_ops.div_sqrt;
  counts[3] += mpc::g_ops.transcendental;
  counts[4] += repeated.add;
  counts[5] += repeated.mul;
  counts[6] += repeated.div_sqrt;
  counts[7] += repeated.transcendental;
  return rc;
}

// The block body's critical path for each instance given (the fused
// kernel's arguments, every array float64), by region (`mpc::Region`):
// adds to path[r] the operations of the busiest thread of each stretch of
// region r (`PathBlock`), summed over the instances.  -4 when the policy
// has no block body, -1 no instantiation.
int mpc_fused_count_path(long long B, int N, int model, int nx, int nu,
                         void* const* ptrs, const double* scal,
                         const int* ints, const double* fan,
                         const double* consts, double* path) {
  using mpc::Flop;
  const mpc::FusedArgs<Flop> a = mpc::make_args<Flop>(
      B, N, ptrs, reinterpret_cast<const Flop*>(scal), ints,
      reinterpret_cast<const Flop*>(fan));
  mpc::g_path = mpc::PathTally();
  const int rc = mpc::dispatch<Flop, MPC_CPU_FAMILIES>(
      a, model, nx, nu, consts, [&](const auto& step) -> int {
        typedef std::decay_t<decltype(step)> Step;
        if constexpr (!mpc::BlockBody<Step>::value) {
          return -4;
        } else {
          std::vector<Flop> sh(mpc::BlockLayout<Flop, Step>(N).end,
                               Flop(0.0));
          for (long long b = 0; b < B; ++b)
            mpc::solve_block<Flop>(a, step, b, mpc::PathBlock{}, sh.data());
          return 0;
        }
      });
  for (int r = 0; r < mpc::kRegions; ++r) path[r] += mpc::g_path.region[r];
  return rc;
}

// The body the card runs for (model, nx, nu) under integrator `integ` and
// LTV flag `ltv`, B instances at horizon N, as the launcher's rule picks it
// (`mpc::card_body`): 0 one thread an instance, 1 the group body, 2 the
// block body, -1 no instantiation; its threads an instance in `threads`
// (solver/fused.py `card_body`).
int mpc_fused_card_body(int model, int nx, int nu, int integ, int ltv,
                        long long B, int N, int* threads) {
  mpc::FusedArgs<mpc::Flop> a{};
  a.integ = integ;
  a.ltv = ltv;
  static const double consts[256] = {};   // the model's constants: unused
  return mpc::dispatch<mpc::Flop, MPC_CPU_FAMILIES>(
      a, model, nx, nu, consts, [&](const auto& step) -> int {
        typedef std::decay_t<decltype(step)> Step;
        return mpc::card_body<Step>(B, N, threads);
      });
}

// The operations of the LTV path's linearization (its tasks as the card's
// blocks run them, model_linearize.cuh `linearize_host`) at B points
// (float64 arrays, batch-leading as the kernel takes them), added to
// counts[0..3] as {add, mul, div_sqrt, transcendental}, and the part of
// them that the tasks repeat (`linearize_task_repeats`) to counts[4..7];
// -1 when the build does not hold the model.
int mpc_linearize_count_ops(long long B, int model, int nx, int nu,
                            const double* consts, const double* x0,
                            const double* u0, double* counts) {
  using mpc::Flop;
  std::vector<Flop> out(B * (nx * nx + nx * nu + nx));
  mpc::g_ops = mpc::OpCount();
  mpc::OpCount repeated;
  const int rc = mpc::model_dispatch<Flop, MPC_CPU_FAMILIES>(
      model, consts, [&](const auto& m) -> int {
        typedef std::decay_t<decltype(m)> M;
        if (M::NX != nx || M::NU != nu) return -5;
        Flop* A = out.data();
        mpc::linearize_host<Flop>(
            m, B, reinterpret_cast<const Flop*>(x0),
            reinterpret_cast<const Flop*>(u0), A, A + B * nx * nx,
            A + B * (nx * nx + nx * nu), false);
        mpc::add(repeated, mpc::linearize_task_repeats(m), double(B));
        return 0;
      });
  counts[0] += mpc::g_ops.add;
  counts[1] += mpc::g_ops.mul;
  counts[2] += mpc::g_ops.div_sqrt;
  counts[3] += mpc::g_ops.transcendental;
  counts[4] += repeated.add;
  counts[5] += repeated.mul;
  counts[6] += repeated.div_sqrt;
  counts[7] += repeated.transcendental;
  return rc;
}

// The operations of the LTV discretization (`ltv_discrete_host`) of B
// frozen points, and what its tasks repeat (`discrete_task_repeats`), as
// `mpc_linearize_count_ops` counts them.
int mpc_ltv_discrete_count_ops(long long B, int nx, int nu, int integ,
                               double dt, const double* A, const double* Bm,
                               const double* xd0, const double* x0,
                               const double* u0, double* counts) {
  using mpc::Flop;
  std::vector<Flop> out(B * (nx * nx + nx * nu + nx));
  mpc::g_ops = mpc::OpCount();
  mpc::OpCount repeated;
  const int rc = mpc::ltv_dispatch<Flop, MPC_CPU_FAMILIES>(
      nx, nu, [&](const auto& step) -> int {
        typedef std::decay_t<decltype(step)> Step;
        mpc::add(repeated, mpc::discrete_task_repeats<Step::NX, Step::NU>(
                               integ, Flop(dt)),
                 double(B));
        Flop* AdI = out.data();
        mpc::ltv_discrete_host<Flop, Step::NX, Step::NU>(
            B, integ, Flop(dt), reinterpret_cast<const Flop*>(A),
            reinterpret_cast<const Flop*>(Bm),
            reinterpret_cast<const Flop*>(xd0),
            reinterpret_cast<const Flop*>(x0),
            reinterpret_cast<const Flop*>(u0), AdI, AdI + B * nx * nx,
            AdI + B * (nx * nx + nx * nu), false);
        return 0;
      });
  counts[0] += mpc::g_ops.add;
  counts[1] += mpc::g_ops.mul;
  counts[2] += mpc::g_ops.div_sqrt;
  counts[3] += mpc::g_ops.transcendental;
  counts[4] += repeated.add;
  counts[5] += repeated.mul;
  counts[6] += repeated.div_sqrt;
  counts[7] += repeated.transcendental;
  return rc;
}

}  // extern "C"
