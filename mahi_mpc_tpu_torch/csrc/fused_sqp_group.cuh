// The fused SQP body with a group of W threads (lanes) on one instance: the
// body of the kernel that the card launches for the step policies
// `GroupBody` names (fused_sqp_launch.cuh), and, built by g++, of the tests'
// CPU build for every policy.  The width W is a compile-time constant of
// the group step policy: four lanes for the serial arms under every
// integrator and for the LTV step where NX is a multiple of 4 from 8 up,
// two for the closed-form models, the generated models (models/codegen.py)
// and the other LTV shapes; a shape that does not split over its group
// (`group_fits`: NX a multiple of W) has no group body.  A policy the card
// does not run on the group body runs the one-thread `solve_instance`
// (fused_sqp.cuh).
//
// It computes what `solve_instance<Step>` computes, in the same iteration
// modes and branches.  What depends on the step is a group step policy
// (`GroupStep<S, Step>`, below): its width, its share of a stage's
// linearization, the products with A and B, the rollout's rows and a trial
// point's increment.  Four of them:
//
// * the arms under Euler (`FastNq<ArmModel>`, W = 4): the linearization is
//   folded (arm_dynamics.cuh `arm_*_column`): of the 3 NQ columns of d qdd
//   / d[q, qd, u], only the NQ q columns take a pass through the whole
//   chain; a qd column is the RNEA alone and a u column two triangular
//   solves.  Lane l takes the tasks l, l + 4, l + 8 of the list (q_0 ..
//   q_{NQ-1}, qd_0 .., u_0 ..).  Where NQ = 4 those are q_l, qd_l and u_l,
//   and one sweep of the chain carries both of the lane's tangents
//   (`arm_q_qd_columns`), so the lane forms the chain's values once; at
//   NQ = 2 lanes 2 and 3 form the value part and a qd column each.  The
//   structural zeros of A = [[I, dt I], [Jq, I + Jqd]] and B = [[0], [Ju]]
//   are skipped in the step's products (their zero terms add nothing, so
//   the sums are the one-thread body's); only the folded Jacobian rounds
//   differently.
// * the closed forms under Euler (`FastNq<Model>`, W = 2): the NQ
//   acceleration rows by one dual-number pass a tangent column, as
//   `acc_rows` forms them, the NZ columns split over the lanes (lane l
//   takes columns l, l + 2, ...); the products as for the arms.
// * any model under midpoint and RK4 (`Generic<Model>`; W = 4 for the arms,
//   2 for the closed forms): the NZ tangent columns of the increment's rows
//   [A - I | B] are split over the lanes (lane l takes columns l, l + W,
//   ...), one dual-number pass through the step each, so a lane's
//   registers hold one pass as the one-thread body's do.  A stage's rows
//   and A = I + rows go to the tile, where the Riccati step reads them, and
//   the rows to global J as well, where the rollout reads them: the rollout
//   runs after the whole backward sweep, when the tile holds only stage 0,
//   and forming them again would cost the passes once more.
// * LTV (`Ltv<NX, NU>`; `LtvWidth`: W = 4 where NX is a multiple of 4 from
//   8 up, 2 otherwise): the affine step (Ad - I, Bd, cd) and A = I + (Ad -
//   I) go into the tile once a solve (lane l reads rows l, l + W, ... of
//   each, coalesced in the batch-innermost layout); no stage, rollout step
//   or rung reads them from global memory again.
//
// The block Riccati step is split over the lanes on a per-instance tile in
// shared memory (`GroupTile`): lane l owns the state rows and columns l, l
// + W, ... (`row`), the controls l, l + W, ... (where NU <= W one at most,
// and the code of the phases is the one-control code it always was: CPL,
// `GroupPhases`), and the right-hand-side columns l, l + W, ... of the
// gain solve.  Each sum keeps the one-thread body's order, so with a dense
// A the step is the one-thread body's to the last bit.  The line-search
// rungs run in parallel: lane l evaluates rungs l, l + W, ... over all
// stages; the first passing rung in fan order wins.
//
// The body is a sequence of phases.  On the device the W lanes run a phase
// at once and meet at a `__syncwarp` of the group; on the host one thread
// runs the lanes of a phase one after another, over a local array that
// stands in for the shared tile.  So the g++ build runs the group body's
// own arithmetic.  What a lane keeps from one phase to the next lives in
// its `Own` slot; what all lanes need goes through the tile; code between
// phases is uniform (every lane computes the same from the same tile
// values), so the group leaves the adaptive loop together.  Lane 0 also
// keeps the merit's sums (cost, l1 defect, reference cost, directional
// derivative) in the one-thread body's order, whatever W: the Armijo test
// compares them with the rungs' sums, and float32 noise between the two
// decides whether a near-converged step passes.
#pragma once

#include "fused_sqp.cuh"

namespace mpc {

// The W lanes of one instance: `phase(f)` runs f(lane) for each lane and
// then a group barrier.  On the host one thread runs all W lanes, and each
// keeps its own state in slot l.
template <int W_>
struct Group {
  static constexpr int W = W_;
#if defined(__CUDA_ARCH__)
  static constexpr int kHostLanes = 1;   // each thread holds its own lane
#else
  static constexpr int kHostLanes = W;
#endif
  int lane;
  unsigned mask;
  template <typename F>
  MPC_HD void phase(const F& f) const {
#if defined(__CUDA_ARCH__)
    f(lane);
    __syncwarp(mask);
#else
    for (int l = 0; l < W; ++l) f(l);
#endif
  }
  // Index of lane l's private slot.
  MPC_HD static int slot(int l) {
#if defined(__CUDA_ARCH__)
    return 0;
#else
    return l;
#endif
  }
};

// The per-instance tile of a group of W lanes: the Riccati carries, the
// stage's NJ Jacobian rows and defect, the step's blocks and gains, the
// lanes' partial sums, and NE entries of the step policy's own.  The
// rollout's double-buffered dx/du and the rung results reuse the step's
// blocks, which are free then; at small shapes ((4, 1), (2, 1)) those
// blocks are too few, and the tile grows by what they lack.
template <int NX, int NU, int NJ, int NE, int W>
struct GroupTile {
  static constexpr int NZ = NX + NU, NR = NZ + 1, kRedN = 8;
  static constexpr int kPxx = 0, kPxv = kPxx + NX * NX,
                       kPvv = kPxv + NX * NU, kpx = kPvv + NU * NU,
                       kpv = kpx + NX, kJr = kpv + NU, kck = kJr + NJ * NZ,
                       kQxx = kck + NX, kQxu = kQxx + NX * NX,
                       kQuu = kQxu + NX * NU, kqu = kQuu + NU * NU,
                       kY = kqu + NU, kBlocksEnd = kY + NU * NR;
  static constexpr int kDx = kQxx, kDu = kDx + 2 * NX, kFan = kDu + 2 * NU,
                       kFanEnd = kFan + 3 * kMaxFan;
  static constexpr int kRed = kFanEnd > kBlocksEnd ? kFanEnd : kBlocksEnd,
                       kExt = kRed + W * kRedN, kEnd = kExt + NE;
  static_assert(kFanEnd <= kRed, "rollout / fan overflow");
  // Odd stride: the groups of a warp fall on different banks.
  static constexpr int kSize = kEnd | 1;
};

template <typename S, int NX, int NU, int NJ, int NE, int W>
struct TileView {
  typedef GroupTile<NX, NU, NJ, NE, W> G;
  S* t;
  MPC_HD S& Pxx(int i, int j) const { return t[G::kPxx + i * NX + j]; }
  MPC_HD S& Pxv(int i, int l) const { return t[G::kPxv + i * NU + l]; }
  MPC_HD S& Pvv(int l, int m) const { return t[G::kPvv + l * NU + m]; }
  MPC_HD S& px(int i) const { return t[G::kpx + i]; }
  MPC_HD S& pv(int l) const { return t[G::kpv + l]; }
  MPC_HD S& Jr(int s, int c) const { return t[G::kJr + s * G::NZ + c]; }
  MPC_HD S& ck(int i) const { return t[G::kck + i]; }
  MPC_HD S& Qxx(int i, int j) const { return t[G::kQxx + i * NX + j]; }
  MPC_HD S& Qxu(int i, int l) const { return t[G::kQxu + i * NU + l]; }
  MPC_HD S& Quu(int l, int m) const { return t[G::kQuu + l * NU + m]; }
  MPC_HD S& qu(int l) const { return t[G::kqu + l]; }
  MPC_HD S& Y(int l, int c) const { return t[G::kY + l * G::NR + c]; }
  MPC_HD S& red(int lane, int v) const {
    return t[G::kRed + lane * G::kRedN + v];
  }
  MPC_HD S& dx(int buf, int i) const { return t[G::kDx + buf * NX + i]; }
  MPC_HD S& du(int buf, int l) const { return t[G::kDu + buf * NU + l]; }
  MPC_HD S& fan(int j, int v) const { return t[G::kFan + j * 3 + v]; }
  MPC_HD S& ext(int e) const { return t[G::kExt + e]; }
};

// ---- group step policies.  `GroupStep<S, Step>` is built from the step
// policy, the arguments and the instance, and gives the body:
//   W, NX, NU, Tile, View       the group's width, sizes and the tile's
//                               layout;
//   setup(l, T)                 lane l's share of what the tile holds for
//                               the whole solve;
//   linearize(l, k, xl, ul, T, Js, f)
//                               lane l's share of stage k's Jacobian rows
//                               into the tile (and Js where the rollout
//                               reads them), and in f, every row, what
//                               `inc` makes the increment F(x, u) - x at
//                               (xl, ul) of;
//   inc(fi)                     the increment from f's row: dt fi under
//                               Euler, fi itself otherwise; formed where it
//                               is used, so that a row picked at run time
//                               rounds as in the one-thread body (dt fi
//                               fused into the defect's add);
//   At(T, c, v), Bt(T, l, v)    sum_t A[t][c] v(t) and sum_t B[t][l] v(t)
//                               in the one-thread body's order;
//   next_row(T, k, i, dx, du, Js, cks)
//                               row i of the rollout's dx_{k+1} from dx_k
//                               and du_k (functions of the index), as the
//                               policy's `next_dx` forms it;
//   value(T, xt, ut, vt)        the increment at a line-search trial point.
template <typename S, typename Step> struct GroupStep;

// Which step policies the card runs on the group body (the others on the
// one-thread body), by the in-turn timing of the two bodies on the H100
// (tools/time_fused_modes.py, fixed-3 warm at B=16384, PERF.md §6):
// - four lanes: the serial arms under every integrator; LTV where NX is a
//   multiple of 4 from 8 up (`GroupBody<Ltv>`, below the LTV step);
// - two lanes: the generic path (midpoint and RK4) of the double
//   pendulum, the acrobot and the cart-pole, whose tangent passes through
//   the integrator's stages split over the lanes (1.08-1.26x), and the
//   double pendulum under Euler (1.06x);
// - one thread: where two lanes lost, the small shapes whose linearization
//   is too cheap to pay for the lanes' barriers, the tile's round trips and
//   the work every lane repeats: the pendulum under every integrator, the
//   cart-pole and the acrobot under Euler, and LTV at (4, 2), (4, 1) and
//   (2, 1) (0.50-0.96x).
// A generated step (models/codegen.py) takes the rule of its policy: a
// generated model under midpoint and RK4 (and a first-order one under
// Euler) the generic path's two lanes where its shape splits over them
// (NX even, NU <= 2), one thread otherwise; a generated model's nq-row
// policy one thread; an LTV shape the LTV rule.  At small batch a
// generated model runs the block body where its shape splits over two
// lanes (fused_sqp_block.cuh `BlockBody`).
template <typename Step> struct GroupBody {
  static constexpr bool value = false;
};
template <typename S, int NQ> struct GroupBody<FastNq<S, ArmModel<S, NQ>>> {
  static constexpr bool value = true;
};
// The generic policy's width: four lanes for the serial arms (12 tangent
// columns under the 4-DOF arm, 3 a lane), two for the closed forms (at
// most 6 columns, nx <= 4).
template <typename Model> struct GenericWidth {
  static constexpr int value = 2;
};
template <typename S, int NQ> struct GenericWidth<ArmModel<S, NQ>> {
  static constexpr int value = 4;
};

template <typename S, typename Model> struct GroupBody<Generic<S, Model>> {
  static constexpr int W = GenericWidth<Model>::value;
  static constexpr bool value = Model::NX % W == 0 && Model::NU <= W;
};
template <typename S> struct GroupBody<Generic<S, Pendulum<S>>> {
  static constexpr bool value = false;
};
template <typename S> struct GroupBody<FastNq<S, DoublePendulum<S>>> {
  static constexpr bool value = true;
};

// The Euler step of a second-order model (the nq-row policy): the tile
// holds the NQ dt-scaled acceleration rows in Jr; A = [[I, dt I], [Jq, I +
// Jqd]] and B = [[0], [Ju]] are used with their structural zeros skipped.
template <typename S, typename Model, int W_>
struct GroupNq {
  static constexpr int W = W_, NQ = Model::NQ, NX = Model::NX,
                       NU = Model::NU, NZ = NX + NU;
  typedef GroupTile<NX, NU, NQ, 0, W> Tile;
  typedef TileView<S, NX, NU, NQ, 0, W> View;
  const Model& m;
  S dt;
  MPC_HD void setup(int, const View&) const {}
  MPC_HD S inc(S fi) const { return dt * fi; }
  // The one-thread body's dense sum in its order, the zeros of the top
  // rows skipped, so the same value.
  template <typename V>
  MPC_HD S At(const View& T, int c, const V& v) const {
    S acc = c < NQ ? v(c) : v(c - NQ) * dt;
    for (int s = 0; s < NQ; ++s)
      acc = acc + (S(NQ + s == c ? 1 : 0) + T.Jr(s, c)) * v(NQ + s);
    return acc;
  }
  template <typename V>
  MPC_HD S Bt(const View& T, int l, const V& v) const {
    S acc = T.Jr(0, NX + l) * v(NQ);
    for (int s = 1; s < NQ; ++s) acc = acc + T.Jr(s, NX + l) * v(NQ + s);
    return acc;
  }
  template <typename DX, typename DU>
  MPC_HD S next_row(const View&, int k, int i, const DX& dx, const DU& du,
                    const Lane<S>& Js, const Lane<S>& cks) const {
    if (i < NQ) return (dx(i) + dt * dx(NQ + i)) + cks[k * NX + i];
    const int base = (k * NQ + i - NQ) * NZ;
    S acc = Js[base] * dx(0);
    for (int j = 1; j < NX; ++j) acc = acc + Js[base + j] * dx(j);
    for (int j = 0; j < NU; ++j) acc = acc + Js[base + NX + j] * du(j);
    return (dx(i) + acc) + cks[k * NX + i];
  }
  MPC_HD void value(const View&, const S* xt, const S* ut, S* vt) const {
    S fv[NX];
    model_f(m, xt, ut, fv);
    for (int i = 0; i < NX; ++i) vt[i] = fv[i] * dt;
  }
};

// The arms under Euler: the folded linearization, four lanes.
template <typename S, int NQ_>
struct GroupStep<S, FastNq<S, ArmModel<S, NQ_>>>
    : GroupNq<S, ArmModel<S, NQ_>, 4> {
  typedef GroupNq<S, ArmModel<S, NQ_>, 4> D;
  using D::W; using D::NQ; using D::NX; using D::NZ;
  typedef typename D::View View;
  MPC_HD GroupStep(const FastNq<S, ArmModel<S, NQ>>& s, const FusedArgs<S>& a,
                   long long)
      : D{s.m, a.dt} {}
  MPC_HD void linearize(int l, int k, const S* xl, const S* ul,
                        const View& T, const Lane<S>& Js, S* f) const {
    S L[NQ][NQ], qdd[NQ], col[NQ];
    auto put = [&](int c, const S* v) {
      for (int i = 0; i < NQ; ++i) {
        const S vi = this->dt * v[i];
        T.Jr(i, c) = vi;
        Js[(k * NQ + i) * NZ + c] = vi;
      }
    };
    if constexpr (NQ == W) {
      // Lane l's tasks are q_l, qd_l and u_l: one sweep forms the values
      // and both tangents.
      S col_qd[NQ];
      arm_q_qd_columns(this->m.c, xl, xl + NQ, ul, l, L, qdd, col, col_qd);
      put(l, col);
      put(NQ + l, col_qd);
      arm_u_column(L, l, col);
      put(NX + l, col);
    } else {
      if (l < NQ) {
        arm_q_column(this->m.c, xl, xl + NQ, ul, l, L, qdd, col);
        put(l, col);
      } else {
        arm_value(this->m.c, xl, xl + NQ, ul, L, qdd);
      }
#pragma unroll 1
      for (int t = l < NQ ? l + W : l; t < 3 * NQ; t += W) {
        if (t < 2 * NQ) {
          arm_qd_column(this->m.c, xl, xl + NQ, t - NQ, L, col);
        } else {
          arm_u_column(L, t - 2 * NQ, col);
        }
        put(t < 2 * NQ ? t : NX + (t - 2 * NQ), col);
      }
    }
    for (int i = 0; i < NX; ++i) f[i] = i < NQ ? xl[NQ + i] : qdd[i - NQ];
  }
};

// The closed forms under Euler: the acceleration rows by dual numbers, one
// pass a tangent column (`acc_rows`'s passes), the columns split over two
// lanes; every pass also gives the accelerations (the same in each).
template <typename S, typename Model>
struct GroupStep<S, FastNq<S, Model>> : GroupNq<S, Model, 2> {
  typedef GroupNq<S, Model, 2> D;
  using D::W; using D::NQ; using D::NX; using D::NU; using D::NZ;
  typedef typename D::View View;
  static_assert(NZ >= W, "every lane takes a column");
  MPC_HD GroupStep(const FastNq<S, Model>& s, const FusedArgs<S>& a,
                   long long)
      : D{s.m, a.dt} {}
  MPC_HD void linearize(int l, int k, const S* xl, const S* ul,
                        const View& T, const Lane<S>& Js, S* f) const {
    typedef Dual<S, 1> Dd;
#pragma unroll 1
    for (int d = l; d < NZ; d += W) {
      Dd xd[NX], ud[NU], qdd[NQ];
      seed<S, 1, NX, NU>(xl, ul, d, xd, ud);
      this->m.acc(xd, ud, qdd);
      for (int i = 0; i < NQ; ++i) {
        const S v = this->dt * qdd[i].d[0];
        f[NQ + i] = qdd[i].v;
        T.Jr(i, d) = v;
        Js[(k * NQ + i) * NZ + d] = v;
      }
    }
    for (int i = 0; i < NQ; ++i) f[i] = xl[NQ + i];
  }
};

// A dense step: the tile holds all NX rows [A - I | B] in Jr and A = I +
// rows at the start of the policy's entries (then NE more of its own).
template <typename S, int NX_, int NU_, int NE, int W_>
struct GroupDense {
  static constexpr int W = W_, NX = NX_, NU = NU_, NZ = NX + NU;
  typedef GroupTile<NX, NU, NX, NX * NX + NE, W> Tile;
  typedef TileView<S, NX, NU, NX, NX * NX + NE, W> View;
  MPC_HD static S& A(const View& T, int t, int c) { return T.ext(t * NX + c); }
  MPC_HD S inc(S fi) const { return fi; }
  template <typename V>
  MPC_HD S At(const View& T, int c, const V& v) const {
    S acc = A(T, 0, c) * v(0);
    for (int t = 1; t < NX; ++t) acc = acc + A(T, t, c) * v(t);
    return acc;
  }
  template <typename V>
  MPC_HD S Bt(const View& T, int l, const V& v) const {
    S acc = T.Jr(0, NX + l) * v(0);
    for (int t = 1; t < NX; ++t) acc = acc + T.Jr(t, NX + l) * v(t);
    return acc;
  }
};

// Any integrator but Euler: the increment's rows by dual numbers, the
// tangent columns split over the lanes.
template <typename S, typename Model>
struct GroupStep<S, Generic<S, Model>>
    : GroupDense<S, Model::NX, Model::NU, 0, GenericWidth<Model>::value> {
  typedef GroupDense<S, Model::NX, Model::NU, 0, GenericWidth<Model>::value>
      D;
  using D::W; using D::NX; using D::NU; using D::NZ;
  typedef typename D::View View;
  const Generic<S, Model>& st;
  S dt;
  MPC_HD GroupStep(const Generic<S, Model>& s, const FusedArgs<S>& a,
                   long long)
      : st(s), dt(a.dt) {}
  MPC_HD void setup(int, const View&) const {}
  // Column d of the rows from one dual pass seeded in direction d; every
  // pass also gives the increment's value (the same in each).  A lane with
  // no column (NZ < W) forms the value alone.
  MPC_HD void linearize(int l, int k, const S* xl, const S* ul,
                        const View& T, const Lane<S>& Js, S* f) const {
    typedef Dual<S, 1> Dd;
#pragma unroll 1
    for (int d = l; d < NZ; d += W) {
      Dd xd[NX], ud[NU], out[NX];
      seed<S, 1, NX, NU>(xl, ul, d, xd, ud);
      model_increment(st.m, st.integ, dt, xd, ud, out);
      for (int i = 0; i < NX; ++i) {
        const S v = out[i].d[0];
        f[i] = out[i].v;
        T.Jr(i, d) = v;
        Js[(k * NX + i) * NZ + d] = v;
        if (d < NX) D::A(T, i, d) = S(i == d ? 1 : 0) + v;
      }
    }
    if (l >= NZ) model_increment(st.m, st.integ, dt, xl, ul, f);
  }
  template <typename DX, typename DU>
  MPC_HD S next_row(const View&, int k, int i, const DX& dx, const DU& du,
                    const Lane<S>& Js, const Lane<S>& cks) const {
    const int base = (k * NX + i) * NZ;
    S acc = Js[base] * dx(0);
    for (int j = 1; j < NX; ++j) acc = acc + Js[base + j] * dx(j);
    for (int j = 0; j < NU; ++j) acc = acc + Js[base + NX + j] * du(j);
    return (dx(i) + acc) + cks[k * NX + i];
  }
  MPC_HD void value(const View&, const S* xt, const S* ut, S* vt) const {
    model_increment(st.m, st.integ, dt, xt, ut, vt);
  }
};

// The LTV step's width: four lanes where NX is a multiple of 4 from 8 up
// ((8, 4), the generated (12, 6)), two otherwise.
template <int NX> struct LtvWidth {
  static constexpr int value = NX % 4 == 0 && NX >= 8 ? 4 : 2;
};

// LTV: (Ad - I | Bd) in Jr, A = I + (Ad - I) and cd in the policy's
// entries, loaded once a solve.
template <typename S, int NX_, int NU_>
struct GroupStep<S, Ltv<S, NX_, NU_>>
    : GroupDense<S, NX_, NU_, NX_, LtvWidth<NX_>::value> {
  typedef GroupDense<S, NX_, NU_, NX_, LtvWidth<NX_>::value> D;
  using D::W; using D::NX; using D::NU;
  typedef typename D::View View;
  typename Ltv<S, NX_, NU_>::Bound st;
  MPC_HD GroupStep(const Ltv<S, NX_, NU_>& s, const FusedArgs<S>& a,
                   long long b)
      : st(s.bind(a, b)) {}
  MPC_HD static S& cd(const View& T, int i) { return T.ext(NX * NX + i); }
  MPC_HD void setup(int l, const View& T) const {
    for (int i = l; i < NX; i += W) {
      for (int j = 0; j < NX; ++j) {
        const S v = st.AdI[i * NX + j];
        T.Jr(i, j) = v;
        D::A(T, i, j) = S(i == j ? 1 : 0) + v;
      }
      for (int j = 0; j < NU; ++j) T.Jr(i, NX + j) = st.Bd[i * NU + j];
      cd(T, i) = st.cd[i];
    }
  }
  // Row i of (Ad - I) x + Bd u, each dot product left to right.
  MPC_HD static S row(const View& T, const S* x, const S* u, int i) {
    S ax = T.Jr(i, 0) * x[0];
    for (int j = 1; j < NX; ++j) ax = ax + T.Jr(i, j) * x[j];
    S bu = T.Jr(i, NX) * u[0];
    for (int j = 1; j < NU; ++j) bu = bu + T.Jr(i, NX + j) * u[j];
    return ax + bu;
  }
  MPC_HD void linearize(int, int, const S* xl, const S* ul, const View& T,
                        const Lane<S>&, S* f) const {
    for (int i = 0; i < NX; ++i) f[i] = row(T, xl, ul, i) + cd(T, i);
  }
  template <typename DX, typename DU>
  MPC_HD S next_row(const View& T, int k, int i, const DX& dx, const DU& du,
                    const Lane<S>&, const Lane<S>& cks) const {
    S ax = T.Jr(i, 0) * dx(0);
    for (int j = 1; j < NX; ++j) ax = ax + T.Jr(i, j) * dx(j);
    S bu = T.Jr(i, NX) * du(0);
    for (int j = 1; j < NU; ++j) bu = bu + T.Jr(i, NX + j) * du(j);
    return (dx(i) + (ax + bu)) + cks[k * NX + i];
  }
  MPC_HD void value(const View& T, const S* xt, const S* ut, S* vt) const {
    for (int i = 0; i < NX; ++i) vt[i] = row(T, xt, ut, i) + cd(T, i);
  }
};

// Threads of a block of the group kernel (fused_sqp_launch.cuh), and the
// shared memory one block may take on the H100 (227 KB).
constexpr int kGroupThreads = 128;
constexpr long long kBlockSmemMax = 227 * 1024;

// Where the card runs LTV on the group body: on four lanes (NX a multiple
// of 4 from 8 up: (8, 4), the generated (12, 6)) where a block's 32 tiles
// fit in its shared memory.  Lane l owns controls l, l + W, ..., so NU may
// exceed W.  Timed against the one-thread body in turns on the H100
// (tools/time_fused_modes.py, fixed-3 warm at B=16384, PERF.md §6): (12, 6)
// 11.38 ms on four lanes against 22.80 on one thread (which spills 8172
// B); two lanes lost everywhere they were timed, so every other shape runs
// one thread: (6, 3) 2.33 ms on two lanes against 1.81-1.85 (the lanes at
// 168 registers spill 160 B), and (4, 2), (4, 1), (2, 1) (timed before).
template <typename S, int NX, int NU> struct GroupBody<Ltv<S, NX, NU>> {
  typedef GroupStep<float, Ltv<float, NX, NU>> GS;
  static constexpr bool value =
      GS::W == 4 &&
      (long long)sizeof(float) * GS::Tile::kSize * (kGroupThreads / GS::W) <=
          kBlockSmemMax;
};

// Each shape's tile, in floats, and whether it grew past the step's
// blocks: the four-lane shapes keep the layout they had before the width
// was a parameter; at nx + nu = 5 and 3 the blocks are too few for the
// rollout's dx / du buffers and the 8 rungs' results, and the tile grows by
// what they lack.
template <typename Step, int kFloats, bool kGrown>
constexpr bool kTileIs =
    GroupStep<float, Step>::Tile::kSize == kFloats &&
    (GroupStep<float, Step>::Tile::kRed >
     GroupStep<float, Step>::Tile::kBlocksEnd) == kGrown;
static_assert(kTileIs<FastNq<float, ArmModel<float, 4>>, 381, false> &&
              kTileIs<FastNq<float, ArmModel<float, 2>>, 127, false> &&
              kTileIs<Generic<float, ArmModel<float, 4>>, 493, false> &&
              kTileIs<Generic<float, ArmModel<float, 2>>, 155, false> &&
              kTileIs<Ltv<float, 8, 4>, 501, false>,
              "four lanes: the layout of the fixed width");
static_assert(kTileIs<Ltv<float, 4, 2>, 143, false> &&
              kTileIs<FastNq<float, DoublePendulum<float>>, 111, false> &&
              kTileIs<Generic<float, DoublePendulum<float>>, 139, false>,
              "two lanes at (4, 2): the step's blocks suffice");
static_assert(kTileIs<Ltv<float, 4, 1>, 121, true> &&
              kTileIs<FastNq<float, Acrobot<float>>, 91, true> &&
              kTileIs<FastNq<float, Cartpole<float>>, 91, true> &&
              kTileIs<Generic<float, Acrobot<float>>, 117, true> &&
              kTileIs<Generic<float, Cartpole<float>>, 117, true>,
              "two lanes at (4, 1): grown");
static_assert(kTileIs<Ltv<float, 2, 1>, 71, true> &&
              kTileIs<FastNq<float, Pendulum<float>>, 61, true> &&
              kTileIs<Generic<float, Pendulum<float>>, 69, true>,
              "two lanes at (2, 1): grown");

// Whether a policy's shape splits over its group (`solve_group`'s rule):
// the host builds run the group body of the policies where it does.
template <typename S, typename Step>
constexpr bool group_fits() {
  typedef GroupStep<S, Step> GS;
  return GS::NX % GS::W == 0 && kMaxFan % GS::W == 0;
}

// The group body's phases: the terminal cost-to-go, the Riccati step's
// phases (B), (C), (D), the rollout's two phases a stage, a line-search
// rung's stage terms and its terminal test.  Each is lane l's share of one
// phase of `solve_group`, the same arithmetic in the same order; the
// caller runs it under its group's `phase`.  The block body
// (fused_sqp_block.cuh) runs them on the instance it holds in shared
// memory; `solve_group` runs them where a lane owns more than one control
// (CPL > 1) and keeps its own inline copy otherwise: calling these moved
// nvcc's code for it and cost its kernel 1.0 % (the Euler arm) and 1.8 %
// (Ltv<8, 4>) at B=16384 on the H100 (tools/time_fused_modes.py in turns,
// PERF.md §6), so tests/test_torch_fused_block.py holds the two bodies to
// the same bits instead.  Lane l owns controls l, l + W, ... (CPL of them
// at most) and loops over them; where NU <= W the loop takes one trip or
// none, the sums in the order of the one-control code it replaced.  `Lane`
// views (L, CL, WL) may lie in global memory, batch-innermost, or in shared
// memory with stride 1.
template <typename S, typename GS>
struct GroupPhases {
  static constexpr int W = GS::W, NX = GS::NX, NU = GS::NU, NZ = NX + NU,
                       NG = NX + 2 * NU, NR = NZ + 1, RPL = NX / W,
                       CPL = (NU + W - 1) / W, kRungs = kMaxFan / W;
  typedef typename GS::View View;
  // State row r of lane l: l, l + W, ... (each lane one position and one
  // velocity row when NX = 2 W); control cc of lane l the same, l + W cc.
  MPC_HD static int row(int l, int rr) { return l + W * rr; }

  // What a lane keeps between phases: its rows' and controls' stage terms,
  // its partial sums, and its rungs' accumulators.
  struct Own {
    S gzx[RPL], Dx[RPL], qz[RPL];
    S gzv[CPL], gu[CPL], Du[CPL], qu[CPL];
    S cost, jref, cl1, feas, pmax, ddir, amax, stepn;   // cost..ddir: lane 0
    S cost_t[kRungs], cl1_t[kRungs], jref_t[kRungs];
  };

  // Stage cost of a point (solve_instance's `stage_cost`).
  template <typename P>
  MPC_HD static S stage_cost(const P& p, const S* xl, const S* ul,
                             const S* du, const S* e, bool tk, S mu,
                             S& rate_mag) {
    S c = S(0);
    for (int i = 0; i < NX; ++i) c = c + (tk ? p.q[i] * (e[i] * e[i]) : S(0));
    rate_mag = S(0);
    for (int k = 0; k < NU; ++k) {
      rate_mag = rate_mag + p.r[k] * (du[k] * du[k]);
      rate_mag = rate_mag + p.rm[k] * (ul[k] * ul[k]);
    }
    const S bx = bar_value(xl, p.xmin, p.xmax, NX, mu);
    c = c + (tk ? bx : S(0));
    c = c + bar_value(ul, p.umin, p.umax, NU, mu);
    return c + rate_mag;
  }

  // Terminal cost-to-go: lane l's rows of Pxx, Pxv, px and its controls'
  // Pvv rows and pv.
  template <typename P, typename L, typename WL>
  MPC_HD static void terminal(const View& T, int l, Own& o, const P& p,
                              const L& X, const WL& Gs, int N, S mu) {
    for (int rr = 0; rr < RPL; ++rr) {
      const int i = row(l, rr);
      const S xN = X[N * NX + i];
      const S eN = xN - p.xdes[(N - 1) * NX + i], eF = xN - p.xfdes[i];
      S gg, h;
      bar_terms(xN, p.xmin[i], p.xmax[i], mu, gg, h);
      for (int j = 0; j < NX; ++j) T.Pxx(i, j) = S(0);
      T.Pxx(i, i) = (S(2) * p.q[i] + S(2) * p.qf[i]) + h;
      const S pxi = (S(2) * p.q[i] * eN + S(2) * p.qf[i] * eF) + gg;
      T.px(i) = pxi;
      Gs[N * NG + i] = pxi;
      for (int k = 0; k < NU; ++k) T.Pxv(i, k) = S(0);
      o.pmax = nmax(o.pmax, m_abs(pxi));
    }
    for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc) {
      const int c = row(l, cc);
      T.pv(c) = S(0);
      for (int k = 0; k < NU; ++k) T.Pvv(c, k) = S(0);
      Gs[N * NG + NX + c] = S(0);
      Gs[N * NG + NX + NU + c] = S(0);
    }
  }

  // The terminal merit terms (cost, reference cost) at xN, in order.
  template <typename P>
  MPC_HD static void terminal_merit(const P& p, const S* xN, int N, S mu,
                                    S& cost, S& jref) {
    cost = bar_value(xN, p.xmin, p.xmax, NX, mu);
    for (int i = 0; i < NX; ++i) {
      const S eN = xN[i] - p.xdes[(N - 1) * NX + i], eF = xN[i] - p.xfdes[i];
      cost = cost + p.q[i] * (eN * eN);
      cost = cost + p.qf[i] * (eF * eF);
    }
    jref = S(0);
    for (int i = 0; i < NX; ++i) {
      const S eF = xN[i] - p.xfdes[i];
      jref = jref + p.qf[i] * (eF * eF);
    }
  }

  // ---- (B) the step's blocks: the upper triangle of Qxx in columns, Qxu
  // and Quu columns, qz_x and qu
  MPC_HD static void blocks(const GS& gs, const View& T, int l, Own& o) {
    S Prp[NX];                                 // px + Pxx ck
    for (int i = 0; i < NX; ++i) {
      S acc = T.Pxx(i, 0) * T.ck(0);
      for (int t = 1; t < NX; ++t) acc = acc + T.Pxx(i, t) * T.ck(t);
      Prp[i] = T.px(i) + acc;
    }
    for (int rr = 0; rr < RPL; ++rr) {
      const int j = row(l, rr);
      S v[NX];                                 // (Pxx A)[:, j]
      for (int i = 0; i < NX; ++i)
        v[i] = gs.At(T, j, [&](int t) { return T.Pxx(i, t); });
      for (int i = 0; i <= j; ++i) {           // (A' Pxx A)[i <= j, j]
        const S acc = gs.At(T, i, [&](int t) { return v[t]; });
        T.Qxx(i, j) = i == j ? acc + o.Dx[rr] : acc;
      }
      o.qz[rr] = o.gzx[rr] + gs.At(T, j, [&](int t) { return Prp[t]; });
    }
    for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc) {
      const int c = row(l, cc);
      S pb[NX], m1[NX];                        // Pxx B[:, c], + Pxv
      for (int i = 0; i < NX; ++i) {
        pb[i] = gs.Bt(T, c, [&](int t) { return T.Pxx(i, t); });
        m1[i] = pb[i] + T.Pxv(i, c);
      }
      for (int i = 0; i < NX; ++i)             // Qxu[:, c] = A' m1
        T.Qxu(i, c) = gs.At(T, i, [&](int t) { return m1[t]; });
      for (int mm = 0; mm < NU; ++mm) {        // Quu[:, c]
        const S bpb = gs.Bt(T, mm, [&](int t) { return pb[t]; });
        const S bpv = gs.Bt(T, mm, [&](int t) { return T.Pxv(t, c); });
        const S bpv_t = gs.Bt(T, c, [&](int t) { return T.Pxv(t, mm); });
        const S quu = (bpb + (bpv + bpv_t)) + T.Pvv(mm, c);
        T.Quu(mm, c) = mm == c ? quu + o.Du[cc] : quu;
      }
      S pv_acc = T.Pxv(0, c) * T.ck(0);        // pv + Pxv' ck
      for (int t = 1; t < NX; ++t) pv_acc = pv_acc + T.Pxv(t, c) * T.ck(t);
      const S prp_v = T.pv(c) + pv_acc;
      const S bp = gs.Bt(T, c, [&](int t) { return Prp[t]; });
      o.qu[cc] = o.gu[cc] + (bp + prp_v);
      T.qu(c) = o.qu[cc];
    }
  }

  // ---- (C) Cholesky of Quu (every lane; ops/elem.py chol order) and the
  // solves of the right-hand-side columns [ -Qxu' | 2R | -qu ]
  template <typename CL, typename WL>
  MPC_HD static void gains(const View& T, int l, const CL& r, const WL& Ks,
                           const WL& kffs, int k, bool pinned) {
    S Lc[NU][NU], Linv[NU];
    for (int j = 0; j < NU; ++j) {
      S s = T.Quu(j, j);
      for (int t = 0; t < j; ++t) s = s - Lc[j][t] * Lc[j][t];
      const S d = m_sqrt(s);
      Lc[j][j] = d;
      Linv[j] = S(1) / d;
      for (int i = j + 1; i < NU; ++i) {
        S t2 = T.Quu(i, j);
        for (int t = 0; t < j; ++t) t2 = t2 - Lc[i][t] * Lc[j][t];
        Lc[i][j] = t2 * Linv[j];
      }
    }
#pragma unroll 1
    for (int c = l; c < NR; c += W) {
      S y[NU];
      for (int mm = 0; mm < NU; ++mm)
        y[mm] = c < NX ? -T.Qxu(c, mm)
                : c < NZ ? (mm == c - NX ? S(2) * r[mm] : S(0))
                         : -T.qu(mm);
      for (int i = 0; i < NU; ++i) {           // L y = rhs
        for (int t = 0; t < i; ++t) y[i] = y[i] - Lc[i][t] * y[t];
        y[i] = y[i] * Linv[i];
      }
      for (int i = NU - 1; i >= 0; --i) {      // L' x = y
        for (int t = i + 1; t < NU; ++t) y[i] = y[i] - Lc[t][i] * y[t];
        y[i] = y[i] * Linv[i];
      }
      for (int mm = 0; mm < NU; ++mm) {
        const S v = pinned ? S(0) : y[mm];
        T.Y(mm, c) = v;
        if (c < NZ) Ks[(k * NU + mm) * NZ + c] = v;
        else kffs[k * NU + mm] = v;
      }
    }
  }

  // ---- (D) the new carries: Pxx = sym(Qxx + Qxu Kx) in columns (both of
  // its terms (i, j) and (j, i) here), or Qxx where the head is pinned;
  // Pxv, Pvv columns; px, pv
  template <typename CL>
  MPC_HD static void carries(const View& T, int l, Own& o, const CL& r,
                             bool pinned) {
    auto qkx = [&](int i, int j) {             // (Qxu Kx)[i][j]
      S acc = T.Qxu(i, 0) * T.Y(0, j);
      for (int t = 1; t < NU; ++t) acc = acc + T.Qxu(i, t) * T.Y(t, j);
      return acc;
    };
    for (int rr = 0; rr < RPL; ++rr) {
      const int j = row(l, rr);
      for (int i = 0; i < NX; ++i) {
        const S qxx = i <= j ? T.Qxx(i, j) : T.Qxx(j, i);
        T.Pxx(i, j) = pinned ? qxx
            : S(0.5) * ((qxx + qkx(i, j)) + (qxx + qkx(j, i)));
      }
      S pxj = o.qz[rr];
      if (!pinned) {
        S acc = T.Qxu(j, 0) * T.Y(0, NZ);
        for (int t = 1; t < NU; ++t) acc = acc + T.Qxu(j, t) * T.Y(t, NZ);
        pxj = pxj + acc;
      }
      T.px(j) = pxj;
      o.pmax = nmax(o.pmax, m_abs(pxj));
    }
    for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc) {
      const int c = row(l, cc);
      const S r2l = S(2) * r[c];
      S pvl = o.gzv[cc];
      if (pinned) {
        for (int i = 0; i < NX; ++i) T.Pxv(i, c) = S(0);
        for (int mm = 0; mm < NU; ++mm)
          T.Pvv(mm, c) = mm == c ? r2l : S(0);
      } else {
        for (int i = 0; i < NX; ++i) {
          S acc = T.Qxu(i, 0) * T.Y(0, NX + c);
          for (int t = 1; t < NU; ++t)
            acc = acc + T.Qxu(i, t) * T.Y(t, NX + c);
          T.Pxv(i, c) = S(0.5) * (acc + -(r2l * T.Y(c, i)));
        }
        for (int mm = 0; mm < NU; ++mm) {
          const S pvv = S(-0.5) * (S(2) * r[mm] * T.Y(mm, NX + c)
                                   + r2l * T.Y(c, NX + mm));
          T.Pvv(mm, c) = mm == c ? pvv + r2l : pvv;
        }
        pvl = pvl - r2l * T.Y(c, NZ);
      }
      T.pv(c) = pvl;
      o.pmax = nmax(o.pmax, m_abs(pvl));
    }
  }

  // ---- the rollout's first phase of stage k: du_k of lane l's controls
  // into the other buffer
  template <typename WL>
  MPC_HD static void rollout_du(const View& T, int l, int k, const WL& Ks,
                                const WL& kffs) {
    const int cur = k & 1, nxt = cur ^ 1;
    for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc) {
      const int c = row(l, cc), base = (k * NU + c) * NZ;
      S acc = Ks[base] * T.dx(cur, 0);
      for (int j = 1; j < NX; ++j) acc = acc + Ks[base + j] * T.dx(cur, j);
      for (int j = 0; j < NU; ++j)
        acc = acc + Ks[base + NX + j] * T.du(cur, j);
      T.du(nxt, c) = acc + kffs[k * NU + c];
    }
  }

  // ---- its second: lane 0's directional derivative (in order), lane l's
  // rows of dx_{k+1}, its fraction-to-boundary cap and step norm over its
  // rows and controls
  template <typename P, typename L, typename WL>
  MPC_HD static void rollout_dx(const GS& gs, const View& T, int l, int k,
                                Own& o, const P& p, const L& X, const L& U,
                                const WL& Gs, const WL& Js, const WL& cks,
                                const WL& dXs, const WL& dUs) {
    const int cur = k & 1, nxt = cur ^ 1;
    if (l == 0) {
      for (int i = 0; i < NX; ++i)
        o.ddir = o.ddir + Gs[k * NG + i] * T.dx(cur, i);
      for (int j = 0; j < NU; ++j) {
        o.ddir = o.ddir + Gs[k * NG + NX + j] * T.du(cur, j);
        o.ddir = o.ddir + Gs[k * NG + NX + NU + j] * T.du(nxt, j);
      }
    }
    for (int rr = 0; rr < RPL; ++rr) {
      const int i = row(l, rr);
      const S dxn = gs.next_row(
          T, k, i, [&](int j) { return T.dx(cur, j); },
          [&](int j) { return T.du(nxt, j); }, Js, cks);
      T.dx(nxt, i) = dxn;
      dXs[(k + 1) * NX + i] = dxn;
      o.amax = ftb(X[(k + 1) * NX + i], dxn, p.xmin[i], p.xmax[i], o.amax);
      o.stepn = nmax(o.stepn, m_abs(dxn));
    }
    for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc) {
      const int c = row(l, cc);
      const S dul = T.du(nxt, c);
      o.amax = ftb(U[k * NU + c], dul, p.umin[c], p.umax[c], o.amax);
      o.stepn = nmax(o.stepn, m_abs(dul));
      dUs[k * NU + c] = dul;
    }
  }

  // A rung's terms at stage k, step aj: its stage cost (returned), its
  // reference cost `jr`, and each state row's |defect| in `ad`.  xl, ul,
  // xn1: x_k, u_k, x_{k+1}; dxk, duk, dxk1: their steps; ukm1, dukm1: u_{k-1}
  // and its step.
  template <typename P>
  MPC_HD static S rung_terms(const GS& gs, const View& T, const P& p, int k,
                             S aj, S mu, const S* xl, const S* ul,
                             const S* xn1, const S* dxk, const S* duk,
                             const S* dxk1, const S* ukm1, const S* dukm1,
                             S& jr, S* ad) {
    const bool tk = k >= 1;
    const int kp = k >= 1 ? k - 1 : 0;
    S xt[NX], ut[NU], dut[NU], et[NX], vt[NX];
    for (int i = 0; i < NX; ++i) {
      xt[i] = xl[i] + aj * dxk[i];
      et[i] = xt[i] - p.xdes[kp * NX + i];
    }
    for (int j = 0; j < NU; ++j) {
      ut[j] = ul[j] + aj * duk[j];
      dut[j] = ut[j] - (ukm1[j] + aj * dukm1[j]);
    }
    S rmag;
    const S sc = stage_cost(p, xt, ut, dut, et, tk, mu, rmag);
    gs.value(T, xt, ut, vt);
    jr = rmag;
    for (int i = 0; i < NX; ++i) {
      const S inc = vt[i];
      const S vi = xt[i] + inc;
      ad[i] = m_abs(((xl[i] - xn1[i]) + aj * (dxk[i] - dxk1[i])) + inc);
      const S er = vi - p.xdes[k * NX + i];
      jr = jr + p.q[i] * (er * er);
    }
    return sc;
  }

  // A rung's terminal terms at step aj from its sums, and the Armijo test:
  // whether it passes, and its reference cost in `jr`.
  template <typename P>
  MPC_HD static bool rung_test(const P& p, const S* xN, const S* dxN, int N,
                               S aj, S mu, S cost_t, S cl1_t, S jref_t,
                               S nu_pen, S m0, S ddir, S eps_m, S& jr) {
    S xt[NX];
    S ct = cost_t;
    jr = jref_t;
    for (int i = 0; i < NX; ++i) {
      xt[i] = xN[i] + aj * dxN[i];
      const S eN = xt[i] - p.xdes[(N - 1) * NX + i];
      const S eF = xt[i] - p.xfdes[i];
      ct = (ct + p.q[i] * eN * eN) + p.qf[i] * eF * eF;
      jr = jr + p.qf[i] * eF * eF;
    }
    ct = ct + bar_value(xt, p.xmin, p.xmax, NX, mu);
    const S mj = ct + nu_pen * cl1_t;
    return m_isfinite(mj)
        && mj <= (m0 + S(kArmijoSlope) * aj * ddir) + eps_m;
  }
};

// One instance's parameters, as `Lane` views.
template <typename L>
struct InstanceParams {
  L xdes, q, r, rm, uprev, umin, umax, xmin, xmax, qf, xfdes;
};

template <typename S, typename Step>
MPC_HD void solve_group(const FusedArgs<S>& a, const Step& step, long long b,
                        const Group<GroupStep<S, Step>::W>& g, S* tile) {
  typedef GroupStep<S, Step> GS;
  constexpr int W = GS::W, NX = GS::NX, NU = GS::NU, NZ = NX + NU,
                NG = NX + 2 * NU, NR = NZ + 1, RPL = NX / W,
                CPL = (NU + W - 1) / W, kRungs = kMaxFan / W;
  static_assert(NX % W == 0 && kMaxFan % W == 0, "group split");
  typedef Group<W> G;
  // Where a lane owns more than one control (CPL > 1) the phases that
  // depend on it are `GroupPhases`'; with one at most, the inline code
  // below (see GroupPhases).
  typedef GroupPhases<S, GS> Ph;
  const GS gs(step, a, b);
  const typename GS::View T{tile};
  const long long B = a.B;
  const int N = a.N;
  typedef Lane<const S> CL;
  typedef Lane<S> WL;
  const CL X0{a.X0 + b, B}, U0{a.U0 + b, B}, xdes{a.xdes + b, B};
  const CL q{a.q + b, B}, r{a.r + b, B}, rm{a.rm + b, B};
  const CL uprev{a.uprev + b, B}, umin{a.umin + b, B}, umax{a.umax + b, B};
  const CL xmin{a.xmin + b, B}, xmax{a.xmax + b, B};
  const CL qf{a.qf + b, B}, xfdes{a.xfdes + b, B};
  const WL X{a.X + b, B}, U{a.U + b, B}, stats{a.stats + b, B};
  const WL Ks{a.K + b, B}, kffs{a.kff + b, B}, dXs{a.dX + b, B};
  const WL dUs{a.dU + b, B}, Gs{a.G + b, B}, Js{a.J + b, B}, cks{a.ck + b, B};
  // State row r of lane l: l, l + W, ... (each lane one position and one
  // velocity row when NX = 2 W).
  auto row = [](int l, int rr) { return l + W * rr; };

  // What a lane keeps between phases: its rows' and control's stage terms,
  // its partial sums, and its rungs' accumulators.
  struct Own {
    S gzx[RPL], Dx[RPL], qz[RPL];
    S gzv, gu, Du, qu;
    S cost, jref, cl1, feas, pmax, ddir, amax, stepn;   // cost..ddir: lane 0
    S cost_t[kRungs], cl1_t[kRungs], jref_t[kRungs];
  };
  typedef std::conditional_t<CPL == 1, Own, typename Ph::Own> LaneOwn;
  LaneOwn own[G::kHostLanes];
  auto params = [&] {
    return InstanceParams<CL>{xdes, q,    r,    rm, uprev, umin,
                              umax, xmin, xmax, qf, xfdes};
  };

  // Stage cost of a trial point (solve_instance's `stage_cost`).
  auto stage_cost = [&](const S* xl, const S* ul, const S* du, const S* e,
                        bool tk, S mu, S& rate_mag) -> S {
    S c = S(0);
    for (int i = 0; i < NX; ++i) c = c + (tk ? q[i] * (e[i] * e[i]) : S(0));
    rate_mag = S(0);
    for (int k = 0; k < NU; ++k) {
      rate_mag = rate_mag + r[k] * (du[k] * du[k]);
      rate_mag = rate_mag + rm[k] * (ul[k] * ul[k]);
    }
    const S bx = bar_value(xl, xmin, xmax, NX, mu);
    c = c + (tk ? bx : S(0));
    c = c + bar_value(ul, umin, umax, NU, mu);
    return c + rate_mag;
  };
  auto load = [&](const auto& src, int base, int n, S* dst) {
    for (int i = 0; i < n; ++i) dst[i] = src[base + i];
  };
  // Max / min of the lanes' partials in the tile, in lane order.
  auto lanes_max = [&](int v) {
    S m = T.red(0, v);
    for (int l = 1; l < W; ++l) m = nmax(m, T.red(l, v));
    return m;
  };
  auto lanes_min = [&](int v) {
    S m = T.red(0, v);
    for (int l = 1; l < W; ++l) m = nmin(m, T.red(l, v));
    return m;
  };

  // ---- warm start into the working (output) buffers; what the tile holds
  // for the whole solve
  g.phase([&](int l) {
    for (int e = l; e < (N + 1) * NX; e += W) X[e] = X0[e];
    for (int e = l; e < N * NU; e += W) U[e] = U0[e];
    gs.setup(l, T);
  });

  const S inf = S(INFINITY);
  S mu = a.mu0[b], reg = S(kRegMin), nu_pen = S(1), done = S(0),
    iters = S(0);
  S stepn = inf, feas = inf, jref = inf, alpha = inf;

#pragma unroll 1
  for (int it = 0; it < a.n_iter; ++it) {
    if (a.adaptive && done >= S(0.5)) break;   // per-instance early exit

    // ======================= backward sweep =======================
    // terminal cost-to-go: lane l writes its rows of Pxx, Pxv, px and its
    // control's Pvv row and pv
    g.phase([&](int l) {
      auto& o = own[G::slot(l)];
      o.cost = S(0);
      o.jref = S(0);
      o.cl1 = S(0);
      o.feas = S(0);
      o.pmax = S(0);
      if constexpr (CPL == 1) {
        for (int rr = 0; rr < RPL; ++rr) {
          const int i = row(l, rr);
          const S xN = X[N * NX + i];
          const S eN = xN - xdes[(N - 1) * NX + i], eF = xN - xfdes[i];
          S gg, h;
          bar_terms(xN, xmin[i], xmax[i], mu, gg, h);
          for (int j = 0; j < NX; ++j) T.Pxx(i, j) = S(0);
          T.Pxx(i, i) = (S(2) * q[i] + S(2) * qf[i]) + h;
          const S pxi = (S(2) * q[i] * eN + S(2) * qf[i] * eF) + gg;
          T.px(i) = pxi;
          Gs[N * NG + i] = pxi;
          for (int k = 0; k < NU; ++k) T.Pxv(i, k) = S(0);
          o.pmax = nmax(o.pmax, m_abs(pxi));
        }
      } else {
        Ph::terminal(T, l, o, params(), X, Gs, N, mu);
      }
      if (l == 0) {                      // the terminal merit terms
        S xN[NX];
        load(X, N * NX, NX, xN);
        o.cost = bar_value(xN, xmin, xmax, NX, mu);
        for (int i = 0; i < NX; ++i) {
          const S eN = xN[i] - xdes[(N - 1) * NX + i], eF = xN[i] - xfdes[i];
          o.cost = o.cost + q[i] * (eN * eN);
          o.cost = o.cost + qf[i] * (eF * eF);
        }
        for (int i = 0; i < NX; ++i) {
          const S eF = xN[i] - xfdes[i];
          o.jref = o.jref + qf[i] * (eF * eF);
        }
      }
      if constexpr (CPL == 1) {
        if (l < NU) {
          T.pv(l) = S(0);
          for (int k = 0; k < NU; ++k) T.Pvv(l, k) = S(0);
          Gs[N * NG + NX + l] = S(0);
          Gs[N * NG + NX + NU + l] = S(0);
        }
      }
    });

#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      const bool tk = k >= 1;
      const int kp = k >= 1 ? k - 1 : 0;
      const bool pinned = k < a.n_pin;

      // ---- (A) the lane's share of the linearization, defects, stage
      // gradients, merit partials
      g.phase([&](int l) {
        auto& o = own[G::slot(l)];
        S xl[NX], ul[NU], f[NX];
        load(X, k * NX, NX, xl);
        load(U, k * NU, NU, ul);
        gs.linearize(l, k, xl, ul, T, Js, f);
        for (int rr = 0; rr < RPL; ++rr) {
          const int i = row(l, rr);
          const S cki = (xl[i] - X[(k + 1) * NX + i]) + gs.inc(f[i]);
          T.ck(i) = cki;
          cks[k * NX + i] = cki;
          S gg, h;
          const S e = xl[i] - xdes[kp * NX + i];
          bar_terms(xl[i], xmin[i], xmax[i], mu, gg, h);
          o.gzx[rr] = tk ? S(2) * q[i] * e + gg : S(0);
          o.Dx[rr] = tk ? S(2) * q[i] + h : S(0);
          Gs[k * NG + i] = o.gzx[rr];
        }
        if constexpr (CPL == 1) {
          if (l < NU) {
            const S ukm1 = k == 0 ? uprev[l] : U[(k - 1) * NU + l];
            const S r2 = S(2) * r[l], rm2 = S(2) * rm[l];
            const S du = ul[l] - ukm1;
            S gg, h;
            bar_terms(ul[l], umin[l], umax[l], mu, gg, h);
            o.gzv = -(r2 * du);
            o.gu = (r2 * du + rm2 * ul[l]) + gg;
            o.Du = (r2 + rm2) + (h + reg);
            Gs[k * NG + NX + l] = o.gzv;
            Gs[k * NG + NX + NU + l] = o.gu;
          }
        } else {
          for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc) {
            const int c = row(l, cc);
            const S ukm1 = k == 0 ? uprev[c] : U[(k - 1) * NU + c];
            const S r2 = S(2) * r[c], rm2 = S(2) * rm[c];
            const S du = ul[c] - ukm1;
            S gg, h;
            bar_terms(ul[c], umin[c], umax[c], mu, gg, h);
            o.gzv[cc] = -(r2 * du);
            o.gu[cc] = (r2 * du + rm2 * ul[c]) + gg;
            o.Du[cc] = (r2 + rm2) + (h + reg);
            Gs[k * NG + NX + c] = o.gzv[cc];
            Gs[k * NG + NX + NU + c] = o.gu[cc];
          }
        }
        if (l == 0) {           // merit sums over the whole stage, in order
          S du[NU], e[NX], rmag;
          for (int j = 0; j < NU; ++j)
            du[j] = ul[j] - (k == 0 ? uprev[j] : U[(k - 1) * NU + j]);
          for (int i = 0; i < NX; ++i) {
            const S cki = (xl[i] - X[(k + 1) * NX + i]) + gs.inc(f[i]);
            o.feas = nmax(o.feas, m_abs(cki));
            o.cl1 = o.cl1 + m_abs(cki);
            e[i] = xl[i] - xdes[kp * NX + i];
          }
          o.cost = o.cost + stage_cost(xl, ul, du, e, tk, mu, rmag);
          S jr = rmag;
          for (int i = 0; i < NX; ++i) {
            const S er = (xl[i] + gs.inc(f[i])) - xdes[k * NX + i];
            jr = jr + q[i] * (er * er);
          }
          o.jref = o.jref + jr;
        }
      });

      // ---- (B) the step's blocks: the upper triangle of Qxx in columns,
      // Qxu and Quu columns, qz_x and qu
      g.phase([&](int l) {
        auto& o = own[G::slot(l)];
        if constexpr (CPL == 1) {
          S Prp[NX];                                 // px + Pxx ck
          for (int i = 0; i < NX; ++i) {
            S acc = T.Pxx(i, 0) * T.ck(0);
            for (int t = 1; t < NX; ++t) acc = acc + T.Pxx(i, t) * T.ck(t);
            Prp[i] = T.px(i) + acc;
          }
          for (int rr = 0; rr < RPL; ++rr) {
            const int j = row(l, rr);
            S v[NX];                                 // (Pxx A)[:, j]
            for (int i = 0; i < NX; ++i)
              v[i] = gs.At(T, j, [&](int t) { return T.Pxx(i, t); });
            for (int i = 0; i <= j; ++i) {           // (A' Pxx A)[i <= j, j]
              const S acc = gs.At(T, i, [&](int t) { return v[t]; });
              T.Qxx(i, j) = i == j ? acc + o.Dx[rr] : acc;
            }
            o.qz[rr] = o.gzx[rr] + gs.At(T, j, [&](int t) { return Prp[t]; });
          }
          if (l < NU) {
            S pb[NX], m1[NX];                        // Pxx B[:, l], + Pxv
            for (int i = 0; i < NX; ++i) {
              pb[i] = gs.Bt(T, l, [&](int t) { return T.Pxx(i, t); });
              m1[i] = pb[i] + T.Pxv(i, l);
            }
            for (int i = 0; i < NX; ++i)             // Qxu[:, l] = A' m1
              T.Qxu(i, l) = gs.At(T, i, [&](int t) { return m1[t]; });
            for (int mm = 0; mm < NU; ++mm) {        // Quu[:, l]
              const S bpb = gs.Bt(T, mm, [&](int t) { return pb[t]; });
              const S bpv = gs.Bt(T, mm, [&](int t) { return T.Pxv(t, l); });
              const S bpv_t = gs.Bt(T, l, [&](int t) { return T.Pxv(t, mm); });
              const S quu = (bpb + (bpv + bpv_t)) + T.Pvv(mm, l);
              T.Quu(mm, l) = mm == l ? quu + o.Du : quu;
            }
            S pv_acc = T.Pxv(0, l) * T.ck(0);        // pv + Pxv' ck
            for (int t = 1; t < NX; ++t)
              pv_acc = pv_acc + T.Pxv(t, l) * T.ck(t);
            const S prp_v = T.pv(l) + pv_acc;
            const S bp = gs.Bt(T, l, [&](int t) { return Prp[t]; });
            o.qu = o.gu + (bp + prp_v);
            T.qu(l) = o.qu;
          }
        } else {
          Ph::blocks(gs, T, l, o);
        }
      });

      // ---- (C) Cholesky of Quu (every lane; ops/elem.py chol order) and
      // the solves of the right-hand-side columns [ -Qxu' | 2R | -qu ]
      g.phase([&](int l) {
        S Lc[NU][NU], Linv[NU];
        for (int j = 0; j < NU; ++j) {
          S s = T.Quu(j, j);
          for (int t = 0; t < j; ++t) s = s - Lc[j][t] * Lc[j][t];
          const S d = m_sqrt(s);
          Lc[j][j] = d;
          Linv[j] = S(1) / d;
          for (int i = j + 1; i < NU; ++i) {
            S t2 = T.Quu(i, j);
            for (int t = 0; t < j; ++t) t2 = t2 - Lc[i][t] * Lc[j][t];
            Lc[i][j] = t2 * Linv[j];
          }
        }
#pragma unroll 1
        for (int c = l; c < NR; c += W) {
          S y[NU];
          for (int mm = 0; mm < NU; ++mm)
            y[mm] = c < NX ? -T.Qxu(c, mm)
                    : c < NZ ? (mm == c - NX ? S(2) * r[mm] : S(0))
                             : -T.qu(mm);
          for (int i = 0; i < NU; ++i) {           // L y = rhs
            for (int t = 0; t < i; ++t) y[i] = y[i] - Lc[i][t] * y[t];
            y[i] = y[i] * Linv[i];
          }
          for (int i = NU - 1; i >= 0; --i) {      // L' x = y
            for (int t = i + 1; t < NU; ++t) y[i] = y[i] - Lc[t][i] * y[t];
            y[i] = y[i] * Linv[i];
          }
          for (int mm = 0; mm < NU; ++mm) {
            const S v = pinned ? S(0) : y[mm];
            T.Y(mm, c) = v;
            if (c < NZ) Ks[(k * NU + mm) * NZ + c] = v;
            else kffs[k * NU + mm] = v;
          }
        }
      });

      // ---- (D) the new carries: Pxx = sym(Qxx + Qxu Kx) in columns (both
      // of its terms (i, j) and (j, i) here), or Qxx where the head is
      // pinned; Pxv, Pvv columns; px, pv
      g.phase([&](int l) {
        auto& o = own[G::slot(l)];
        if constexpr (CPL == 1) {
          auto qkx = [&](int i, int j) {             // (Qxu Kx)[i][j]
            S acc = T.Qxu(i, 0) * T.Y(0, j);
            for (int t = 1; t < NU; ++t) acc = acc + T.Qxu(i, t) * T.Y(t, j);
            return acc;
          };
          for (int rr = 0; rr < RPL; ++rr) {
            const int j = row(l, rr);
            for (int i = 0; i < NX; ++i) {
              const S qxx = i <= j ? T.Qxx(i, j) : T.Qxx(j, i);
              T.Pxx(i, j) = pinned ? qxx
                  : S(0.5) * ((qxx + qkx(i, j)) + (qxx + qkx(j, i)));
            }
            S pxj = o.qz[rr];
            if (!pinned) {
              S acc = T.Qxu(j, 0) * T.Y(0, NZ);
              for (int t = 1; t < NU; ++t)
                acc = acc + T.Qxu(j, t) * T.Y(t, NZ);
              pxj = pxj + acc;
            }
            T.px(j) = pxj;
            o.pmax = nmax(o.pmax, m_abs(pxj));
          }
          if (l < NU) {
            const S r2l = S(2) * r[l];
            S pvl = o.gzv;
            if (pinned) {
              for (int i = 0; i < NX; ++i) T.Pxv(i, l) = S(0);
              for (int mm = 0; mm < NU; ++mm)
                T.Pvv(mm, l) = mm == l ? r2l : S(0);
            } else {
              for (int i = 0; i < NX; ++i) {
                S acc = T.Qxu(i, 0) * T.Y(0, NX + l);
                for (int t = 1; t < NU; ++t)
                  acc = acc + T.Qxu(i, t) * T.Y(t, NX + l);
                T.Pxv(i, l) = S(0.5) * (acc + -(r2l * T.Y(l, i)));
              }
              for (int mm = 0; mm < NU; ++mm) {
                const S pvv = S(-0.5) * (S(2) * r[mm] * T.Y(mm, NX + l)
                                         + r2l * T.Y(l, NX + mm));
                T.Pvv(mm, l) = mm == l ? pvv + r2l : pvv;
              }
              pvl = pvl - r2l * T.Y(l, NZ);
            }
            T.pv(l) = pvl;
            o.pmax = nmax(o.pmax, m_abs(pvl));
          }
        } else {
          Ph::carries(T, l, o, r, pinned);
        }
      });
    }

    // every lane's max|p| and lane 0's sums, through the tile
    g.phase([&](int l) {
      const auto& o = own[G::slot(l)];
      T.red(l, 0) = o.pmax;
      if (l == 0) {
        T.red(0, 1) = o.cost;
        T.red(0, 2) = o.jref;
        T.red(0, 3) = o.cl1;
        T.red(0, 4) = o.feas;
      }
    });
    const S cost0 = T.red(0, 1), jref_old = T.red(0, 2), c_l1 = T.red(0, 3);
    const S feas_i = T.red(0, 4), pmax = lanes_max(0);
    const S nu_pen_new = nmax(nu_pen, S(2) * pmax + S(1));
    const S m0 = cost0 + nu_pen_new * c_l1;

    // ======================= forward rollout =======================
    // dx / dv of stage k in buffer k & 1; du_k goes to the other buffer,
    // where it is the next stage's dv.
    g.phase([&](int l) {
      auto& o = own[G::slot(l)];
      for (int rr = 0; rr < RPL; ++rr) {
        T.dx(0, row(l, rr)) = S(0);
        dXs[row(l, rr)] = S(0);
      }
      if constexpr (CPL == 1) {
        if (l < NU) T.du(0, l) = S(0);
      } else {
        for (int cc = 0; cc < CPL && row(l, cc) < NU; ++cc)
          T.du(0, row(l, cc)) = S(0);
      }
      o.ddir = S(0);
      o.amax = S(1);
      o.stepn = S(0);
    });
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const int cur = k & 1, nxt = cur ^ 1;
      g.phase([&](int l) {
        if constexpr (CPL == 1) {
          if (l >= NU) return;
          const int base = (k * NU + l) * NZ;
          S acc = Ks[base] * T.dx(cur, 0);
          for (int j = 1; j < NX; ++j)
            acc = acc + Ks[base + j] * T.dx(cur, j);
          for (int j = 0; j < NU; ++j)
            acc = acc + Ks[base + NX + j] * T.du(cur, j);
          T.du(nxt, l) = acc + kffs[k * NU + l];
        } else {
          Ph::rollout_du(T, l, k, Ks, kffs);
        }
      });
      g.phase([&](int l) {
        auto& o = own[G::slot(l)];
        if constexpr (CPL == 1) {
          if (l == 0) {                  // directional derivative, in order
            for (int i = 0; i < NX; ++i)
              o.ddir = o.ddir + Gs[k * NG + i] * T.dx(cur, i);
            for (int j = 0; j < NU; ++j) {
              o.ddir = o.ddir + Gs[k * NG + NX + j] * T.du(cur, j);
              o.ddir = o.ddir + Gs[k * NG + NX + NU + j] * T.du(nxt, j);
            }
          }
          for (int rr = 0; rr < RPL; ++rr) {
            const int i = row(l, rr);
            const S dxn = gs.next_row(
                T, k, i, [&](int j) { return T.dx(cur, j); },
                [&](int j) { return T.du(nxt, j); }, Js, cks);
            T.dx(nxt, i) = dxn;
            dXs[(k + 1) * NX + i] = dxn;
            o.amax = ftb(X[(k + 1) * NX + i], dxn, xmin[i], xmax[i], o.amax);
            o.stepn = nmax(o.stepn, m_abs(dxn));
          }
          if (l < NU) {
            const S dul = T.du(nxt, l);
            o.amax = ftb(U[k * NU + l], dul, umin[l], umax[l], o.amax);
            o.stepn = nmax(o.stepn, m_abs(dul));
            dUs[k * NU + l] = dul;
          }
        } else {
          Ph::rollout_dx(gs, T, l, k, o, params(), X, U, Gs, Js, cks, dXs,
                         dUs);
        }
      });
    }
    g.phase([&](int l) {
      auto& o = own[G::slot(l)];
      if (l == 0) {
        for (int i = 0; i < NX; ++i)
          o.ddir = o.ddir + Gs[N * NG + i] * T.dx(N & 1, i);
        T.red(0, 5) = o.ddir;
      }
      T.red(l, 6) = o.amax;
      T.red(l, 7) = o.stepn;
    });
    const S ddir = T.red(0, 5) - nu_pen_new * c_l1;
    const S amax = lanes_min(6), stepn_i = lanes_max(7);

    // =========== line search: lane l takes rungs l, l + W, ... ===========
    const S eps_m = S(kNoiseFloorMult) * Eps<S>::value * (S(1) + m_abs(m0));
    g.phase([&](int l) {
      auto& o = own[G::slot(l)];
      S al[kRungs];
      for (int s = 0; s < kRungs; ++s) {
        al[s] = amax * a.fan[l + W * s];
        o.cost_t[s] = S(0);
        o.cl1_t[s] = S(0);
        o.jref_t[s] = S(0);
      }
#pragma unroll 1
      for (int k = 0; k < N; ++k) {
        const bool tk = k >= 1;
        const int kp = k >= 1 ? k - 1 : 0;
        S xl[NX], ul[NU], xn1[NX], dxk[NX], duk[NU], dxk1[NX], ukm1[NU],
            dukm1[NU];
        load(X, k * NX, NX, xl);
        load(U, k * NU, NU, ul);
        load(X, (k + 1) * NX, NX, xn1);
        load(dXs, k * NX, NX, dxk);
        load(dUs, k * NU, NU, duk);
        load(dXs, (k + 1) * NX, NX, dxk1);
        if (k == 0) {
          load(uprev, 0, NU, ukm1);
          for (int j = 0; j < NU; ++j) dukm1[j] = S(0);
        } else {
          load(U, (k - 1) * NU, NU, ukm1);
          load(dUs, (k - 1) * NU, NU, dukm1);
        }
        for (int s = 0; s < kRungs; ++s) {
          if (l + W * s >= a.n_fan) break;
          const S aj = al[s];
          S xt[NX], ut[NU], dut[NU], et[NX], vt[NX];
          for (int i = 0; i < NX; ++i) {
            xt[i] = xl[i] + aj * dxk[i];
            et[i] = xt[i] - xdes[kp * NX + i];
          }
          for (int j = 0; j < NU; ++j) {
            ut[j] = ul[j] + aj * duk[j];
            dut[j] = ut[j] - (ukm1[j] + aj * dukm1[j]);
          }
          S rmag;
          const S sc = stage_cost(xt, ut, dut, et, tk, mu, rmag);
          gs.value(T, xt, ut, vt);
          S cl1 = o.cl1_t[s], jr = rmag;
          for (int i = 0; i < NX; ++i) {
            const S inc = vt[i];
            const S vi = xt[i] + inc;
            cl1 = cl1 + m_abs(((xl[i] - xn1[i]) + aj * (dxk[i] - dxk1[i]))
                              + inc);
            const S er = vi - xdes[k * NX + i];
            jr = jr + q[i] * (er * er);
          }
          o.cost_t[s] = o.cost_t[s] + sc;
          o.cl1_t[s] = cl1;
          o.jref_t[s] = o.jref_t[s] + jr;
        }
      }
      // terminal terms per rung and the Armijo test
      S xN[NX], dxN[NX];
      load(X, N * NX, NX, xN);
      load(dXs, N * NX, NX, dxN);
      for (int s = 0; s < kRungs; ++s) {
        const int j = l + W * s;
        if (j >= a.n_fan) break;
        S xt[NX];
        S ct = o.cost_t[s], jr = o.jref_t[s];
        for (int i = 0; i < NX; ++i) {
          xt[i] = xN[i] + al[s] * dxN[i];
          const S eN = xt[i] - xdes[(N - 1) * NX + i];
          const S eF = xt[i] - xfdes[i];
          ct = (ct + q[i] * eN * eN) + qf[i] * eF * eF;
          jr = jr + qf[i] * eF * eF;
        }
        ct = ct + bar_value(xt, xmin, xmax, NX, mu);
        const S mj = ct + nu_pen_new * o.cl1_t[s];
        const bool pass = m_isfinite(mj)
            && mj <= (m0 + S(kArmijoSlope) * al[s] * ddir) + eps_m;
        T.fan(j, 0) = pass ? S(1) : S(0);
        T.fan(j, 1) = al[s];
        T.fan(j, 2) = jr;
      }
    });
    // first passing rung in fan order wins
    S alpha_new = S(0), jref_new = jref_old;
    for (int j = 0; j < a.n_fan; ++j)
      if (T.fan(j, 0) > S(0.5)) {
        alpha_new = T.fan(j, 1);
        jref_new = T.fan(j, 2);
        break;
      }

    // 0*inf-guarded update: a rejected direction may hold inf/NaN.
    if (alpha_new > S(0)) {
      g.phase([&](int l) {
        for (int e = l; e < (N + 1) * NX; e += W)
          X[e] = X[e] + alpha_new * dXs[e];
        for (int e = l; e < N * NU; e += W)
          U[e] = U[e] + alpha_new * dUs[e];
      });
    }

    nu_pen = nu_pen_new;
    stepn = stepn_i;
    feas = feas_i;
    jref = jref_new;
    alpha = alpha_new;
    if (!a.adaptive) continue;

    // ---- adaptive bookkeeping, uniform over the group (solve_instance's)
    const bool no_move = alpha_new == S(0) || !m_isfinite(alpha_new);
    const bool crawl = no_move || alpha_new < S(0.01) * amax;
    const S reg_new = crawl
        ? nmin(reg * S(kRegGrow) + S(kRegGrowAbs), S(kRegDiverged))
        : nmax(reg * S(kRegShrink), S(kRegMin));
    const bool inner_done =
        stepn_i < nmax(S(kInnerMuMult) * mu, a.tol)
        && feas_i < S(kInnerMuMult) * a.tol;
    const S mu_new = inner_done ? nmax(a.mu_floor, a.kappa * mu) : mu;
    const bool conv = stepn_i < a.tol && feas_i < a.tol
        && mu <= S(2) * a.mu_floor;
    const bool div = reg_new >= S(kRegDiverged);
    done = conv ? S(1) : (div ? S(2) : S(0));
    mu = mu_new;
    reg = reg_new;
    iters = iters + S(1);
  }

  g.phase([&](int l) {
    if (l != 0) return;
    stats[0] = stepn;
    stats[1] = feas;
    stats[2] = jref;
    stats[3] = alpha;
    stats[4] = mu;
    stats[5] = done;
    stats[6] = iters;
    stats[7] = S(0);
  });
}

}  // namespace mpc
