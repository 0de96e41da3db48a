// The fused SQP body with a whole thread block on one instance: the body
// that the card runs at small batch for the step policies `BlockBody`
// names (fused_sqp_launch.cuh picks it from B and N), and, built by g++,
// of the tests' CPU build.
//
// It computes what `solve_group` (fused_sqp_group.cuh) computes, in the
// same iteration modes and branches and with the same sums in the same
// order, so the two g++ builds agree bit for bit.  What the group body
// runs stage after stage on W lanes and what is independent across stages
// runs here across the block at once:
//
// * the instance lives in shared memory: X0, U0 and the parameters are
//   read once, coalesced; X, U, the gains K, kff, the steps dX, dU, the
//   gradients G, the Jacobian rows J, the defects ck and the Riccati tile
//   stay there for the whole solve (~30 KB at N = 25 on the Euler arm,
//   linear in N); X, U and the stats go to global memory once, at the end;
// * the linearization is hoisted out of the backward sweep: before each
//   sweep, every stage's tangent tasks run across the block (the arms:
//   the NQ q columns, each a pass through the whole chain, then the NQ qd
//   columns, the RNEA alone, and the NQ u columns, two triangular solves,
//   which read the stage's Cholesky factor from the first; the closed
//   forms and a user's model under Euler: the NZ dual-number columns of
//   the accelerations; under any integrator: the NZ dual-number columns
//   of the step's increment; LTV has none: its step stays in the tile),
//   then one task a stage forms its defects, gradients, barrier diagonal
//   and merit partials;
// * the Riccati sweep alone stays serial: the group body's phases (B),
//   (C), (D) (`GroupPhases`, fused_sqp_group.cuh) on the W lanes of warp
//   0, with the group body's lane ownership of rows and controls, reading
//   the stage's rows and defects from shared memory; beside it one thread
//   of warp 1 sums the merit's partials in the group body's order (stage
//   N-1 down to 0, a stage's components in order), so the Armijo test's
//   float32 sums are the group body's;
// * the rollout of dX stays serial on the same W lanes
//   (`GroupPhases::rollout_du`, `rollout_dx`);
// * the line search runs rung x stage tasks across the block, storing each
//   task's stage cost, reference cost and |defect| components; then one
//   thread a rung sums them in order and takes the Armijo test; the first
//   passing rung in fan order wins, as in the group body.
//
// Threads: 256.  The Euler arm's tasks are 4 and 8 a stage (q; qd and u),
// the double pendulum's 6, and the line search's 4 or 8 rungs a stage, so
// at N = 25 every phase but the arms' second (200 tasks) is one pass of
// 256 threads, and 256 threads at the 255 registers the arm's chain pass
// takes fill one SM's register file (one block an SM, which the launch
// bounds ask for).  Code between phases is uniform (every thread computes
// the same from the same shared values), so the block leaves the adaptive
// loop together.
//
// On the device a phase ends at a block barrier (`Block::sync`), the
// sweep's and the rollout's at the group's `__syncwarp`; on the host one
// thread runs every task of a phase in turn, and every lane of the group's
// phases, over a local array that stands in for shared memory.
#pragma once

#include "fused_sqp_group.cuh"

namespace mpc {

constexpr int kBlockThreads = 256;
// The thread that sums the merit's partials during the sweep: the first of
// warp 1 (warp 0 runs the sweep).
constexpr int kMeritThread = 32;

// The stretches of the body between two block barriers, by what they do
// (the operation counter's critical path is split by them:
// flop_count.cpp `PathBlock`).
enum Region { kLoad, kLinearize, kStageTerms, kSweep, kRollout, kRungTerms,
              kRungSums, kUpdate, kRegions };

// The NT threads of one block.  `each(n, f)` runs f(i) for i in [0, n)
// spread over the threads, `sync(region)` is the block barrier that ends a
// region, `on(t, f)` runs f on thread t alone and `group(W)` says whether
// this thread is one of the W lanes of warp 0's group, whose phases run on
// `Lanes<W>`.  On the host one thread is every thread.
template <int NT>
struct Block {
  template <int W> using Lanes = Group<W>;
  int tid;
  template <typename F>
  MPC_HD void each(int n, const F& f) const {
#if defined(__CUDA_ARCH__)
    for (int i = tid; i < n; i += NT) f(i);
#else
    for (int i = 0; i < n; ++i) f(i);
#endif
  }
  MPC_HD void sync(Region) const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
  template <typename F>
  MPC_HD void on(int t, const F& f) const {
#if defined(__CUDA_ARCH__)
    if (tid == t) f();
#else
    (void)t;
    f();
#endif
  }
  MPC_HD bool group(int W) const {
#if defined(__CUDA_ARCH__)
    return tid < W;
#else
    (void)W;
    return true;
#endif
  }
  // This thread's lane of warp 0's group (threads 0 .. W-1).
  template <int W>
  MPC_HD Group<W> lanes() const {
#if defined(__CUDA_ARCH__)
    return Group<W>{tid, (1u << W) - 1u};
#else
    return Group<W>{0, 0u};
#endif
  }
};

// ---- block step policies.  `BlockStep<S, Step>` gives the body a stage's
// linearization as tasks: kPasses passes, `tasks(pass)` tasks a stage in
// each, and `task(pass, t, xl, ul, J, F, E)`, which writes its share of the
// stage's NJ dt-scaled acceleration rows to J (NJ x NZ), the stage's f
// (what `GroupStep::inc` makes the increment of) to F, and NE values of
// its own that a later pass reads to E.  Each task is the arithmetic of the
// group step's `linearize` for its column.  A policy with no passes (LTV)
// keeps its step in the tile for the whole solve, and f is formed from it
// a row a task.
template <typename S, typename Step> struct BlockStep;

// The arms under Euler, folded: pass 0 the q columns (the q_0 task also
// stores f and the Cholesky factor L of M), pass 1 the qd and u columns
// from that L.
template <typename S, int NQ_>
struct BlockStep<S, FastNq<S, ArmModel<S, NQ_>>> {
  static constexpr int NQ = NQ_, NX = 2 * NQ, NZ = 3 * NQ, NJ = NQ,
                       NE = NQ * NQ, kPasses = 2;
  const ArmConsts<S, NQ>& c;
  S dt;
  MPC_HD BlockStep(const FastNq<S, ArmModel<S, NQ>>& s, const FusedArgs<S>& a)
      : c(s.m.c), dt(a.dt) {}
  MPC_HD static int tasks(int pass) { return pass == 0 ? NQ : 2 * NQ; }
  MPC_HD void task(int pass, int t, const S* xl, const S* ul, S* J, S* F,
                   S* E) const {
    S L[NQ][NQ], col[NQ];
    int cc;
    if (pass == 0) {
      S qdd[NQ];
      arm_q_column(c, xl, xl + NQ, ul, t, L, qdd, col);
      cc = t;
      if (t == 0) {
        for (int i = 0; i < NX; ++i) F[i] = i < NQ ? xl[NQ + i] : qdd[i - NQ];
        for (int i = 0; i < NQ; ++i)
          for (int j = 0; j < NQ; ++j) E[i * NQ + j] = L[i][j];
      }
    } else {
      for (int i = 0; i < NQ; ++i)
        for (int j = 0; j < NQ; ++j) L[i][j] = E[i * NQ + j];
      if (t < NQ) {
        arm_qd_column(c, xl, xl + NQ, t, L, col);
        cc = NQ + t;
      } else {
        arm_u_column(L, t - NQ, col);
        cc = NX + (t - NQ);
      }
    }
    for (int i = 0; i < NQ; ++i) J[i * NZ + cc] = dt * col[i];
  }
};

// The closed forms under Euler: one pass, a dual-number pass of `acc` a
// tangent column (the d = 0 task also stores f).
template <typename S, typename Model>
struct BlockStep<S, FastNq<S, Model>> {
  static constexpr int NQ = Model::NQ, NX = Model::NX, NU = Model::NU,
                       NZ = NX + NU, NJ = NQ, NE = 0, kPasses = 1;
  const Model& m;
  S dt;
  MPC_HD BlockStep(const FastNq<S, Model>& s, const FusedArgs<S>& a)
      : m(s.m), dt(a.dt) {}
  MPC_HD static int tasks(int) { return NZ; }
  MPC_HD void task(int, int d, const S* xl, const S* ul, S* J, S* F,
                   S*) const {
    typedef Dual<S, 1> Dd;
    Dd xd[NX], ud[NU], qdd[NQ];
    seed<S, 1, NX, NU>(xl, ul, d, xd, ud);
    m.acc(xd, ud, qdd);
    for (int i = 0; i < NQ; ++i) J[i * NZ + d] = dt * qdd[i].d[0];
    if (d == 0)
      for (int i = 0; i < NQ; ++i) {
        F[i] = xl[NQ + i];
        F[NQ + i] = qdd[i].v;
      }
  }
};

// Any integrator (`Generic`): one pass, a dual-number pass of the step's
// increment a tangent column (`GroupStep<Generic>::linearize`'s column d),
// its column of the NX rows [A - I | B] to J (the d = 0 task also stores
// the increment).  `solve_block` forms A = I + rows in the tile with the
// rows (`stage_to_tile`).
template <typename S, typename Model>
struct BlockStep<S, Generic<S, Model>> {
  static constexpr int NX = Model::NX, NU = Model::NU, NZ = NX + NU, NJ = NX,
                       NE = 0, kPasses = 1;
  const Generic<S, Model>& st;
  S dt;
  MPC_HD BlockStep(const Generic<S, Model>& s, const FusedArgs<S>& a)
      : st(s), dt(a.dt) {}
  MPC_HD static int tasks(int) { return NZ; }
  MPC_HD void task(int, int d, const S* xl, const S* ul, S* J, S* F,
                   S*) const {
    typedef Dual<S, 1> Dd;
    Dd xd[NX], ud[NU], out[NX];
    seed<S, 1, NX, NU>(xl, ul, d, xd, ud);
    model_increment(st.m, st.integ, dt, xd, ud, out);
    for (int i = 0; i < NX; ++i) J[i * NZ + d] = out[i].d[0];
    if (d == 0)
      for (int i = 0; i < NX; ++i) F[i] = out[i].v;
  }
};

// LTV: no linearization.  The affine step (Ad - I | Bd), A = I + (Ad - I)
// and cd go into the tile once a solve (`GroupStep<Ltv>::setup`), and stay
// there: no stage rows to J (NJ = 0); f = (Ad - I) x + Bd u + cd formed
// from the tile a row a task (`solve_block`).
template <typename S, int NX_, int NU_>
struct BlockStep<S, Ltv<S, NX_, NU_>> {
  static constexpr int NJ = 0, NE = 0, kPasses = 0;
  MPC_HD BlockStep(const Ltv<S, NX_, NU_>&, const FusedArgs<S>&) {}
  MPC_HD static int tasks(int) { return 0; }
  MPC_HD void task(int, int, const S*, const S*, S*, S*, S*) const {}
};

// The scalar type of a step policy.
template <typename Step> struct StepScalar;
template <typename S, typename M> struct StepScalar<FastNq<S, M>> {
  typedef S type;
};
template <typename S, typename M> struct StepScalar<Generic<S, M>> {
  typedef S type;
};
template <typename S, int NX, int NU> struct StepScalar<Ltv<S, NX, NU>> {
  typedef S type;
};

// Which step policies the card runs on the block body, and up to which
// batch (the launcher's rule, `use_block`).  kMaxBatch is where the block
// body stops beating the group body: the two bodies timed in turns on the
// H100 (tools/time_fused_modes.py, fixed-3 warm, device ms a launch, NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md §6).  One block an SM, so the block
// body takes a wave of 132 instances in one body's time and adds one a
// wave; the group body stays near flat to B ~ 4096:
// - the arm: block 0.516-0.530 ms from B=1 to 132, 1.061 at 264, 1.592 at
//   396, 2.123 at 528, 2.654-2.692 at 660, 3.187 at 792, 4.244 at 1024;
//   group 2.922-3.233 over the same batches: block through 660 (five
//   waves), a tie at 792, group from 1024;
// - the double pendulum: block 0.244-0.248 ms to 132, 0.490 at 264, 0.733
//   at 396, 0.974 at 528; group 0.680-0.906: block through 396 (three
//   waves), group from 528;
// - LTV at (8, 4): block 0.467-0.471 ms to 132, 0.940 at 264, 1.409 at
//   396; group 0.869-1.060 to 264, 1.102 at 396: block through 264 (two
//   waves), group from 396.
template <typename Step> struct BlockBody {
  static constexpr bool value = false;
};
template <typename S> struct BlockBody<FastNq<S, ArmModel<S, 4>>> {
  static constexpr bool value = true;
  static constexpr long long kMaxBatch = 660;
};
template <typename S> struct BlockBody<FastNq<S, DoublePendulum<S>>> {
  static constexpr bool value = true;
  static constexpr long long kMaxBatch = 396;
};
template <typename S> struct BlockBody<Ltv<S, 8, 4>> {
  static constexpr bool value = true;
  static constexpr long long kMaxBatch = 264;
};

// A user's model (gen::Model, models/codegen.py) under either step policy:
// the block body where its shape splits over the policy's lanes (`group_fits`:
// not the unicycle's nx = 3, which stays on one thread).  Its library is
// built at first use, so kMaxBatch cannot be timed per model: one rule a
// family, the smallest crossover of the cases timed, rounded down to a
// whole wave of 132 (tools/time_fused_modes.py, the bodies in turns,
// fixed-3 warm, device ms a launch, NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md §6).  A block of up to 128 registers a thread leaves room for two
// an SM, so such a model adds its time every 264 instances:
// - FastNq: the cart-pole's own f, block 0.196 ms to B=264, 0.392 at 396
//   and 528, 0.587 at 660 and 792, 0.784 at 1024; one thread 0.585 at
//   B=1, 0.68-0.73 from 132 to 1024: block through 792.  The 4-DOF chain
//   user_chain4 (nx = 8, nu = 4; 165 registers, one block an SM), block
//   0.768 to B=132, 1.537 at 264, 2.305 at 396, 3.075 at 528; one thread
//   1.94 at B=1, 2.39-2.77 from 132 to 1024: block through 396.  Rule 396;
// - Generic: Van der Pol under RK4, block 0.120-0.122 ms to B=264, 0.240
//   at 396 and 528, 0.358-0.360 at 660 and 792, 0.478 at 1024; the
//   two-lane group body 0.315 at B=1, 0.42-0.47 from 132 to 1024: block
//   through 792.  Rule 792.
namespace gen {
template <typename S> struct Model;
}
template <typename Step, long long kMax>
struct GeneratedBlockBody {
  static constexpr bool value =
      group_fits<typename StepScalar<Step>::type, Step>();
  static constexpr long long kMaxBatch = kMax;
};
template <typename S>
struct BlockBody<FastNq<S, gen::Model<S>>>
    : GeneratedBlockBody<FastNq<S, gen::Model<S>>, 396> {};
template <typename S>
struct BlockBody<Generic<S, gen::Model<S>>>
    : GeneratedBlockBody<Generic<S, gen::Model<S>>, 792> {};

// Where each array of one instance lies in the block's shared memory, in
// scalars: the Riccati tile, the parameters, the iterate and its step, the
// scratch of the group body (K, kff, G, J, ck), what the stage tasks leave
// for the sweep (f, the policy's NE values, the barrier diagonal, the
// merit partials), and the line search's rung x stage terms (kMaxFan
// rungs, whatever the fan).
template <typename S, typename Step>
struct BlockLayout {
  typedef BlockStep<S, Step> BS;
  typedef GroupStep<S, Step> GS;
  static constexpr int NX = GS::NX, NU = GS::NU, NZ = NX + NU,
                       NG = NX + 2 * NU, kRed = 8;
  int tile, xdes, q, r, rm, uprev, umin, umax, xmin, xmax, qf, xfdes, X, U,
      dX, dU, K, kff, G, J, ck, F, E, Dx, Du, sc, jr, fsc, fjr, fad, red,
      end;
  MPC_HD explicit BlockLayout(int N) {
    int o = 0;
    auto take = [&](int n) {
      const int at = o;
      o += n;
      return at;
    };
    tile = take(GS::Tile::kSize);
    xdes = take(N * NX);
    q = take(NX);
    r = take(NU);
    rm = take(NU);
    uprev = take(NU);
    umin = take(NU);
    umax = take(NU);
    xmin = take(NX);
    xmax = take(NX);
    qf = take(NX);
    xfdes = take(NX);
    X = take((N + 1) * NX);
    U = take(N * NU);
    dX = take((N + 1) * NX);
    dU = take(N * NU);
    K = take(N * NU * NZ);
    kff = take(N * NU);
    G = take((N + 1) * NG);
    J = take(N * BS::NJ * NZ);
    ck = take(N * NX);
    F = take(N * NX);
    E = take(N * BS::NE);
    Dx = take(N * NX);
    Du = take(N * NU);
    sc = take(N);
    jr = take(N);
    fsc = take(kMaxFan * N);
    fjr = take(kMaxFan * N);
    fad = take(kMaxFan * N * NX);
    red = take(kRed);
    end = o;
  }
};

// Shared memory of one block of the block body on the card (float32) at
// horizon N, in bytes, for a policy `BlockBody` names.
template <typename Step>
MPC_HD long long block_smem_bytes(int N) {
  return (long long)sizeof(float) *
         BlockLayout<typename StepScalar<Step>::type, Step>(N).end;
}

// The launcher's rule: the block body for a policy `BlockBody` names, at a
// batch up to its kMaxBatch and a horizon whose instance fits in one
// block's shared memory; the policy's body at full occupancy (the group
// body where `GroupBody` names it, one thread an instance otherwise) at
// every other (B, N).
enum Body { kThreadBody = 0, kGroupBody = 1, kBlockBody = 2 };

template <typename Step>
MPC_HD bool use_block(long long B, int N) {
  if constexpr (!BlockBody<Step>::value) {
    (void)B;
    (void)N;
    return false;
  } else {
    return B <= BlockBody<Step>::kMaxBatch &&
           block_smem_bytes<Step>(N) <= kBlockSmemMax;
  }
}

// The threads an instance of policy Step's body `body` (a `Body`).
template <typename Step>
MPC_HD int body_threads(int body) {
  if (body == kBlockBody) return kBlockThreads;
  if (body == kGroupBody)
    return GroupStep<typename StepScalar<Step>::type, Step>::W;
  return 1;
}

// The body the rule picks for B instances at horizon N, and its threads an
// instance in `threads` (when given).
template <typename Step>
MPC_HD int card_body(long long B, int N, int* threads) {
  const int body = use_block<Step>(B, N)     ? kBlockBody
                   : GroupBody<Step>::value ? kGroupBody
                                            : kThreadBody;
  if (threads) *threads = body_threads<Step>(body);
  return body;
}

// The body of instance b on the threads of `blk` (a `Block`, or the
// operation counter's stand-in), over `sh`, the block's shared memory
// (`BlockLayout`).
template <typename S, typename Step, typename Blk>
MPC_HD void solve_block(const FusedArgs<S>& a, const Step& step, long long b,
                        const Blk& blk, S* sh) {
  typedef GroupStep<S, Step> GS;
  typedef GroupPhases<S, GS> Ph;
  typedef BlockStep<S, Step> BS;
  constexpr int W = GS::W, NX = GS::NX, NU = GS::NU, NG = NX + 2 * NU,
                NZ = NX + NU, NJ = BS::NJ, NE = BS::NE, RPL = NX / W;
  // a lane owns controls l, l + W, ... (`GroupPhases`)
  static_assert(NX % W == 0 && kMaxFan % W == 0, "group split");
  typedef typename Blk::template Lanes<W> G;
  const GS gs(step, a, b);
  const BS bs(step, a);
  const long long B = a.B;
  const int N = a.N;
  const BlockLayout<S, Step> Lo(N);
  typedef Lane<const S> CL;
  typedef Lane<S> SL;
  auto at = [&](int off) { return SL{sh + off, 1}; };
  const InstanceParams<SL> p{
      at(Lo.xdes), at(Lo.q), at(Lo.r), at(Lo.rm), at(Lo.uprev), at(Lo.umin),
      at(Lo.umax), at(Lo.xmin), at(Lo.xmax), at(Lo.qf), at(Lo.xfdes)};
  const SL X = at(Lo.X), U = at(Lo.U), dXs = at(Lo.dX), dUs = at(Lo.dU);
  const SL Ks = at(Lo.K), kffs = at(Lo.kff), Gs = at(Lo.G), Js = at(Lo.J);
  const SL cks = at(Lo.ck);
  S *const Fs = sh + Lo.F, *const Es = sh + Lo.E, *const Dxs = sh + Lo.Dx,
    *const Dus = sh + Lo.Du, *const scs = sh + Lo.sc, *const jrs = sh + Lo.jr,
    *const fsc = sh + Lo.fsc, *const fjr = sh + Lo.fjr,
    *const fad = sh + Lo.fad, *const red = sh + Lo.red;
  const typename GS::View T{sh + Lo.tile};
  typedef typename Ph::Own Own;
  Own own[G::kHostLanes];
  const G g = blk.template lanes<W>();

  auto load = [&](const auto& src, int base, int n, S* dst) {
    for (int i = 0; i < n; ++i) dst[i] = src[base + i];
  };
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
  // Stage k's Jacobian rows and defects into the tile, lane l's share; a
  // dense step's rows (NJ = NX, `Generic`) also as A = I + rows, as
  // `GroupStep<Generic>::linearize` forms it.
  auto stage_to_tile = [&](int l, int k) {
    for (int e = l; e < NJ * NZ; e += W) {
      const S v = Js[k * NJ * NZ + e];
      T.t[GS::Tile::kJr + e] = v;
      if constexpr (NJ == NX) {
        const int i = e / NZ, c = e - i * NZ;
        if (c < NX) GS::A(T, i, c) = S(i == c ? 1 : 0) + v;
      }
    }
    for (int i = l; i < NX; i += W) T.ck(i) = cks[k * NX + i];
  };

  // ---- the instance into shared memory (the warm start into the working
  // iterate); what the tile holds for the whole solve
  {
    const CL X0{a.X0 + b, B}, U0{a.U0 + b, B};
    auto copy = [&](const S* src, int off, int n) {
      const CL s{src + b, B};
      blk.each(n, [&](int e) { sh[off + e] = s[e]; });
    };
    blk.each((N + 1) * NX, [&](int e) { X[e] = X0[e]; });
    blk.each(N * NU, [&](int e) { U[e] = U0[e]; });
    copy(a.xdes, Lo.xdes, N * NX);
    copy(a.q, Lo.q, NX);
    copy(a.r, Lo.r, NU);
    copy(a.rm, Lo.rm, NU);
    copy(a.uprev, Lo.uprev, NU);
    copy(a.umin, Lo.umin, NU);
    copy(a.umax, Lo.umax, NU);
    copy(a.xmin, Lo.xmin, NX);
    copy(a.xmax, Lo.xmax, NX);
    copy(a.qf, Lo.qf, NX);
    copy(a.xfdes, Lo.xfdes, NX);
    if (blk.group(W)) g.phase([&](int l) { gs.setup(l, T); });
    blk.sync(kLoad);
  }

  const S inf = S(INFINITY);
  S mu = a.mu0[b], reg = S(kRegMin), nu_pen = S(1), done = S(0),
    iters = S(0);
  S stepn = inf, feas = inf, jref = inf, alpha = inf;

#pragma unroll 1
  for (int it = 0; it < a.n_iter; ++it) {
    if (a.adaptive && done >= S(0.5)) break;   // per-instance early exit

    // ================= linearization, every stage at once =================
#pragma unroll 1
    for (int pass = 0; pass < BS::kPasses; ++pass) {
      const int nt = BS::tasks(pass);
      blk.each(N * nt, [&](int e) {
        const int k = e / nt, t = e - k * nt;
        S xl[NX], ul[NU];
        load(X, k * NX, NX, xl);
        load(U, k * NU, NU, ul);
        bs.task(pass, t, xl, ul, sh + Lo.J + k * NJ * NZ, Fs + k * NX,
                Es + k * NE);
      });
      blk.sync(kLinearize);
    }
    if constexpr (BS::kPasses == 0) {
      // LTV: no linearization; row i of stage k's f = (Ad - I) x + Bd u +
      // cd, a task a row, from the step in the tile (`GroupStep<Ltv>`)
      blk.each(N * NX, [&](int e) {
        const int k = e / NX, i = e - k * NX;
        S xl[NX], ul[NU];
        load(X, k * NX, NX, xl);
        load(U, k * NU, NU, ul);
        Fs[e] = GS::row(T, xl, ul, i) + GS::cd(T, i);
      });
      blk.sync(kLinearize);
    }
    // defects, stage gradients, barrier diagonal and merit partials, one
    // task a stage (the group body's phase (A))
    blk.each(N, [&](int k) {
      const bool tk = k >= 1;
      const int kp = k >= 1 ? k - 1 : 0;
      const S* f = Fs + k * NX;
      S xl[NX], ul[NU], du[NU], e[NX], rmag;
      load(X, k * NX, NX, xl);
      load(U, k * NU, NU, ul);
      for (int i = 0; i < NX; ++i) {
        cks[k * NX + i] = (xl[i] - X[(k + 1) * NX + i]) + gs.inc(f[i]);
        S gg, h;
        e[i] = xl[i] - p.xdes[kp * NX + i];
        bar_terms(xl[i], p.xmin[i], p.xmax[i], mu, gg, h);
        Gs[k * NG + i] = tk ? S(2) * p.q[i] * e[i] + gg : S(0);
        Dxs[k * NX + i] = tk ? S(2) * p.q[i] + h : S(0);
      }
      for (int l = 0; l < NU; ++l) {
        const S ukm1 = k == 0 ? p.uprev[l] : U[(k - 1) * NU + l];
        const S r2 = S(2) * p.r[l], rm2 = S(2) * p.rm[l];
        du[l] = ul[l] - ukm1;
        S gg, h;
        bar_terms(ul[l], p.umin[l], p.umax[l], mu, gg, h);
        Gs[k * NG + NX + l] = -(r2 * du[l]);
        Gs[k * NG + NX + NU + l] = (r2 * du[l] + rm2 * ul[l]) + gg;
        Dus[k * NU + l] = (r2 + rm2) + (h + reg);
      }
      scs[k] = Ph::stage_cost(p, xl, ul, du, e, tk, mu, rmag);
      S jr = rmag;
      for (int i = 0; i < NX; ++i) {
        const S er = (xl[i] + gs.inc(f[i])) - p.xdes[k * NX + i];
        jr = jr + p.q[i] * (er * er);
      }
      jrs[k] = jr;
    });
    blk.sync(kStageTerms);

    // ======== backward sweep on warp 0's group; merit sums beside it ========
    if (blk.group(W)) {
      g.phase([&](int l) {
        Own& o = own[G::slot(l)];
        o.pmax = S(0);
        Ph::terminal(T, l, o, p, X, Gs, N, mu);
        stage_to_tile(l, N - 1);
      });
#pragma unroll 1
      for (int k = N - 1; k >= 0; --k) {
        const bool pinned = k < a.n_pin;
        g.phase([&](int l) {
          Own& o = own[G::slot(l)];
          for (int rr = 0; rr < RPL; ++rr) {
            const int i = Ph::row(l, rr);
            o.gzx[rr] = Gs[k * NG + i];
            o.Dx[rr] = Dxs[k * NX + i];
          }
          for (int cc = 0; cc < Ph::CPL && Ph::row(l, cc) < NU; ++cc) {
            const int c = Ph::row(l, cc);
            o.gzv[cc] = Gs[k * NG + NX + c];
            o.gu[cc] = Gs[k * NG + NX + NU + c];
            o.Du[cc] = Dus[k * NU + c];
          }
          Ph::blocks(gs, T, l, o);
        });
        // (C) reads no rows or defects: the next stage's go to the tile
        g.phase([&](int l) {
          Ph::gains(T, l, p.r, Ks, kffs, k, pinned);
          if (k > 0) stage_to_tile(l, k - 1);
        });
        g.phase([&](int l) {
          Ph::carries(T, l, own[G::slot(l)], p.r, pinned);
        });
      }
      g.phase([&](int l) { T.red(l, 0) = own[G::slot(l)].pmax; });
    }
    blk.on(kMeritThread, [&] {
      S xN[NX], cost, jr0, cl1 = S(0), fz = S(0);
      load(X, N * NX, NX, xN);
      Ph::terminal_merit(p, xN, N, mu, cost, jr0);
#pragma unroll 1
      for (int k = N - 1; k >= 0; --k) {
        for (int i = 0; i < NX; ++i) {
          const S ak = m_abs(cks[k * NX + i]);
          fz = nmax(fz, ak);
          cl1 = cl1 + ak;
        }
        cost = cost + scs[k];
        jr0 = jr0 + jrs[k];
      }
      red[0] = cost;
      red[1] = jr0;
      red[2] = cl1;
      red[3] = fz;
    });
    blk.sync(kSweep);
    const S cost0 = red[0], jref_old = red[1], c_l1 = red[2];
    const S feas_i = red[3], pmax = lanes_max(0);
    const S nu_pen_new = nmax(nu_pen, S(2) * pmax + S(1));
    const S m0 = cost0 + nu_pen_new * c_l1;

    // ================ forward rollout on warp 0's group ================
    if (blk.group(W)) {
      g.phase([&](int l) {
        Own& o = own[G::slot(l)];
        for (int rr = 0; rr < RPL; ++rr) {
          T.dx(0, Ph::row(l, rr)) = S(0);
          dXs[Ph::row(l, rr)] = S(0);
        }
        for (int cc = 0; cc < Ph::CPL && Ph::row(l, cc) < NU; ++cc)
          T.du(0, Ph::row(l, cc)) = S(0);
        o.ddir = S(0);
        o.amax = S(1);
        o.stepn = S(0);
      });
#pragma unroll 1
      for (int k = 0; k < N; ++k) {
        g.phase([&](int l) { Ph::rollout_du(T, l, k, Ks, kffs); });
        g.phase([&](int l) {
          Ph::rollout_dx(gs, T, l, k, own[G::slot(l)], p, X, U, Gs, Js, cks,
                         dXs, dUs);
        });
      }
      g.phase([&](int l) {
        Own& o = own[G::slot(l)];
        if (l == 0) {
          for (int i = 0; i < NX; ++i)
            o.ddir = o.ddir + Gs[N * NG + i] * T.dx(N & 1, i);
          T.red(0, 5) = o.ddir;
        }
        T.red(l, 6) = o.amax;
        T.red(l, 7) = o.stepn;
      });
    }
    blk.sync(kRollout);
    const S ddir = T.red(0, 5) - nu_pen_new * c_l1;
    const S amax = lanes_min(6), stepn_i = lanes_max(7);

    // ===== line search: rung x stage tasks, then each rung's sums in order
    const S eps_m = S(kNoiseFloorMult) * Eps<S>::value * (S(1) + m_abs(m0));
    const int nf = a.n_fan;
    blk.each(N * nf, [&](int e) {
      const int k = e / nf, j = e - k * nf;
      S xl[NX], ul[NU], xn1[NX], dxk[NX], duk[NU], dxk1[NX], ukm1[NU],
          dukm1[NU];
      load(X, k * NX, NX, xl);
      load(U, k * NU, NU, ul);
      load(X, (k + 1) * NX, NX, xn1);
      load(dXs, k * NX, NX, dxk);
      load(dUs, k * NU, NU, duk);
      load(dXs, (k + 1) * NX, NX, dxk1);
      if (k == 0) {
        load(p.uprev, 0, NU, ukm1);
        for (int i = 0; i < NU; ++i) dukm1[i] = S(0);
      } else {
        load(U, (k - 1) * NU, NU, ukm1);
        load(dUs, (k - 1) * NU, NU, dukm1);
      }
      const int jk = j * N + k;
      fsc[jk] = Ph::rung_terms(gs, T, p, k, amax * a.fan[j], mu, xl, ul, xn1,
                               dxk, duk, dxk1, ukm1, dukm1, fjr[jk],
                               fad + jk * NX);
    });
    blk.sync(kRungTerms);
    blk.each(nf, [&](int j) {
      S cost_t = S(0), cl1_t = S(0), jref_t = S(0);
#pragma unroll 1
      for (int k = 0; k < N; ++k) {
        const int jk = j * N + k;
        for (int i = 0; i < NX; ++i) cl1_t = cl1_t + fad[jk * NX + i];
        cost_t = cost_t + fsc[jk];
        jref_t = jref_t + fjr[jk];
      }
      S xN[NX], dxN[NX], jr;
      load(X, N * NX, NX, xN);
      load(dXs, N * NX, NX, dxN);
      const S aj = amax * a.fan[j];
      const bool pass = Ph::rung_test(p, xN, dxN, N, aj, mu, cost_t, cl1_t,
                                      jref_t, nu_pen_new, m0, ddir, eps_m,
                                      jr);
      T.fan(j, 0) = pass ? S(1) : S(0);
      T.fan(j, 1) = aj;
      T.fan(j, 2) = jr;
    });
    blk.sync(kRungSums);
    // first passing rung in fan order wins
    S alpha_new = S(0), jref_new = jref_old;
    for (int j = 0; j < nf; ++j)
      if (T.fan(j, 0) > S(0.5)) {
        alpha_new = T.fan(j, 1);
        jref_new = T.fan(j, 2);
        break;
      }

    // 0*inf-guarded update: a rejected direction may hold inf/NaN.
    if (alpha_new > S(0)) {
      blk.each((N + 1) * NX,
               [&](int e) { X[e] = X[e] + alpha_new * dXs[e]; });
      blk.each(N * NU, [&](int e) { U[e] = U[e] + alpha_new * dUs[e]; });
    }
    blk.sync(kUpdate);

    nu_pen = nu_pen_new;
    stepn = stepn_i;
    feas = feas_i;
    jref = jref_new;
    alpha = alpha_new;
    if (!a.adaptive) continue;

    // ---- adaptive bookkeeping, uniform over the block (solve_instance's)
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

  // ---- the iterate and the stats to global memory
  const Lane<S> Xg{a.X + b, B}, Ug{a.U + b, B}, stats{a.stats + b, B};
  blk.each((N + 1) * NX, [&](int e) { Xg[e] = X[e]; });
  blk.each(N * NU, [&](int e) { Ug[e] = U[e]; });
  blk.on(0, [&] {
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
