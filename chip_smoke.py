#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA Hopper card (the kernels are built for sm_90a), the CUDA toolkit's
``nvcc`` (``/usr/local/cuda`` or on PATH), and no network.  Phases, one JSON
line each, with the seconds since start in ``t``:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — nvcc builds the five libraries of ``mahi_mpc_tpu_torch/csrc``
   (``fused_sqp.cu``, ``fused_sqp_generic.cu``, ``fused_sqp_models.cu``,
   ``fused_sqp_ltv.cu``: the fused kernel's instantiations; ``riccati.cu``),
   one process each, started together, and g++ the operation counter
   ``flop_count.cpp`` beside them; registers and spill bytes of every
   kernel instantiation from ``-Xptxas -v``; then the main path's
   instantiation alone (``fused_sqp_group_kernel``, four threads an
   instance): its ptxas line and blocks an SM, and the arm under RK4's
   (``Generic<ArmModel<4>>``) beside it; and the Riccati kernel
   (``riccati_group_kernel``, a group of 16 / 8 / 4 threads an instance) at
   each stage shape: its ptxas line, shared memory and blocks an SM (0 B of
   spill stores and >= 2 blocks an SM, or the phase fails);
3. parity — the fused kernel (on the main path its group body) against its
   plain PyTorch version, both on the card, at B=1024 on the 4-DOF
   ``mahi_arm`` (N=25, dt=2 ms, |u| <= 20, float32) with bench-shaped data:
   - adaptive cold solve: statuses agree on >= 99 % of instances, and at
     most 1 % of the converged instances lie beyond |dU| 5e-3 of the plain
     version's float64 solution (the line prints the plain float32
     version's count too);
   - fixed-3 warm solve from the kernel's cold plan: max|dX|, max|dU|
     <= 1e-4;
   then both at the service's batch (B=16384): their times, and the
   fixed-3 warm solves held to max|dX|, max|dU| <= 1e-4 and the adaptive
   cold statuses to >= 99 % agreement there too; the group kernel's bound
   (the function's operations, counted by g++ on a counting scalar,
   ``csrc/flop_count.cpp``: the group body's tally less the work its lanes
   repeat, over the FP32 peak; its bytes over the HBM rate), its roofline
   share, and the bound of the body's own tally beside it; and its times
   at B = 4096, 16384 and 65536 (kernel only, a draw of its own);
4. service — ``BatchModelControl`` on the card at B=16384 with
   ``fixed_warm_iters=3``: one cold step, then 10 warm steps with 0.01 N(0,1)
   state noise and a phase-shifted sinusoid reference (converged_frac >= 0.9
   after the cold and the last warm step; the kernel's launch count rises by
   11), one more step under ``torch.profiler`` (the group kernel's device
   ms by its name, its share of the step, the host-only ms); then a service
   with adaptive warm steps (1 cold + 3 warm); the preparation kernel
   launched once a solve of both (``solve_batch_fused.prepare_launches``
   equal to the kernel's launches); then fused_prepare
   (``fused_prepare_phase``): the preparation kernel's 14 batch-innermost
   inputs bit for bit ``sqp._start``'s and each input's ``movedim(0,
   -1).contiguous()`` on the same card tensors, nonlinear and LTV at
   B=16384 and at B=1 and nonlinear at 65536, from a warm start with NaN
   and +-inf spikes and controls beyond the box; its device ms (the
   profiler) at B=16384 and 65536 against its bytes bound, its wrapper's
   ms and the PyTorch preparation's (CUDA events);
5. parity_fused_ltv — the fused kernel in LTV mode (``mahi_arm``
   frozen at each instance's x0, B=1024) against its plain version, with
   phase 3's rules: adaptive cold statuses agree on >= 99 %, the kernel
   converges on >= 99 %, and at most 1 % of the converged instances lie
   beyond |dU| 5e-3 of the plain float64 solution (every step policy forms
   its defects from the step's increment, so the float32 crawl that once
   left ~1/3 of LTV instances there is gone); fixed-3 warm max|dX|,
   max|dU| <= 1e-4; one LTV iteration of the fused kernel against one of
   the lanes SQP on the Riccati kernel, <= 1e-4;
6. parity_fused_generic — the kernel against its plain version at B=1024
   for ``double_pendulum`` and ``mahi_arm`` under RK4 (the generic nx-row
   path) and ``pendulum`` under Euler (the nq-row path of a closed-form
   model), with phase 3's rules;
7. timing_fused_modes — kernel and plain version at B=16384, the batch of
   the services, for each case of ``TIMED_MODES``: fixed-3 warm solves in
   LTV at (8, 4), (4, 2), (4, 1) and (2, 1), under RK4 (``mahi_arm``,
   ``two_link_arm`` and every closed form), under midpoint (``mahi_arm``)
   and under Euler (``two_link_arm`` and every closed form), each on the
   body ``card_body`` names (four lanes, two lanes or one thread; the
   profiled kernel must be that body's) with its registers, spills and
   blocks an SM, timed (the wrapper by CUDA events, ``ms``, as earlier
   runs timed it; the kernel's own device ms by the profiler,
   ``device_ms``: in LTV the per-solve discretization takes more than the
   kernel) and held to max|dX|, max|dU| <= 1e-4, each with its bound (the
   function's operations, counted by g++ on a counting scalar, over the
   FP32 peak; its bytes over the HBM rate) and roofline share of either
   time; and the kernel's adaptive cold solves, timed;
8. service_ltv — ``BatchModelControl(mahi_arm, is_linear=True,
   fixed_warm_iters=3)`` at B=16384: a relinearization (the linearization
   kernel) and a fused LTV solve (the discretization kernel, then the
   fused kernel) every step, 1 cold + 10 warm steps (converged_frac >= 0.9
   after the cold and the last warm step, 11 fused launches, all in LTV
   mode, 11 launches of each LTV kernel and no call of their plain
   versions), ``relinearize`` timed on the kernel and on the plain version
   in turns, the discretization timed (wrapper and launch), and the last
   warm step again on the same inputs with its frozen point and
   discretization from the plain versions (controls within 1e-4); one
   more step under ``torch.profiler``
   (one launch of the group kernel of ``Ltv``, found by name); then
   service_rk4, ``mahi_arm`` under RK4 at B=16384, 1 cold + 3 warm steps
   (converged_frac >= 0.9, 4 fused launches, all generic) and one profiled
   step (the group kernel of ``Generic``);
   Before phase 5, ltv_kernels: the LTV path's two kernels
   (``solver/linearize.py``, ``csrc/model_linearize.cuh``) against their
   plain versions within 1e-5 of max|.| (``LTV_LINEARIZE_CASES``: the arm,
   the double pendulum, the user chain of phase 23's LTV (6, 3);
   ``LTV_DISCRETE_CASES``: (8, 4) under every integrator, (4, 2) under
   RK4, the generated (6, 3) and (12, 6); B=16384, 16383 (a partial last
   tile), 1, and the kernel's tile T and T + 1), each launch timed at
   B=16384 and at B=1 in turns with its plain version, with its bound,
   tile (threads an instance, instances a tile, shared bytes), registers,
   spills and blocks an SM;
9. parity_riccati — the Riccati kernel against its plain PyTorch version on
   the card, B=1000, N=25: random well-conditioned QPs at (nz, nu) = (12, 4)
   (one instance with an indefinite Huu: NaN there in both, finite
   elsewhere) and (6, 2), and a QP built by ``build_stage_qp`` at a
   bench-shaped ``mahi_arm`` iterate; du, dz at rtol 2e-4 / atol 2e-5; lam
   (computed outside the kernel) at rtol / atol 2e-4 on the stage QP and
   within 1e-2 of max|lam| on the random QPs, whose adjoint recursion
   amplifies float32 roundoff ~1e4-fold at N=25;
10. timing_riccati — at B=16384, N=25: the kernel alone at (12, 4) and
    (6, 2), the batch-leading entry (kernel and multipliers) and the
    lanes-layout entry (permutes and kernel) at (12, 4), the plain version;
    ``bound_ms`` (bytes: the stage QP read and dz, du written once) and
    ``design_bound_ms`` (the bytes this design moves: also the rollout's
    second read of Az, Bz, r and the gains' round trip); the kernel's du,
    dz held to the plain version's as in phase 9 at both timed shapes, and
    at B=16383 on phase 9's random (12, 4) QP (its last block short a
    group, its indefinite instance NaN alone);
11. parity_lanes_vs_fused — the lanes SQP (Riccati kernel) against the
    fused kernel at B=1024 from the lanes cold plan with x0 + 0.01: one
    iteration each, then the adaptive warm lanes solve against fused
    fixed-3 (max|dX|, max|dU| <= 1e-4); and the lanes cold solve with the
    kernel against the scan (statuses equal on >= 99 %; U at rtol 5e-3 /
    atol 5e-4 on >= 99 % of the instances converged in both, for the
    float32 crawl of phase 3; both are also counted against a float64 scan
    solve);
12. service_lanes — ``BatchModelControl(mahi_arm, warm_solver="adaptive")``
    at B=16384, 1 cold + 3 warm steps (converged_frac >= 0.9, Riccati
    launches = the sum over steps of max(iters), no fused launch), then one
    more warm step under ``torch.profiler`` for the Riccati kernel's device
    share, and the wall time of each stage of a lanes iteration;
13. service_double_pendulum — ``double_pendulum`` under RK4 (dt=2 ms,
    N=25, |u| <= 60, B=16384, closed loop on its RK4 step): the default
    ``warm_solver="auto"`` on the card resolves to the fused kernel's
    generic path (launches = steps, no Riccati launch), and
    ``warm_solver="adaptive"`` takes the lanes route (the Riccati kernel at
    (6, 2)), each with the asserts of phase 12;
14. runtime_control — the single-instance runtime on the card:
    ``generate_model`` of the main path's arm (fixed-3 warm options) into a
    temporary directory (it must build ``fused_sqp``), ``ModelControl``
    loaded from it, a cold ``calc_u`` (converged) and 200 warm ``calc_u``
    in closed loop on the arm's Euler plant, started on a sinusoid
    reference (no failure, |q - q_des| < 0.05 rad over the last half), for
    the manifest's fixed-3 and for adaptive warm solves given at load
    time: the fused kernel's launches rise by one a warm ``calc_u``, every
    one on the block body (``solve_batch_fused.body_launches``), and the
    Riccati kernel's not at all; ``calc_u`` p50 / p99 ms and the cold
    solve's seconds.  Then the B=1 fused warm solve (fixed-3 and adaptive)
    held to its plain version on the same inputs (statuses equal, max|dX|,
    |dU| <= 1e-4), the block kernel's device ms a launch at B=1 (profiler,
    50 launches, by its name, ``card_body``'s), the plain version's ms,
    the bound at B=1 and the block body's dependency-chain bound (its
    critical path's operations, ``count_block_path``, x 4 cycles at the
    SM clock ``nvidia-smi`` reports), 20 ``calc_u`` under the profiler
    (host against kernel: one block kernel a call) and a warm ``calc_u``
    split by stage (``calc_u_split``: tensors, params, the batch-innermost
    copies and ctypes set-up, the kernel, the layout back, the status
    rules, the copy back; each ended by a synchronisation); an LTV
    ``ModelControl`` (1 cold + 50 warm, launches in LTV mode, every one on
    the block body, ``Ltv<8, 4>``, the linearization kernel at B=1 every
    call and the discretization kernel every warm solve, no plain version;
    ``calc_u`` p50 / p99 of the solve and of the whole call;
    runtime_ltv_b1: the body ``card_body``
    names at B=1, the B=1 solve, fixed-3 and adaptive, held to the plain
    version, the LTV solve's ms by CUDA events and the block kernel's
    device ms a launch by the profiler, the plain version's ms, the bound
    and the chain bound at B=1); and 1 s of
    ``start_calc`` with the native plan
    server under a 1 kHz ``control_at_time`` reader (``NativePacer``):
    no failure, no stale or placeholder serve, launches = solves - 1;
    then runtime_default_example, the reference's default example
    (``double_pendulum`` under Euler, dt = 2 ms, N = 25) as
    ``examples/model_generate.py`` and ``model_control.py`` run it: 200
    ``calc_u`` at B=1, warm p50 / p99 ms, one fused launch a warm call
    (on the block body), the B=1 solve held to its plain version, the
    block kernel's device ms, the plain version's ms, the bound and the
    chain bound at B=1, and its ``calc_u`` split by stage; then
    block_ladder (``block_ladder_phase``): the body the launcher's rule
    picks for the three hand-written policies with a block body (the arm
    and the double pendulum under Euler, LTV at (8, 4)) at each B of
    ``CROSSOVER_LADDER`` (rungs of ``tools/time_fused_modes.py``'s
    ``BLOCK_LADDER``) and at B=1 with N = 100 and 200, and for a user's
    own model under each generated policy (Van der Pol under RK4, the
    cart-pole's own f and the 4-DOF chain under Euler) at B=1 and at its
    policy's threshold: fixed-3 and adaptive warm solves launched on that
    body and held to the plain version, its device ms, the block kernel's
    registers, spills, shared memory and blocks an SM;
15. service_non_lanes — ``BatchModelControl`` over the arm written as a
    per-instance ``Dynamics`` (no lanes support), B=1024: the
    ``solve_batch`` route, 1 cold + 2 warm steps, converged_frac >= 0.9,
    no kernel launched;
16. trajgen — ``TrajectoryGenerator`` on the card (``solve_batch``, N=40,
    dt=0.05, RK4, tol 1e-6, at most 100 iterations, through
    ``examples/trajectory_library.py``'s generator): its demo (``pendulum``,
    4 waypoints) and a ``double_pendulum`` library (32 rest-to-rest
    waypoints, q uniform in +-0.8 rad from numpy seed 0, |u| <= 60), each
    with ``kkt_backend="auto"`` (the scan: no Riccati launch) and
    ``"pallas"`` (the Riccati kernel at N=40: launched).  Each prints its
    wall seconds, augmented-Lagrangian rounds, iterations, statuses, worst
    endpoint error and RK4 step residual; the demo must end within 1e-3 of
    every waypoint with residuals below 1e-4 on both backends, its two
    backends' trajectories within 1e-3 of each other; on each case's first
    KKT system the kernel agrees with the scan to 1e-4 of max|dz|, |du|.
    The library is printed, not held to the endpoint: at this shape the
    reference's augmented-Lagrangian loop (6 rounds, rho 1e3) ends 1e-2
    from it in float64 too (PERF.md);
17. batch_scenarios — ``examples/batch_scenarios.py`` at its defaults
    (``mahi_arm``, B=4096, 50 steps, RK4 plant on the card) inside
    ``device_trace``, one ``annotate`` region a step: the last solve's
    seconds, converged_frac (>= 0.9 after the cold step), the share
    within 0.05 rad of the goal, one fused launch a step, and the
    exported trace must name the fused kernel and the region;
18. sharded_service — phase 4's fixed-3 service (B=16384, 1 cold + 10
    warm steps) without a mesh, on a mesh of the one card and on a mesh of
    the card twice (two batch shards) at B=16384 and B=16383 (padded by
    one): one fused launch a shard a step, converged_frac >= 0.9 after
    every step, the one-card mesh bitwise the meshless service, the
    two-shard services within 1e-6 with equal statuses; ms per warm step
    of each;
19. sharded_lanes — the lanes route (``warm_solver="adaptive"``) at
    B=1024 over two shards of the card against one (statuses equal, U
    within 2e-4), the Riccati kernel once a shard an SQP iteration;
20. distributed — ``examples/distributed_solve.py`` (B=16384) as two
    processes on the card over gloo, then one over NCCL at world size 1
    with ``scaling_table``: every rank exits 0, the two runs' gathered U
    and statuses agree;
21. pariccati — ``kkt_backend="pariccati"`` against the scan (and the
    dense oracle where small), float64 and float32, at B=1 N=25, B=16
    N=512, trajgen's N=40 QP, N=1000 and B=1024 N=25, with wall ms of the
    scan, pariccati and the Riccati kernel;
22. time_shard — ``solve_lqr_time_sharded`` over the card repeated T = 2
    and 4 at N = 24 and 1000 against the scan, and one SQP ``solve`` with
    the registered backend against ``"riccati"``;
23. generated — the fused kernel's instantiations generated at first use
    (``models/codegen.py``, ``solver/target.py`` ``kernel_target``; their
    nvcc builds start in phase 2 with the others, g++ builds their
    operation counters beside them): user models written as a user writes
    them (``user_dynamics``: a Van der Pol oscillator under RK4 and a
    kinematic unicycle under Euler, first-order; the cart-pole's own f
    with nq = 2 and no closed form, the nq-row step over a generated acc;
    a 4-DOF chain of pendulums coupled by springs, nx = 8, nu = 4, the
    nq-row step with two controls a lane) and LTV at (6, 3) and (12, 6),
    each through ``BatchModelControl`` at
    B=16384 (1 cold + 3 warm steps, its library launched once a step),
    then its fixed-3 warm solve held to the plain version (max|dX|,
    max|dU| <= 1e-4; the user cart-pole also to the hand-written
    FastNq<Cartpole> within 1e-5), timed (wrapper by CUDA events, kernel
    by the profiler), with the bound from the generated build's own
    operation count, its ptxas line, blocks an SM and nvcc seconds, and an
    adaptive cold solve (converged share printed); then
    ``generate_model`` of the Van der Pol model and of the 4-DOF chain (it
    must name the generated library), and ``ModelControl`` through it at
    B=1 on the block body (``card_body`` must name it): a cold and 20 (Van
    der Pol) or 200 (the chain, tracking a sinusoid on its own Euler step)
    warm ``calc_u``, one block launch each, no failure, ``calc_u`` p50 /
    p99 ms; the B=1 solve (fixed-3 and adaptive) held to its plain
    version, the block kernel's device ms (CUDA events and the
    profiler), the plain version's ms, the bound and the chain bound.

Then one line ``{"kernels": [...]}`` (the fused kernel's group body at
B=16384, its block body at B=1 (``fused_sqp_block``: launches of every
warm ``calc_u`` of phase 14, LTV's included, its arm entry's times and
bounds, the B=1 modes (the arm, the default example, LTV) and the
ladder), the Riccati kernel,
one ``fused_sqp_generated:<case>`` entry a phase-23 case, its launches
those of its service, and one ``fused_sqp_generated_block:<case>`` entry
for the block body of each user model ``ModelControl`` runs at B=1, its
launches those warm ``calc_u``; then ``ltv_linearize`` and ``ltv_discrete``, the LTV
path's kernels, their launches those of phases 8, 14 and 23's LTV runs,
their times those of ltv_kernels at B=16384 (and B=1), their tiles, with
the LTV service's and
``ModelControl``'s readings beside them; then ``fused_prepare``, the
preparation kernel, its launches those of phase 4's services, its times
those of fused_prepare) with each kernel's launches on the
main paths (the fused kernel's include phases 17-18's, the Riccati
kernel's phases 16 and 19's), its error against the plain version (for the fused kernel's
modes, the fixed-3 warm solve at B=16384; ``max_abs_err_b1`` at B=1),
both times, its bound (``bound_ms``, ``bound_by``; for the fused kernel
also ``body_bound_ms``, the bound of its body's own tally; for the block
body ``chain_bound_ms``) and ``library_ms`` (null: no
single PyTorch call computes either function); the fused kernel's
``modes`` give each mode's source, launches, times (``ms`` the wrapper's
by CUDA events, as earlier runs report it, and ``device_ms`` the kernel's
by the profiler; the block body's B=1 entries' ``ms`` are the kernel's
device time), bound and share (``share`` of
``ms``, ``device_share`` of ``device_ms``), and the timed modes also the
body the card runs and its threads an instance (``card_body``), their
registers, spills and blocks an SM; then the
``nvidia-smi`` line as it printed it, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
CUDA device it exits 1 and prints no result.
"""

import concurrent.futures
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()

N_NODES = 25
PARITY_BATCH = 1024
SERVICE_BATCH = 16384
WARM_STEPS = 10
ADAPTIVE_WARM_STEPS = 3
RK4_WARM_STEPS = 3                # the RK4 mahi_arm service (phase 8)
COLD_DU_BAND = 5e-3
RICCATI_PARITY_BATCH = 1000       # under one wave of the Riccati kernel
LANES_WARM_STEPS = 3
LADDER = (4096, 16384, 65536)     # the fused kernel's batch ladder
RUNTIME_WARM_CALLS = 200          # warm calc_u a warm shape, B=1
RUNTIME_LTV_CALLS = 50
DEFAULT_EXAMPLE_CALLS = 200       # calc_u of the default example, B=1
THREAD_SECONDS = 1.0
TRACK_BAND = 0.05                 # rad, |q - q_des| in the closed loops
NON_LANES_BATCH = 1024
COUNT_SAMPLE = 32                 # instances whose operations g++ counts
TRAJ_NODES, TRAJ_DT = 40, 0.05    # the trajectory-library example's shape
TRAJ_WAYPOINTS = 32               # the double_pendulum library: 31 segments
# The two KKT backends' demo trajectories (float32, tol 1e-6) may differ by
# this much: the CPU rehearsal with the Riccati kernel's own arithmetic
# (its g++ build) against the scan differed by 5.9e-5.
TRAJ_BACKEND_BAND = 1e-3
# The Riccati kernel against the scan on a trajgen KKT system at N=40,
# relative to the instance's max|dz|, max|du| (the g++ build: 1.0e-5).
TRAJ_KKT_BAND = 1e-4
SCENARIO_STEPS = 50               # examples/batch_scenarios.py's default
# Two shards of one batch against one, and two processes against one: the
# fused solve is per instance, so the plans are expected to agree bit for
# bit; a difference within this band passes and is printed.
SHARD_DU_BAND = 1e-6
# The lanes route over two shards against one (tests/test_parallel.py's
# band: each shard's loop runs to its own slowest instance).
LANES_SHARD_BAND = 2e-4
DIST_TIMEOUT = 300                # seconds a distributed child may take
# NVIDIA's H100 SXM peaks from its datasheet: FP32 outside the tensor cores
# and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(**kw):
    kw["t"] = round(time.perf_counter() - T0, 3)
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def ptxas_summary(report: str) -> list:
    """Registers and spill bytes per kernel from ``-Xptxas -v`` output."""
    out = []
    for block in report.split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        targs = re.search(r"I((?:Li\d+E)+)E", name)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        out.append({
            "kernel": name,
            "template_args": ([int(v) for v in re.findall(r"\d+",
                                                          targs.group(1))]
                              if targs else None),
            "registers": int(regs.group(1)) if regs else None,
            "stack_frame_bytes": int(spill.group(1)) if spill else None,
            "spill_store_bytes": int(spill.group(2)) if spill else None,
            "spill_load_bytes": int(spill.group(3)) if spill else None})
    return out


# Marks of a fused instantiation in its kernel's mangled name: the step
# policy (nq-row under Euler, generic otherwise, or LTV) and the model.
MODEL_MARKS = {"mahi_arm": "ArmModelIfLi4E", "two_link_arm": "ArmModelIfLi2E",
               "pendulum": "8PendulumIf", "cartpole": "8CartpoleIf",
               "double_pendulum": "16TwoLinkPointMassIfLb1E",
               "acrobot": "16TwoLinkPointMassIfLb0E"}


# The fused kernel's entry by the body it runs (``card_body``).
FUSED_ENTRIES = {"block": "fused_sqp_block_kernel",
                 "group": "fused_sqp_group_kernel",
                 "thread": "fused_sqp_kernel"}


def fused_instantiation(builds, prob) -> dict:
    """The kernel the card launches for ``prob`` at full occupancy
    (``card_body``): its body and threads an instance, its ``-Xptxas -v``
    line (registers, spills) from its library's build, and its blocks an
    SM."""
    from mahi_mpc_tpu_torch.solver.fused import card_body
    from mahi_mpc_tpu_torch.solver.target import INTEGRATORS, kernel_target

    body, width = card_body(prob)
    target = kernel_target(prob)
    lib = target.cuda
    if prob.is_linear:
        marks = ("3Ltv", f"IfLi{prob.nx}ELi{prob.nu}E")
    else:
        marks = ("6FastNq" if target.mode == "fast" else "7Generic",
                 "3gen5ModelIf" if target.unit is not None
                 else MODEL_MARKS[prob.dynamics.name])
    entry = f"{len(FUSED_ENTRIES[body])}{FUSED_ENTRIES[body]}"
    found = [k for k in ptxas_summary(builds[lib][1])
             if entry in k["kernel"] and all(m in k["kernel"] for m in marks)]
    check(len(found) == 1, f"{lib}: {len(found)} kernels {entry} {marks}")
    per_sm = builds[lib][0].mpc_fused_blocks_per_sm(
        target.model, prob.nx, prob.nu, INTEGRATORS.index(prob.integrator),
        int(prob.is_linear))
    check(per_sm > 0, f"{lib} {marks}: {per_sm} blocks an SM")
    return dict(card_body=[body, width], library=lib,
                registers=found[0]["registers"],
                spill_store_bytes=found[0]["spill_store_bytes"],
                spill_load_bytes=found[0]["spill_load_bytes"],
                blocks_per_sm=per_sm)


def random_qp(B, N, nz, nu, seed, to):
    """tests/test_pallas_riccati.py:23-44's well-conditioned QP batch, made
    with numpy and handed to ``to`` field by field."""
    import numpy as np

    from mahi_mpc_tpu_torch.solver.stage_qp import StageQP
    rng = np.random.default_rng(seed)

    def spd(n):
        M = rng.standard_normal((B, N, n, n)) * 0.3
        return np.einsum("bnij,bnkj->bnik", M, M) + 2.0 * np.eye(n)

    Az = 0.3 * rng.standard_normal((B, N, nz, nz)) + np.eye(nz)
    Bz = 0.3 * rng.standard_normal((B, N, nz, nu))
    r = 0.1 * rng.standard_normal((B, N, nz))
    Hzz = spd(nz)
    Hzu = 0.1 * rng.standard_normal((B, N, nz, nu))
    Huu = spd(nu)
    gz = rng.standard_normal((B, N, nz))
    gu = rng.standard_normal((B, N, nu))
    HfM = rng.standard_normal((B, nz, nz)) * 0.3
    Hf = np.einsum("bij,bkj->bik", HfM, HfM) + 2.0 * np.eye(nz)
    gf = rng.standard_normal((B, nz))
    return StageQP(*[to(a) for a in (Az, Bz, r, Hzz, Hzu, Huu, gz, gu, Hf,
                                     gf)])


PROFILE_TRIES = 3     # profiled calls when the trace lost a launch's record
# Kernels that open every traced window, ignored by what reads the trace.
# Run after run in one process the profiler loses the first device records
# of a trace, more the more traces the process has taken (PERF.md §6),
# so a window's first operations must be ones nothing counts.
PROFILE_LEAD_OPS = 256
PROFILE_LEAD_KERNEL = "spin_kernel"   # torch.cuda._sleep's


def profile_step(step, kernel, expect=None):
    """One call of ``step`` (a service step) under torch.profiler, after
    one profiled call that warms the profiler up: wall ms (profiler
    overhead included), device ms summed over kernels, the device ms of the
    kernels whose name holds ``kernel`` and their launches, and the
    host-only ms (wall minus device).  Device time 0 means the profiler saw
    no kernel.

    ``expect``: the fused kernel's launches the call makes.  The wrapper's
    count (``solve_batch_fused.launches``) must rise by that much, or the
    phase fails.  Where it did but the trace holds fewer records of
    ``kernel`` (on the H100 the trace has been seen to hold four records
    of a call's five launches), the record was lost, not the launch:
    the call is profiled again, up to PROFILE_TRIES times, and
    ``profiler_short`` lists the counts the short traces held.  The caller
    holds the last trace's count to ``expect``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step()
        torch.cuda.synchronize()
    short = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        before = solve_batch_fused.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD_OPS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and PROFILE_LEAD_KERNEL not in e.key]
        mine = [e for e in kernels if kernel in e.key]
        count = sum(e.count for e in mine)
        if expect is None:
            break
        launched = solve_batch_fused.launches - before
        check(launched == expect,
              f"{kernel}: the wrapper counted {launched} launches in a "
              f"profiled call that makes {expect}")
        if count >= expect:
            break
        short.append(count)
    total = sum(dev_us(e) for e in kernels) / 1e3
    ker = sum(dev_us(e) for e in mine) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return dict(wall_ms=wall_ms, device_ms=total, kernel=kernel,
                kernel_device_ms=ker, kernel_count=count,
                profiler_short=short,
                kernel_share_of_device=ker / total if total else None,
                kernel_share_of_wall=ker / wall_ms,
                host_only_ms=wall_ms - total,
                device_busy_share=total / wall_ms,
                top_kernels=[[e.key[:70], dev_us(e) / 1e3, e.count]
                             for e in top])


def lanes_stage_ms(svc) -> dict:
    """Wall ms (synchronised, mean of 3 after a warm-up call) of each stage
    of one lanes SQP iteration at the service's current plan: the
    linearization in both modes, the QP build, the KKT solve through the
    kernel's batch entry (multipliers included), and one
    line-search rung (a merit evaluation)."""
    import torch

    from mahi_mpc_tpu_torch.solver.batched import (_linearize_lanes,
                                                   _merit_batch)
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch
    from mahi_mpc_tpu_torch.solver.stage_qp import build_stage_qp

    prob, p, X, U = svc.problem, svc._p, svc._X, svc._U
    ones = torch.ones(svc.batch, dtype=X.dtype, device=X.device)

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / reps

    lin, fan_ms = wall(lambda: _linearize_lanes(prob, X, U, "fan"))
    _, rev_ms = wall(lambda: _linearize_lanes(prob, X, U, "rev"))
    qp, qp_ms = wall(lambda: build_stage_qp(prob, X, U, p, 1e-5 * ones,
                                            1e-8 * ones, lin=lin))
    _, kkt_ms = wall(lambda: solve_lqr_kernel_batch(qp))
    _, rung_ms = wall(lambda: _merit_batch(prob, X, U, p, 1e-5 * ones, ones))
    return dict(linearize_fan_ms=fan_ms, linearize_rev_ms=rev_ms,
                build_qp_ms=qp_ms, kkt_batch_entry_ms=kkt_ms,
                line_search_rung_ms=rung_ms)


def lanes_phases(dev, f32, rng, timed, batch_params, warm_schedule, mp, prob,
                 opts, opts_cold, mu_warm, Qw, Rw, Rmw) -> dict:
    """Phases 9-13: the Riccati kernel and the lanes route.  Returns what the
    kernels line reports of the Riccati kernel."""
    import dataclasses

    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
    from mahi_mpc_tpu_torch.models import make_dynamics, rk4_step
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.batched import (_linearize_lanes,
                                                   solve_batch_lanes)
    from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused
    from mahi_mpc_tpu_torch.ops.precision import strict_fp32
    from mahi_mpc_tpu_torch.solver.riccati import LQRSolution, _multipliers
    from mahi_mpc_tpu_torch.solver.riccati_kernel import (
        _launch_cuda, _solve_lqr_kernel_plain, _to_lanes,
        solve_lqr_kernel_batch, solve_lqr_kernel_lanes)
    from mahi_mpc_tpu_torch.solver.stage_qp import StageQP, build_stage_qp
    from mahi_mpc_tpu_torch.transcribe.shooting import MPCParams

    nx, nu, N = prob.nx, prob.nu, prob.N
    sync = torch.cuda.synchronize

    # ---- parity_riccati: kernel vs plain version, both on the card
    Br = RICCATI_PARITY_BATCH
    nan_i = 7
    qp12 = random_qp(Br, N, 12, 4, seed=11, to=f32)
    Huu = qp12.Huu.clone()
    Huu[nan_i, N - 1] = -50.0 * torch.eye(4, device=dev)   # indefinite
    pa = batch_params(Br)
    X = f32(0.2 * rng.standard_normal((Br, N + 1, nx)))
    X[:, 0] = pa.x0
    U = f32(2.0 * rng.standard_normal((Br, N, nu)))
    full = lambda v: torch.full((Br,), v, device=dev)
    arm_qp = build_stage_qp(prob, X, U, pa, full(opts.mu_init), full(1e-8),
                            lin=_linearize_lanes(prob, X, U))
    cases = {"random_12x4": qp12._replace(Huu=Huu),
             "random_6x2": random_qp(Br, N, 6, 2, seed=12, to=f32),
             "stage_qp_mahi_arm": arm_qp}

    def held(phase, name, k, pl, want):
        """Emit and return the line holding the kernel's solution ``k`` to
        the plain ``pl``: non-finite in the instances outside ``want`` and
        only there, in both; du and dz within rtol 2e-4 / atol 2e-5 (lam,
        where ``k`` has it, is only reported: the callers judge it)."""
        sync()
        fin = lambda s: (torch.isfinite(s.du).all(dim=(1, 2))
                         & torch.isfinite(s.dz).all(dim=(1, 2)))
        fk, fp = fin(k), fin(pl)
        check(bool((fk == want).all()) and bool((fp == want).all()),
              f"{phase} {name}: non-finite instances kernel "
              f"{(~fk).nonzero().flatten().tolist()[:20]}, plain "
              f"{(~fp).nonzero().flatten().tolist()[:20]}")
        line = dict(phase=phase, case=name, batch=k.du.shape[0], N=N,
                    nz=k.dz.shape[-1], nu=k.du.shape[-1],
                    nan_instances=int((~fk).sum()))
        for field, rtol, atol in (("du", 2e-4, 2e-5), ("dz", 2e-4, 2e-5),
                                  ("lam", 2e-4, 2e-4)):
            if getattr(k, field) is None:
                continue
            a, b = getattr(k, field)[want], getattr(pl, field)[want]
            err = (a - b).abs()
            line[f"max_abs_{field}"] = err.max().item()
            line[f"band_excess_{field}"] = (err - (atol + rtol * b.abs())
                                            ).max().item()
            line[f"max_abs_{field}_ref"] = b.abs().max().item()
        emit(**line)
        for field in ("du", "dz"):
            check(line[f"band_excess_{field}"] <= 0,
                  f"{phase} {name}: {field} beyond rtol 2e-4 / atol 2e-5")
        return line

    max_err = 0.0
    for name, qp in cases.items():
        want = torch.ones(Br, dtype=torch.bool, device=dev)
        if name == "random_12x4":
            want[nan_i] = False
        line = held("parity_riccati", name, solve_lqr_kernel_batch(qp),
                    _solve_lqr_kernel_plain(qp), want)
        if name == "stage_qp_mahi_arm":
            check(line["band_excess_lam"] <= 0,
                  f"{name}: lam beyond rtol/atol 2e-4")
        else:
            # lam is computed outside the kernel from dz and du; the adjoint
            # recursion through Az = I + 0.3 randn (spectral radius ~2)
            # amplifies their float32 roundoff ~1e4-fold (PERF.md), so it
            # is held normwise here.
            check(line["max_abs_lam"] <= 1e-2 * line["max_abs_lam_ref"],
                  f"{name}: lam beyond 1e-2 of max|lam|")
        max_err = max(max_err, line["max_abs_du"], line["max_abs_dz"])

    # ---- timing_riccati at the service's batch: the kernel alone (its
    # launch and its outputs' allocation) at (12, 4) on the stage QP and at
    # (6, 2) on the random QP; at (12, 4) also the batch-leading entry
    # (kernel, then multipliers), the multipliers alone, the lanes entry
    # (permutes around the kernel) and the plain version.  The kernel's
    # answers at both timed shapes are held to the plain version's, and so
    # is one at B = SERVICE_BATCH - 1 at (12, 4): there the last block runs
    # 7 of its 8 groups, and the random QP's indefinite instance recurs
    # every Br instances, its neighbours finite.
    tile = lambda qp, B: StageQP(*[a[torch.arange(B, device=dev) % Br]
                                   for a in qp])
    qpt, qp62 = (tile(arm_qp, SERVICE_BATCH),
                 tile(cases["random_6x2"], SERVICE_BATCH))
    sol, kernel_ms = timed(lambda: _launch_cuda(qpt), 20)
    sol62, kernel_ms_62 = timed(lambda: _launch_cuda(qp62), 20)
    _, batch_ms = timed(lambda: solve_lqr_kernel_batch(qpt), 10)
    with strict_fp32():
        _, mult_ms = timed(lambda: _multipliers(qpt, *sol), 5)
    lanes_in = tuple(_to_lanes(a) for a in qpt)
    _, lanes_ms = timed(lambda: solve_lqr_kernel_lanes(lanes_in), 10)
    pl, plain_ms = timed(lambda: _solve_lqr_kernel_plain(qpt), 3)
    as_sol = lambda dzdu: LQRSolution(dz=dzdu[0], du=dzdu[1], lam=None)
    all_finite = torch.ones(SERVICE_BATCH, dtype=torch.bool, device=dev)
    tail = SERVICE_BATCH - 1
    qptail = tile(cases["random_12x4"], tail)
    for name, k, pl_, want in (
            ("stage_qp_mahi_arm", as_sol(sol), pl, all_finite),
            ("random_6x2", as_sol(sol62), _solve_lqr_kernel_plain(qp62),
             all_finite),
            ("random_12x4_tail", as_sol(_launch_cuda(qptail)),
             _solve_lqr_kernel_plain(qptail),
             torch.arange(tail, device=dev) % Br != nan_i)):
        line = held("timing_riccati_parity", name, k, pl_, want)
        max_err = max(max_err, line["max_abs_du"], line["max_abs_dz"])
    del pl, qptail

    def bounds(qp):
        """bound_ms: the function's bytes (the stage QP read once, dz and du
        written once) against the multiply-adds of the recursion counted by
        hand per stage (P Az, Az' P Az, P Bz, Bz' P Bz, Az' P Bz, the nu x
        nu solve of nz + 1 columns, the gain update, the rollout), 2 flops
        each; design_bound_ms: the bytes this design moves (also Az, Bz, r
        read again by the rollout, K and kff written and read back)."""
        Bq, Nq, nz, nu = (qp.Az.shape[0], qp.Az.shape[1], qp.Az.shape[2],
                          qp.Bz.shape[-1])
        io = 4 * (sum(a.numel() for a in qp)
                  + Bq * ((Nq + 1) * nz + Nq * nu))
        design = io + 4 * Bq * Nq * (nz * nz + nz * nu + nz
                                     + 2 * (nu * nz + nu))
        macs = (2 * nz ** 3 + 3 * nz ** 2 * nu + nz * nu ** 2
                + nu ** 2 * (nz + 1) + nz * nu + nz ** 2)
        ops = 2.0 * macs * Nq * Bq
        return dict(io_mbytes=io / 1e6, design_mbytes=design / 1e6,
                    ops_hand_count=ops, **bound_ms(ops, io),
                    design_bound_ms=bound_ms(ops, design)["bound_ms"])

    bound, bound62 = bounds(qpt), bounds(qp62)
    emit(phase="timing_riccati", batch=SERVICE_BATCH, N=N, nz=12, nu=4,
         kernel_ms=kernel_ms, batch_entry_ms=batch_ms,
         multipliers_ms=mult_ms, lanes_entry_ms=lanes_ms, plain_ms=plain_ms,
         qp_mbytes=sum(a.numel() for a in qpt) * 4 / 1e6, **bound,
         roofline_share=bound["bound_ms"] / kernel_ms,
         design_share=bound["design_bound_ms"] / kernel_ms)
    emit(phase="timing_riccati", batch=SERVICE_BATCH, N=N, nz=6, nu=2,
         kernel_ms=kernel_ms_62, **bound62,
         roofline_share=bound62["bound_ms"] / kernel_ms_62,
         design_share=bound62["design_bound_ms"] / kernel_ms_62)

    # ---- parity_lanes_vs_fused (tests/test_fused_kernel.py:54-95 on card)
    B = PARITY_BATCH
    p = batch_params(B)
    cold = lambda o: solve_batch_lanes(prob, p, None, None, o,
                                       mu0=o.mu_init)
    r0 = cold(opts_cold)
    p2 = p._replace(x0=p.x0 + 0.01)
    ra = solve_batch_lanes(prob, p2, r0.X, r0.U,
                           SolverOptions(tol=1e-4, max_iter=1), mu0=mu_warm)
    rb = solve_batch_fused(prob, p2, r0.X, r0.U, opts, mu0=mu_warm, n_iter=1)
    rw = solve_batch_lanes(prob, p2, r0.X, r0.U, opts, mu0=mu_warm)
    rf = solve_batch_fused(prob, p2, r0.X, r0.U, opts, mu0=mu_warm, n_iter=3)
    scan = dataclasses.replace(opts_cold, kkt_backend="riccati")
    rs = cold(scan)
    # The float64 scan solve of the same batch: the exact answer against
    # which the float32 crawl (PERF.md section 6) is judged.
    p64 = MPCParams(*[type(f)(*[a.double() for a in f])
                      if isinstance(f, tuple) else f.double() for f in p])
    r64 = solve_batch_lanes(prob, p64, None, None, scan, mu0=scan.mu_init)
    sync()
    dmax = lambda a, b: max((a.X - b.X).abs().max().item(),
                            (a.U - b.U).abs().max().item())
    d1, d3 = dmax(ra, rb), dmax(rw, rf)
    same = (r0.status == rs.status).float().mean().item()
    both = (r0.status == 0) & (rs.status == 0)
    all3 = both & (r64.status == 0)

    def beyond(a, b, mask):
        """Instances of ``mask`` whose U lies beyond rtol 5e-3 / atol 5e-4
        of b's."""
        ua, ub = a.U.double(), b.U.double()
        ex = ((ua - ub).abs() - (5e-4 + 5e-3 * ub.abs()))[mask]
        return int((ex.reshape(-1, N * nu) > 0).any(dim=1).sum())

    n_far = beyond(r0, rs, both)
    emit(phase="parity_lanes_vs_fused", batch=B,
         cold_converged=(r0.status == 0).float().mean().item(),
         cold_mean_iters=r0.iters.float().mean().item(),
         one_iter_max_abs_dxu=d1, warm_max_abs_dxu=d3,
         warm_lanes_iters=[int(rw.iters.min()), int(rw.iters.max())],
         warm_converged_lanes=(rw.status == 0).float().mean().item(),
         warm_converged_fused=(rf.status == 0).float().mean().item(),
         kernel_vs_scan_status_agree=same,
         kernel_vs_scan_n_both_converged=int(both.sum()),
         kernel_vs_scan_max_abs_du=(r0.U - rs.U)[both].abs().max().item(),
         kernel_vs_scan_n_beyond_band=n_far,
         scan_f64_converged=(r64.status == 0).float().mean().item(),
         scan_f64_mean_iters=r64.iters.float().mean().item(),
         n_beyond_band_kernel_vs_scan_f64=beyond(r0, r64, all3),
         n_beyond_band_scan_vs_scan_f64=beyond(rs, r64, all3))
    check(d1 <= 1e-4, f"one lanes iteration vs fused: {d1} > 1e-4")
    check(d3 <= 1e-4, f"warm lanes vs fused fixed-3: {d3} > 1e-4")
    check(same >= 0.99, f"kernel vs scan statuses agree on only {same}")
    # The band holds on >= 99 % of the instances converged in both: the
    # float32 crawl moves ~1 % of cold solves by up to ~1e-2 in U, for the
    # scan as for the kernel (both counts against float64 are printed).
    check(n_far <= 0.01 * int(both.sum()),
          f"kernel vs scan: {n_far} instances beyond rtol 5e-3 / atol 5e-4")

    # ---- the lanes and fused routes through the service, counted
    def route_service(phase, svc, x0, x_des, next_inputs, route="lanes"):
        """1 cold + LANES_WARM_STEPS warm steps with the counts set to 0
        just before; the lanes route launches the Riccati kernel once an
        SQP iteration and never the fused kernel, the fused route the
        generic fused kernel once a step and never the Riccati kernel."""
        if route == "lanes":
            check(svc.warm_solver in ("fixed", "adaptive"),
                  f"{phase}: resolved to {svc.warm_solver}")
            check(svc.kkt_backend == "pallas",
                  f"{phase}: kkt_backend {svc.kkt_backend}")
        else:
            check(svc.warm_solver == "fused",
                  f"{phase}: resolved to {svc.warm_solver}")
        Bs = svc.batch
        svc.set_states(x0)
        svc.set_references(x_des)
        solve_batch_fused.launches = 0
        solve_batch_fused.mode_launches.update(fast=0, generic=0, ltv=0)
        solve_lqr_kernel_batch.launches = 0
        u = svc.step()
        m = svc.metrics()
        loop_iters = int(svc.last.iters.max())
        emit(phase=phase + "_cold", batch=Bs, warm_solver=svc.warm_solver,
             kkt_backend=svc.kkt_backend, cold_s=m["solve_s"],
             converged_frac=m["converged_frac"], mean_iters=m["mean_iters"],
             max_iters=loop_iters)
        check(m["converged_frac"] >= 0.9, f"{phase} cold {m}")
        step_ms, iters = [], []
        for i in range(LANES_WARM_STEPS):
            x, ref = next_inputs(i, u)
            svc.set_states(x, u_prev=u)
            svc.set_references(ref)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            u = svc.step()
            end.record()
            sync()
            step_ms.append(start.elapsed_time(end))
            iters.append(svc.metrics()["mean_iters"])
            loop_iters += int(svc.last.iters.max())
        m = svc.metrics()
        launches = solve_lqr_kernel_batch.launches
        fused = solve_batch_fused.launches
        generic = solve_batch_fused.mode_launches["generic"]
        check(tuple(u.shape) == (Bs, svc.params.num_u)
              and bool(torch.isfinite(u).all()),
              f"{phase}: non-finite or misshapen controls")
        ms = float(np.mean(step_ms))
        emit(phase=phase + "_warm", batch=Bs, warm_steps=LANES_WARM_STEPS,
             ms_per_warm_step=ms, ms_per_warm_step_all=step_ms,
             solves_per_s=Bs / (ms * 1e-3), mean_iters_each=iters,
             converged_frac=m["converged_frac"], max_feas=m["max_feas"],
             riccati_launches=launches, loop_iterations=loop_iters,
             fused_launches=fused, fused_generic_launches=generic)
        check(m["converged_frac"] >= 0.9, f"{phase} warm {m}")
        if route == "lanes":
            check(launches == loop_iters,
                  f"{phase}: {launches} Riccati launches for {loop_iters} "
                  f"SQP iterations")
            check(fused == 0,
                  f"{phase}: the fused kernel launched {fused} times")
            return launches, ms
        check(fused == generic == 1 + LANES_WARM_STEPS and launches == 0,
              f"{phase}: {fused} fused ({generic} generic) and {launches} "
              f"Riccati launches for {1 + LANES_WARM_STEPS} steps")
        return fused, ms

    Bs = SERVICE_BATCH
    svc = BatchModelControl(
        mp, batch=Bs, device=dev,
        opts=SolverOptions(tol=1e-4, max_iter=30, warm_solver="adaptive"),
        Q=Qw, R=Rw, Rm=Rmw)
    x0 = f32(0.2 * rng.standard_normal((Bs, nx)))
    perts, refs = warm_schedule(Bs, LANES_WARM_STEPS)
    l_arm, ms_arm = route_service(
        "service_lanes", svc, x0, f32(0.2 * rng.standard_normal((Bs, N, nx))),
        lambda i, u: (x0 + f32(perts[i]), f32(refs[i])))
    prof = profile_step(svc.step, "riccati_group_kernel")
    emit(phase="service_lanes_profile", batch=Bs, **prof,
         stage_ms=lanes_stage_ms(svc))
    check(prof["kernel_count"] >= 1 and prof["kernel_device_ms"] > 0,
          f"the profiled lanes step ran {prof['kernel_count']} "
          f"riccati_group_kernel launches")

    # ---- double_pendulum under RK4: "auto" (fused, generic path) and
    # "adaptive" (lanes, Riccati kernel at (6, 2)) on the same closed loop
    dpd = make_dynamics("double_pendulum")
    dt = 0.002
    mpd = ModelParameters("dp_svc", num_x=dpd.nx, num_u=dpd.nu,
                          step_size=dt, num_shooting_nodes=N,
                          u_min=[-60.0] * dpd.nu, u_max=[60.0] * dpd.nu,
                          dynamics_name="double_pendulum", integrator="rk4")
    q0 = rng.uniform(-0.5, 0.5, (Bs, 2))
    goals = rng.uniform(-0.5, 0.5, (Bs, 2))
    x_des = np.zeros((Bs, N, 4))
    x_des[:, :, :2] = goals[:, None]
    plant = rk4_step(dpd.f, dt)
    dp = {}
    for phase, warm_solver, route in (
            ("service_double_pendulum", "auto", "fused"),
            ("service_double_pendulum_lanes", "adaptive", "lanes")):
        svc = BatchModelControl(mpd, batch=Bs, device=dev,
                                opts=SolverOptions(tol=1e-4, max_iter=30,
                                                   warm_solver=warm_solver),
                                Q=[10.0, 10.0, 1.0, 1.0], R=[0.1] * dpd.nu,
                                Rm=[0.0] * dpd.nu)
        state = {"x": f32(np.concatenate([q0, np.zeros((Bs, 2))], axis=1))}

        def closed_loop(i, u):
            state["x"] = plant(state["x"].T, u.T).T
            return state["x"], f32(x_des)

        dp[route] = route_service(phase, svc, state["x"], f32(x_des),
                                  closed_loop, route)
        err = (state["x"][:, :2] - f32(goals)).abs().max().item()
        emit(phase=phase + "_state", max_abs_q_minus_goal=err,
             start_max_abs_q_minus_goal=float(np.abs(q0 - goals).max()))
        check(bool(torch.isfinite(state["x"]).all()),
              f"{phase}: double pendulum blew up")
    l_dp = dp["lanes"][0]
    emit(phase="double_pendulum_fused_vs_lanes", batch=Bs,
         fused_ms_per_warm_step=dp["fused"][1],
         lanes_ms_per_warm_step=dp["lanes"][1],
         lanes_over_fused=dp["lanes"][1] / dp["fused"][1])

    return dict(launches=l_arm + l_dp, max_abs_err=max_err, ms=kernel_ms,
                plain_ms=plain_ms, batch_entry_ms=batch_ms,
                multipliers_ms=mult_ms, lanes_entry_ms=lanes_ms,
                ms_6x2=kernel_ms_62, bound_ms_6x2=bound62["bound_ms"],
                design_bound_ms_6x2=bound62["design_bound_ms"],
                dp_fused_launches=dp["fused"][0], **bound)


def model_batch(dev, rng, name, B, integrator="euler", is_linear=False,
                N=N_NODES):
    """(ModelParameters, problem, params) of ``name`` at N (25), dt=2 ms with
    bench-shaped data: |u| <= 20 for ``mahi_arm`` and 60 otherwise, Q =
    [10]*nq + [1]*nq, R = 0.1, Rm = 0.01, x0 and x_des ~ 0.2 N(0, 1); LTV
    problems frozen at each instance's (x0, u_prev)."""
    import numpy as np
    import torch
    from torch.func import vmap

    from mahi_mpc_tpu_torch import ModelParameters
    from mahi_mpc_tpu_torch.models import make_dynamics
    from mahi_mpc_tpu_torch.ops.precision import strict_fp32
    from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                        default_params,
                                                        make_problem)

    dyn = make_dynamics(name)
    nx, nu, nq = dyn.nx, dyn.nu, dyn.nq
    ulim = 20.0 if name == "mahi_arm" else 60.0
    mp = ModelParameters(f"smoke_{name}", num_x=nx, num_u=nu,
                         step_size=0.002, num_shooting_nodes=N,
                         u_min=[-ulim] * nu, u_max=[ulim] * nu,
                         dynamics_name=name, integrator=integrator,
                         is_linear=is_linear)
    prob = make_problem(mp, dyn)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    p = default_params(mp, device=dev)._replace(
        q=f32([10.0] * nq + [1.0] * nq), r=f32([0.1] * nu),
        rm=f32([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=f32(0.2 * rng.standard_normal((B, nx))),
                   x_des=f32(0.2 * rng.standard_normal((B, N, nx))))
    if is_linear:
        with strict_fp32():
            A, Bm, xd0 = vmap(dyn.linearize)(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return mp, prob, p


def bound_ms(ops, nbytes) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def fused_io_bytes(p, X0, U0, B) -> int:
    """Bytes the fused solve must move: each input (plan, reference,
    weights, bounds, mu) read once, X, U and the 8 stats written once."""
    per = (X0[0].numel() + U0[0].numel()
           + sum(t[0].numel() for t in (p.x_des, p.q, p.r, p.rm, p.u_prev,
                                         p.u_min, p.u_max, p.x_min, p.x_max,
                                         p.qf, p.xf_des)) + 1)
    return 4 * B * (per + X0[0].numel() + U0[0].numel() + 8)


def head(p, n):
    """The first n instances of MPCParams p."""
    return type(p)(*[type(f)(*[a[:n] for a in f]) if isinstance(f, tuple)
                     else (None if f is None else f[:n]) for f in p])


def to_f64(p):
    """MPCParams in float64 (the plain version's exact reference)."""
    return type(p)(*[type(f)(*[a.double() for a in f])
                     if isinstance(f, tuple) else f.double() for f in p])


# Phase 7's cases (model, integrator, LTV) at B=16384: every instantiation
# of the fused kernel but the main path's (timed in phase 3): LTV at every
# (nx, nu) of the registered models, the generic path of the arms and of
# every closed form under RK4 (and of the 4-DOF arm under midpoint), and
# the nq-row path of the 2-DOF arm and of every closed form under Euler.
TIMED_MODES = (("mahi_arm", "euler", True), ("double_pendulum", "rk4", False),
               ("mahi_arm", "rk4", False), ("mahi_arm", "midpoint", False),
               ("double_pendulum", "euler", True), ("cartpole", "euler", True),
               ("pendulum", "euler", True), ("two_link_arm", "rk4", False),
               ("two_link_arm", "euler", False),
               *((name, integrator, False)
                 for integrator in ("euler", "rk4")
                 for name in ("pendulum", "cartpole", "double_pendulum",
                              "acrobot")
                 if (name, integrator) != ("double_pendulum", "rk4")))


# The LTV path's kernels (solver/linearize.py): each held to its plain
# version within LTV_BAND of max|.| (float32), at B=16384 and B=1.  The
# linearization of the 4-DOF arm, the double pendulum and a user's model
# (the chain of phase 23's LTV (6, 3), from its generated LTV unit); the
# discretization at (8, 4) under every integrator, the double pendulum's
# (4, 2) under RK4 and the generated (6, 3) and (12, 6).
LTV_BAND = 1e-5
LTV_LINEARIZE_CASES = ("mahi_arm", "double_pendulum", "ltv_6x3")
LTV_DISCRETE_CASES = (("mahi_arm", "euler"), ("mahi_arm", "midpoint"),
                      ("mahi_arm", "rk4"), ("double_pendulum", "rk4"),
                      ("ltv_6x3", "euler"), ("ltv_12x6", "rk4"))
LTV_KERNEL_REPS = 50
# The LTV kernels' launches on the main paths (the LTV service, the LTV
# ModelControl, phase 23's generated LTV services), and what the LTV
# service's phase measured of them; the kernels line reports both.
LTV_PATH = {"linearize_launches": 0, "ltv_discrete_launches": 0}


def ltv_counts() -> tuple:
    """(linearization launches, discretization launches, plain
    linearizations, plain discretizations) so far."""
    from mahi_mpc_tpu_torch.solver.linearize import (linearize_batch,
                                                     linearize_batch_plain,
                                                     ltv_discrete,
                                                     ltv_discrete_plain)
    return (linearize_batch.launches, ltv_discrete.launches,
            linearize_batch_plain.calls, ltv_discrete_plain.calls)


def ltv_kernel_event_ms(call, reps=LTV_KERNEL_REPS) -> float:
    """Device ms of one launch of the LTV kernel that ``call()`` launches
    once: its launcher repeated ``reps`` times back to back between two CUDA
    events with the arguments ready (after one warm-up), then once more as
    the call's own; the host's preparation is not in the time."""
    import torch

    from mahi_mpc_tpu_torch.solver import linearize as lz

    got, real = [], (lz._linearize_call, lz._discrete_call)

    def wrap(inner):
        def patched(fn, *a):
            def timed_fn(*args):
                fn(*args)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn(*args)
                end.record()
                torch.cuda.synchronize()
                got.append(start.elapsed_time(end) / reps)
                return fn(*args)
            return inner(timed_fn, *a)
        return patched

    lz._linearize_call, lz._discrete_call = map(wrap, real)
    try:
        call()
    finally:
        lz._linearize_call, lz._discrete_call = real
    check(len(got) == 1, f"{len(got)} LTV launches timed in one call")
    return got[0]


def ltv_case(dev, rng, name, B, integrator="euler"):
    """(Dynamics, problem, params) of an LTV case at B instances frozen at
    each instance's (x0, u_prev) by the plain version: a registered model
    (``model_batch``) or a phase-23 chain (``generated_batch``)."""
    if name.startswith("ltv_"):
        from mahi_mpc_tpu_torch.transcribe.shooting import make_problem
        prob, p = generated_batch(dev, rng, name, B)
        mp, _ = user_problem(name, *user_dynamics()[name])
        mp = dataclasses.replace(mp, integrator=integrator)
        prob = make_problem(mp, prob.dynamics)
    else:
        _, prob, p = model_batch(dev, rng, name, B, integrator, True)
    return prob.dynamics, prob, p


def ltv_ptxas(builds, library, mark) -> dict:
    """The float instantiation of an LTV kernel (``mark``: its mangled
    name's start and template arguments) in ``library``'s ptxas report."""
    hit = [k for k in ptxas_summary(builds[library][1])
           if k["kernel"].startswith(mark)]
    check(len(hit) == 1, f"{library}: {len(hit)} kernels {mark}")
    return {k: hit[0][k] for k in ("kernel", "registers",
                                   "spill_store_bytes", "spill_load_bytes")}


def ltv_kernel_phase(dev, rng, timed, builds, gen_libs) -> dict:
    """The LTV path's two kernels alone (``ltv_kernels``): each held to its
    plain version (``LTV_*_CASES`` at B=16384, B=16383 (a partial last
    tile), B=1, and at the kernel's tile T and T + 1), its launch timed at
    B=16384 and at B=1 (CUDA events around the launcher,
    ``ltv_kernel_event_ms``) in turns with the plain version, the
    wrapper's ms, the bound (the function's operations, counted by g++ on
    a counting scalar over COUNT_SAMPLE instances less what the tasks
    repeat, over the FP32 peak; the tasks' own count beside it; its bytes,
    each input read and each output written once, over the HBM rate), its
    tile (instances, threads an instance, threads and shared bytes a
    block), registers, spills and blocks an SM.  Returns the kernels
    line's numbers of both."""
    import numpy as np

    from mahi_mpc_tpu_torch.solver.linearize import (
        count_linearize_ops, count_ltv_discrete_ops, linearize_batch,
        linearize_batch_plain, linearize_tile, ltv_discrete,
        ltv_discrete_plain, ltv_discrete_tile)
    from mahi_mpc_tpu_torch.solver.target import kernel_target, model_kernel

    def errs(got, want):
        """(max |got - want|, the same over max|want|), each output's worst"""
        d = [((g - w).abs().max().item(), w.abs().max().item())
             for g, w in zip(got, want)]
        return max(a for a, _ in d), max(a / m for a, m in d)

    out = {"linearize": {"cases": []}, "ltv_discrete": {"cases": []}}
    batches = lambda T: (SERVICE_BATCH, SERVICE_BATCH - 1, 1, T, T + 1)
    for name in LTV_LINEARIZE_CASES:
        T = linearize_tile(ltv_case(dev, rng, name, 1)[0])["instances"]
        for B in batches(T):
            dyn, prob, p = ltv_case(dev, rng, name, B)
            lib = model_kernel(dyn).library
            if name.startswith("ltv_"):
                check(lib == gen_libs[name] == kernel_target(prob).cuda,
                      f"{name}: linearization in {lib}, not its LTV unit")
            ab, err = errs(linearize_batch(dyn, p.x0, p.u_prev),
                           linearize_batch_plain(dyn, p.x0, p.u_prev))
            out["linearize"]["cases"].append(dict(
                model=name, batch=B, library=lib, max_abs_err=ab,
                max_rel_err=err))
            check(err <= LTV_BAND, f"linearization {name} B={B}: {err}")
    for name, integrator in LTV_DISCRETE_CASES:
        T = ltv_discrete_tile(ltv_case(dev, rng, name, 1, integrator)[1])[
            "instances"]
        for B in batches(T):
            _, prob, p = ltv_case(dev, rng, name, B, integrator)
            got = ltv_discrete(prob, p)
            ab, err = errs(got, ltv_discrete_plain(prob, p))
            out["ltv_discrete"]["cases"].append(dict(
                model=name, integrator=integrator, shape=[prob.nx, prob.nu],
                batch=B, library=kernel_target(prob).cuda, max_abs_err=ab,
                max_rel_err=err))
            check(err <= LTV_BAND and all(
                g.movedim(0, -1).is_contiguous() for g in got),
                f"discretization {name} {integrator} B={B}: {err}")
    for kind in out:
        for key in ("max_abs_err", "max_rel_err"):
            out[kind][key] = max(c[key] for c in out[kind]["cases"])

    # timed at the LTV service's batch and shape, the 4-DOF arm under
    # Euler, and at B=1 (the LTV single robot's)
    Bt, S = SERVICE_BATCH, COUNT_SAMPLE
    dyn, prob, p = ltv_case(dev, rng, "mahi_arm", Bt)
    _, prob1, p1 = ltv_case(dev, rng, "mahi_arm", 1)
    nx, nu = prob.nx, prob.nu
    calls = {
        "linearize": lambda: linearize_batch(dyn, p.x0, p.u_prev),
        "linearize_plain": lambda: linearize_batch_plain(dyn, p.x0, p.u_prev),
        "ltv_discrete": lambda: ltv_discrete(prob, p),
        "ltv_discrete_plain": lambda: ltv_discrete_plain(prob, p),
        "linearize_b1": lambda: linearize_batch(dyn, p1.x0, p1.u_prev),
        "linearize_plain_b1": lambda: linearize_batch_plain(dyn, p1.x0,
                                                            p1.u_prev),
        "ltv_discrete_b1": lambda: ltv_discrete(prob1, p1),
        "ltv_discrete_plain_b1": lambda: ltv_discrete_plain(prob1, p1)}
    reps = {"linearize_plain": 2, "ltv_discrete_plain": 5,
            "linearize_plain_b1": 2, "ltv_discrete_plain_b1": 5}
    turns = {k: [] for k in calls}
    for plain in (False, True, True, False):  # kernel, plain, plain, kernel
        for k, call in calls.items():
            if ("plain" in k) == plain:
                turns[k].append(timed(call, reps.get(k, 20))[1] if plain
                                else ltv_kernel_event_ms(call))
    wrap_lin = timed(calls["linearize"], 20)[1]
    wrap_dis = timed(calls["ltv_discrete"], 20)[1]
    lin_ops = count_linearize_ops(dyn, p.x0[:S], p.u_prev[:S])
    dis_ops = count_ltv_discrete_ops(prob, head(p, S))
    lin_bytes = 4 * Bt * ((nx + nu) + (nx * nx + nx * nu + nx))
    dis_bytes = 4 * Bt * ((nx * nx + nx * nu + 2 * nx + nu)
                          + (nx * nx + nx * nu + nx))
    marks = {"linearize": ("fused_sqp",
                           "_Z21linearize_tile_kernelIfN3mpc8ArmModelIfLi4E",
                           linearize_tile(dyn)),
             "ltv_discrete": ("fused_sqp_ltv",
                              "_Z24ltv_discrete_tile_kernelIfLi8ELi4E",
                              ltv_discrete_tile(prob))}
    for kind, ops, nbytes, wrapper in (("linearize", lin_ops, lin_bytes,
                                        wrap_lin),
                                       ("ltv_discrete", dis_ops, dis_bytes,
                                        wrap_dis)):
        library, mark, tile = marks[kind]
        k = out[kind]
        k.update(batch=Bt, ms=float(np.mean(turns[kind])),
                 ms_turns=turns[kind],
                 plain_ms=float(np.mean(turns[kind + "_plain"])),
                 plain_ms_turns=turns[kind + "_plain"], wrapper_ms=wrapper,
                 ms_b1=float(np.mean(turns[kind + "_b1"])),
                 ms_b1_turns=turns[kind + "_b1"],
                 plain_ms_b1=float(np.mean(turns[kind + "_plain_b1"])),
                 ops_per_instance=sum(ops["minimum"].values()) / S,
                 ops_by_kind=ops["minimum"],
                 ops_per_instance_body=sum(ops["body"].values()) / S,
                 io_mbytes=nbytes / 1e6,
                 **bound_ms(sum(ops["minimum"].values()) / S * Bt, nbytes),
                 **ltv_ptxas(builds, library, mark), tile=tile,
                 blocks_per_sm=tile["blocks_per_sm"])
        k["share"] = k["bound_ms"] / k["ms"]
        emit(phase="ltv_kernels", entry=kind,
             **{key: v for key, v in k.items() if key != "cases"},
             cases=k["cases"])
    # the largest generated shape: (12, 6) under RK4 in its own library
    out["ltv_discrete"]["ptxas_12x6"] = dict(
        **ltv_ptxas(builds, gen_libs["ltv_12x6"],
                    "_Z24ltv_discrete_tile_kernelIfLi12ELi6E"),
        tile=ltv_discrete_tile(ltv_case(dev, rng, "ltv_12x6", 1, "rk4")[1]))
    emit(phase="ltv_kernels_12x6", **out["ltv_discrete"]["ptxas_12x6"])
    return out


def prepare_bytes(nx, nu, N) -> int:
    """Bytes the preparation kernel must move an instance
    (``csrc/fused_prepare.cuh``): 2 N nx + N nu + 6 nx + 5 nu words read
    (X rows 1..N, U, x_des, the vectors and x0) and (2N + 6) nx + (N + 5)
    nu + 1 written (FusedArgs' 14 inputs)."""
    read = 2 * N * nx + N * nu + 6 * nx + 5 * nu
    written = (2 * N + 6) * nx + (N + 5) * nu + 1
    return 4 * (read + written)


def fused_prepare_phase(dev, rng, timed) -> dict:
    """fused_prepare: the preparation kernel (``csrc/fused_prepare.cuh``,
    ``fused._prepare_cuda``) at the main path's shapes (the 4-DOF arm, N =
    25), nonlinear and LTV at B=16384 and at B=1, from a warm start with
    NaN and +-inf spikes and controls beyond the box: its 14 batch-innermost
    inputs bit for bit ``sqp._start``'s with each input's ``movedim(0,
    -1).contiguous()`` on the same card tensors; its device ms by the
    profiler at B=16384 and 65536 against the bytes bound
    (``prepare_bytes``), and the PyTorch preparation's ms (CUDA events)
    beside the kernel's wrapper's.  Returns the kernels line's entry but
    its launches."""
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.solver import fused as fused_mod
    from mahi_mpc_tpu_torch.solver.sqp import _start

    opts = SolverOptions(tol=1e-4, max_iter=12)
    mu0 = opts.warm_mu_factor * opts.tol
    fan = fused_mod.LS_FAN_FIXED

    def same_bits(a, b):
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
            a[~nan].view(torch.int32), b[~nan].view(torch.int32)))

    def warm_start(prob, B):
        g = torch.Generator(device=dev).manual_seed(B + prob.is_linear)
        spike = lambda t: torch.where(
            torch.rand(t.shape, generator=g, device=dev) < 0.02,
            torch.tensor([float("nan"), float("inf"), -float("inf")],
                         device=dev)[torch.randint(0, 3, t.shape, generator=g,
                                                   device=dev)], t)
        X0 = spike(0.5 * torch.randn(B, prob.N + 1, prob.nx, generator=g,
                                     device=dev))
        U0 = spike(30.0 * torch.randn(B, prob.N, prob.nu, generator=g,
                                      device=dev))
        return X0, U0

    def plain(prob, p, X0, U0):
        X, U, mu = _start(prob, p, X0, U0, opts, mu0)
        return [t.movedim(0, -1).contiguous() for t in (
            X, U, p.x_des, p.q, p.r, p.rm, p.u_prev, p.u_min, p.u_max,
            p.x_min, p.x_max, p.qf, p.xf_des, mu)]

    def card(prob, p, X0, U0):
        (_, ws), _ = fused_mod._prepare_cuda(prob, opts, p, X0, U0, mu0, fan)
        return ws.ins

    held, times = [], {}
    for B in (16384, 1, 65536):
        for is_linear in (False, True):
            if B == 65536 and is_linear:
                continue
            _, prob, p = model_batch(dev, rng, "mahi_arm", B,
                                     is_linear=is_linear)
            X0, U0 = warm_start(prob, B)
            got, want = card(prob, p, X0, U0), plain(prob, p, X0, U0)
            bad = [k for k, (a, b) in enumerate(zip(got, want))
                   if not same_bits(a, b)]
            moved = not same_bits(got[1], U0.movedim(0, -1).contiguous())
            held.append(dict(batch=B, ltv=is_linear, fields_differing=bad,
                             clip_moved_u=moved))
            check(bad == [] and moved,
                  f"fused_prepare B={B} ltv={is_linear}: fields {bad} differ "
                  f"from the PyTorch preparation (clip moved U: {moved})")
            if is_linear or B == 1:
                continue
            reps = 50
            prof = profile_step(lambda: [card(prob, p, X0, U0)
                                         for _ in range(reps)],
                                "fused_prepare_tile_kernel")
            check(prof["kernel_count"] == reps,
                  f"fused_prepare B={B}: {prof['kernel_count']} kernel "
                  f"records for {reps} launches")
            _, wrapper_ms = timed(lambda: card(prob, p, X0, U0), reps)
            _, plain_ms = timed(lambda: plain(prob, p, X0, U0), reps)
            bound = bound_ms(0, B * prepare_bytes(prob.nx, prob.nu, prob.N))
            ms = prof["kernel_device_ms"] / reps
            times[B] = dict(device_ms=ms, wrapper_ms=wrapper_ms,
                            plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                            bound_by=bound["bound_by"],
                            share=bound["bound_ms"] / ms)
    emit(phase="fused_prepare", held=held,
         bytes_per_instance=prepare_bytes(8, 4, N_NODES), **{
             f"b{B}": t for B, t in times.items()})
    t, t64 = times[SERVICE_BATCH], times[65536]
    return {
        "name": "fused_prepare",
        "route": "cuda",
        "source": "mahi_mpc_tpu_torch/csrc/fused_prepare.cuh",
        "replaces": "mahi_mpc_tpu/solver/fused.py:910-932",
        "max_abs_err": 0.0,
        "ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "batch": SERVICE_BATCH,
        "mode": "mahi_arm N=25 at B=16384: the interior clip, the barrier "
                "start and the batch-innermost layout, 16 instances a block",
        "share": t["share"],
        "wrapper_ms": t["wrapper_ms"],
        "ms_65536": t64["device_ms"], "bound_ms_65536": t64["bound_ms"],
        "share_65536": t64["share"],
        "held_bitwise": [[h["batch"], h["ltv"]] for h in held]}


def fused_mode_phases(dev, rng, timed, warm_schedule, builds) -> list:
    """Phases 5-8: the fused kernel's LTV, generic and closed-form paths.
    ``builds``: the CUDA libraries and their ptxas reports.  Returns the
    kernels line's entries for those modes, one a case of ``TIMED_MODES``
    and the B=1024 nq-row parity."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.batched import solve_batch_lanes
    from mahi_mpc_tpu_torch.solver.fused import _launch_cuda, _prepare_cuda
    from mahi_mpc_tpu_torch.solver.fused import _solve as fused_solve
    from mahi_mpc_tpu_torch.solver.fused import (card_body, count_fused_ops,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)
    from mahi_mpc_tpu_torch.solver.linearize import (linearize_batch_plain,
                                                     ltv_discrete,
                                                     ltv_discrete_plain)
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch
    from mahi_mpc_tpu_torch.transcribe.shooting import LinPoint

    opts = SolverOptions(tol=1e-4, max_iter=12)
    opts_cold = SolverOptions(tol=1e-4, max_iter=30)
    mu_warm = opts.warm_mu_factor * opts.tol
    sync = torch.cuda.synchronize

    def service_profile(phase, svc, step_policy):
        """One more service step under the profiler: the group kernel of
        ``step_policy`` found by name, launched once, and its device ms."""
        prof = profile_step(svc.step, "fused_sqp_group_kernel", 1)
        mine = [k for k in prof["top_kernels"] if "fused_sqp" in k[0]]
        emit(phase=phase, batch=svc.batch, **prof)
        check(prof["kernel_count"] == 1 and prof["kernel_device_ms"] > 0
              and bool(mine) and step_policy in mine[0][0],
              f"{phase}: {prof['kernel_count']} fused_sqp_group_kernel "
              f"launches, kernels {prof['top_kernels']}")
        return dict(kernel=mine[0][0],
                    kernel_device_ms=prof["kernel_device_ms"])

    cold = lambda solve, prob, p: solve(prob, p, None, None, opts_cold,
                                        mu0=opts_cold.mu_init, adaptive=True)
    warm3 = lambda solve, prob, p, r: solve(
        prob, p._replace(x0=p.x0 + 0.01), r.X, r.U, opts, mu0=mu_warm,
        n_iter=3)
    frac = lambda m: m.float().mean().item()

    def parity(phase, name, integrator, is_linear):
        """Cold adaptive kernel vs plain (float32 and float64), then fixed-3
        warm from the kernel's plan; returns the line and the results."""
        _, prob, p = model_batch(dev, rng, name, PARITY_BATCH, integrator,
                                 is_linear)
        rk, rp = cold(solve_batch_fused, prob, p), \
            cold(solve_batch_fused_plain, prob, p)
        r64 = cold(solve_batch_fused_plain, prob, to_f64(p))
        wk, wp = warm3(solve_batch_fused, prob, p, rk), \
            warm3(solve_batch_fused_plain, prob, p, rk)
        sync()
        both = (rk.status == 0) & (rp.status == 0) & (r64.status == 0)
        du = lambda a: (a.U.double() - r64.U).abs().amax(dim=(1, 2))[both]
        dk, dp = du(rk), du(rp)
        warm_err = max((wk.X - wp.X).abs().max().item(),
                       (wk.U - wp.U).abs().max().item())
        line = dict(
            phase=phase, model=name, integrator=integrator,
            is_linear=is_linear, batch=PARITY_BATCH,
            status_agree=frac(rk.status == rp.status),
            converged_kernel=frac(rk.status == 0),
            converged_plain=frac(rp.status == 0),
            converged_plain_f64=frac(r64.status == 0),
            mean_iters_kernel=frac(rk.iters),
            mean_iters_plain=frac(rp.iters),
            mean_iters_plain_f64=frac(r64.iters),
            n_all_converged=int(both.sum()),
            max_abs_du_kernel_vs_plain_f64=dk.max().item(),
            max_abs_du_plain_vs_plain_f64=dp.max().item(),
            n_beyond_5e3_kernel_vs_plain_f64=int((dk > COLD_DU_BAND).sum()),
            n_beyond_5e3_plain_vs_plain_f64=int((dp > COLD_DU_BAND).sum()),
            warm_max_abs_dxu=warm_err,
            warm_converged_kernel=frac(wk.status == 0))
        emit(**line)
        what = f"{phase} {name} {integrator}"
        check(line["status_agree"] >= 0.99,
              f"{what}: statuses agree on {line['status_agree']}")
        check(line["converged_kernel"] >= 0.99,
              f"{what}: kernel converged {line['converged_kernel']}")
        far = line["n_beyond_5e3_kernel_vs_plain_f64"]
        check(far <= 0.01 * line["n_all_converged"],
              f"{what}: {far} instances beyond |dU| {COLD_DU_BAND} of f64")
        check(warm_err <= 1e-4, f"{what}: fixed-3 warm {warm_err} > 1e-4")
        return line, prob, p, rk

    # ---- parity_fused_ltv: held to float64 like every mode (the increment
    # form keeps the float32 crawl out of LTV too)
    _, prob, p, rk = parity("parity_fused_ltv", "mahi_arm", "euler", True)
    p2 = p._replace(x0=p.x0 + 0.01)
    ra = solve_batch_lanes(prob, p2, rk.X, rk.U,
                           SolverOptions(tol=1e-4, max_iter=1), mu0=mu_warm)
    rb = solve_batch_fused(prob, p2, rk.X, rk.U, opts, mu0=mu_warm, n_iter=1)
    sync()
    one = max((ra.X - rb.X).abs().max().item(),
              (ra.U - rb.U).abs().max().item())
    emit(phase="parity_fused_ltv_vs_lanes", batch=PARITY_BATCH,
         one_iter_max_abs_dxu=one)
    check(one <= 1e-4, f"one LTV iteration fused vs lanes: {one} > 1e-4")

    # ---- parity_fused_generic
    gen = {}
    for name, integrator in (("double_pendulum", "rk4"), ("mahi_arm", "rk4"),
                             ("pendulum", "euler")):
        gen[name, integrator] = parity("parity_fused_generic", name,
                                       integrator, False)[0]

    # ---- timing_fused_modes at the service's batch
    Bt = SERVICE_BATCH
    times = {}
    for name, integrator, is_linear in TIMED_MODES:
        _, prob, p = model_batch(dev, rng, name, Bt, integrator, is_linear)
        kernel_of = fused_instantiation(builds, prob)
        ct, cold_ms = timed(lambda: cold(solve_batch_fused, prob, p), 2)
        wk, warm_ms = timed(lambda: warm3(solve_batch_fused, prob, p, ct),
                            10)
        wp, plain_ms = timed(lambda: warm3(solve_batch_fused_plain, prob, p,
                                           ct), 1)
        err = max((wk.X - wp.X).abs().max().item(),
                  (wk.U - wp.U).abs().max().item())
        # the kernel's own device time a launch (the events above time the
        # wrapper: in LTV the per-solve discretization `_ltv_discrete`, a
        # vmapped jacfwd, takes more than the kernel)
        prof = profile_step(lambda: [warm3(solve_batch_fused, prob, p, ct)
                                     for _ in range(5)], "fused_sqp", 5)
        check(prof["kernel_count"] == 5,
              f"{name} {integrator}: {prof['kernel_count']} kernel launches "
              f"for 5 solves")
        device_ms = prof["kernel_device_ms"] / 5
        # the bound: the function's operations (the one-thread body's
        # tally less what it repeats; g++ on a counting scalar, the first
        # COUNT_SAMPLE instances of these inputs) and the bytes of the
        # inputs (the streamed Ad - I, Bd, cd too) and outputs; the tally
        # of the body the card runs gives body_bound_ms
        S = COUNT_SAMPLE
        counted = count_fused_ops(prob, head(p._replace(x0=p.x0 + 0.01), S),
                                  ct.X[:S], ct.U[:S], opts, mu0=mu_warm,
                                  n_iter=3, body=card_body(prob)[0])
        ops, body_ops = counted["minimum"], counted["body"]
        nx, nu = prob.nx, prob.nu
        io = fused_io_bytes(p, ct.X, ct.U, Bt) + (
            4 * Bt * (nx * nx + nx * nu + nx) if is_linear else 0)
        bound = bound_ms(sum(ops.values()) / S * Bt, io)
        body_bound = bound_ms(sum(body_ops.values()) / S * Bt, io)
        times[name, integrator, is_linear] = line = dict(
            phase="timing_fused_modes", model=name, integrator=integrator,
            is_linear=is_linear, batch=Bt, **kernel_of,
            fixed3_warm_kernel_ms=warm_ms,
            fixed3_warm_plain_ms=plain_ms, fixed3_warm_max_abs_dxu=err,
            fixed3_warm_status_agree=frac(wk.status == wp.status),
            adaptive_cold_kernel_ms=cold_ms,
            adaptive_cold_converged=frac(ct.status == 0),
            adaptive_cold_mean_iters=frac(ct.iters),
            fixed3_ops_per_instance=sum(ops.values()) / S,
            fixed3_ops_by_kind=ops,
            fixed3_body_ops_per_instance=sum(body_ops.values()) / S,
            io_mbytes=io / 1e6,
            fixed3_warm_bound_ms=bound["bound_ms"],
            fixed3_warm_bound_by=bound["bound_by"],
            fixed3_warm_roofline_share=bound["bound_ms"] / warm_ms,
            fixed3_warm_kernel_device_ms=device_ms,
            fixed3_warm_device_roofline_share=bound["bound_ms"] / device_ms,
            kernel=[k[0] for k in prof["top_kernels"]
                    if "fused_sqp" in k[0]][0],
            fixed3_warm_body_bound_ms=body_bound["bound_ms"])
        emit(**line)
        check(err <= 1e-4, f"B={Bt} {name} {integrator} is_linear="
                           f"{is_linear}: fixed-3 warm {err} > 1e-4")
        # the launcher's body is the one `card_body` names
        check(("fused_sqp_group_kernel" in line["kernel"])
              == (line["card_body"][0] == "group"),
              f"{name} {integrator} is_linear={is_linear}: launched "
              f"{line['kernel']}, card_body {line['card_body']}")

    # ---- service_ltv: relinearize + fused LTV solve each step, counted
    mp, _, _ = model_batch(dev, rng, "mahi_arm", 1, is_linear=True)
    Bs = SERVICE_BATCH
    svc = BatchModelControl(mp, batch=Bs, device=dev,
                            opts=SolverOptions(tol=1e-4, max_iter=30,
                                               fixed_warm_iters=3),
                            Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
                            Rm=[0.01] * 4)
    check(svc.warm_solver == "fused", f"LTV service: {svc.warm_solver}")
    x0 = 0.2 * rng.standard_normal((Bs, mp.num_x))
    svc.set_states(x0)
    svc.set_references(0.2 * rng.standard_normal((Bs, N_NODES, mp.num_x)))
    perts, refs = warm_schedule(Bs, WARM_STEPS)
    solve_batch_fused.launches = 0
    solve_batch_fused.mode_launches.update(fast=0, generic=0, ltv=0)
    solve_lqr_kernel_batch.launches = 0
    c0 = ltv_counts()
    u = svc.step()
    m = svc.metrics()
    emit(phase="service_ltv_cold", batch=Bs, cold_s=m["solve_s"],
         converged_frac=m["converged_frac"], mean_iters=m["mean_iters"])
    check(m["converged_frac"] >= 0.9, f"LTV cold {m}")
    step_ms = []
    for i in range(WARM_STEPS):
        svc.set_states(x0 + perts[i], u_prev=u)
        svc.set_references(refs[i])
        if i == WARM_STEPS - 1:       # the last step's inputs, kept
            p_last, X_last, U_last = svc._p, svc._X, svc._U
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = svc.step()
        end.record()
        sync()
        step_ms.append(start.elapsed_time(end))
    m = svc.metrics()
    ltv_launches = solve_batch_fused.mode_launches["ltv"]
    launches = solve_batch_fused.launches
    ric = solve_lqr_kernel_batch.launches
    lin_n, dis_n, lin_plain_n, dis_plain_n = np.subtract(ltv_counts(), c0)
    LTV_PATH["linearize_launches"] += int(lin_n)
    LTV_PATH["ltv_discrete_launches"] += int(dis_n)
    # relinearize on the kernel and on the plain version, in turns; the
    # discretization of the service's batch, wrapper and kernel alone
    relin_plain = lambda: [linearize_batch_plain(svc.dynamics, q.x0,
                                                 q.u_prev)
                           for q in svc._ps]
    relin, relin_plain_ms = [], []
    for order in ((0, 1), (1, 0)):
        for which in order:
            if which == 0:
                relin.append(timed(svc.relinearize, 3)[1])
            else:
                relin_plain_ms.append(timed(relin_plain, 2)[1])
    relin_ms = float(np.mean(relin))
    dis_ms = timed(lambda: ltv_discrete(svc.problem, svc._p), 20)[1]
    dis_kernel_ms = ltv_kernel_event_ms(
        lambda: ltv_discrete(svc.problem, svc._p))
    ms = float(np.mean(step_ms))
    LTV_PATH.update(service_ms_per_warm_step=ms, relinearize_ms=relin_ms,
                    relinearize_plain_ms=float(np.mean(relin_plain_ms)),
                    service_discrete_ms=dis_ms,
                    service_discrete_kernel_ms=dis_kernel_ms)
    emit(phase="service_ltv_warm", batch=Bs, warm_steps=WARM_STEPS,
         ms_per_warm_step=ms, ms_per_warm_step_all=step_ms,
         solves_per_s=Bs / (ms * 1e-3), relinearize_ms=relin_ms,
         relinearize_ms_turns=relin,
         relinearize_plain_ms=LTV_PATH["relinearize_plain_ms"],
         relinearize_plain_ms_turns=relin_plain_ms,
         discrete_ms=dis_ms, discrete_kernel_ms=dis_kernel_ms,
         solve_ms_last_step=svc.solve_time_s * 1e3,
         converged_frac=m["converged_frac"], mean_iters=m["mean_iters"],
         max_feas=m["max_feas"], launches=launches, ltv_launches=ltv_launches,
         riccati_launches=ric, linearize_launches=int(lin_n),
         discrete_launches=int(dis_n),
         plain_linearize_calls=int(lin_plain_n),
         plain_discrete_calls=int(dis_plain_n))
    check(tuple(u.shape) == (Bs, mp.num_u) and bool(torch.isfinite(u).all()),
          "LTV service: non-finite or misshapen controls")
    check(m["converged_frac"] >= 0.9, f"LTV warm {m}")
    check(launches == ltv_launches == 1 + WARM_STEPS and ric == 0,
          f"LTV service: {launches} fused ({ltv_launches} LTV) and {ric} "
          f"Riccati launches for {1 + WARM_STEPS} steps")
    check(lin_n == dis_n == 1 + WARM_STEPS and lin_plain_n == dis_plain_n
          == 0, f"LTV service: {lin_n} linearization and {dis_n} "
          f"discretization launches, {lin_plain_n} and {dis_plain_n} plain "
          f"calls for {1 + WARM_STEPS} steps")
    # the last warm step again on the same inputs, its frozen point and
    # discretization from the plain versions (the fused kernel as before)
    lin = linearize_batch_plain(svc.dynamics, p_last.x0, p_last.u_prev)
    opts_s = svc.opts
    ref = fused_solve(svc.problem, p_last._replace(lin=LinPoint(
        *lin, p_last.x0, p_last.u_prev)), X_last, U_last, opts_s,
        max(opts_s.warm_mu_factor * opts_s.tol, opts_s.mu_min),
        opts_s.fixed_warm_iters, None, False, _prepare_cuda, _launch_cuda,
        ltv_discrete_plain)
    u_ref = torch.where((ref.status != 2)[:, None], ref.U[:, 0], 0.0)
    du_routes = (u - u_ref).abs().max().item()
    LTV_PATH["service_routes_max_abs_du"] = du_routes
    emit(phase="service_ltv_routes", batch=Bs, max_abs_du=du_routes)
    check(du_routes <= 1e-4, f"LTV service step, kernels against plain "
                             f"versions: |du| {du_routes} > 1e-4")
    profiled = {"ltv": service_profile("service_ltv_profile", svc, "Ltv")}

    # ---- service_rk4: mahi_arm under RK4, the generic arm's group body
    mp, _, _ = model_batch(dev, rng, "mahi_arm", 1, "rk4")
    svc = BatchModelControl(mp, batch=Bs, device=dev,
                            opts=SolverOptions(tol=1e-4, max_iter=30,
                                               fixed_warm_iters=3),
                            Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
                            Rm=[0.01] * 4)
    check(svc.warm_solver == "fused", f"RK4 service: {svc.warm_solver}")
    x0 = 0.2 * rng.standard_normal((Bs, mp.num_x))
    svc.set_states(x0)
    svc.set_references(0.2 * rng.standard_normal((Bs, N_NODES, mp.num_x)))
    perts, refs = warm_schedule(Bs, RK4_WARM_STEPS)
    solve_batch_fused.launches = 0
    solve_batch_fused.mode_launches.update(fast=0, generic=0, ltv=0)
    solve_lqr_kernel_batch.launches = 0
    u = svc.step()
    cold_m = svc.metrics()
    step_ms = []
    for i in range(RK4_WARM_STEPS):
        svc.set_states(x0 + perts[i], u_prev=u)
        svc.set_references(refs[i])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = svc.step()
        end.record()
        sync()
        step_ms.append(start.elapsed_time(end))
    m = svc.metrics()
    rk4_launches = solve_batch_fused.mode_launches["generic"]
    launches = solve_batch_fused.launches
    ric = solve_lqr_kernel_batch.launches
    ms_rk4 = float(np.mean(step_ms))
    emit(phase="service_rk4", batch=Bs, cold_s=cold_m["solve_s"],
         cold_converged_frac=cold_m["converged_frac"],
         warm_steps=RK4_WARM_STEPS, ms_per_warm_step=ms_rk4,
         ms_per_warm_step_all=step_ms, solves_per_s=Bs / (ms_rk4 * 1e-3),
         converged_frac=m["converged_frac"], mean_iters=m["mean_iters"],
         launches=launches, generic_launches=rk4_launches,
         riccati_launches=ric)
    check(tuple(u.shape) == (Bs, mp.num_u) and bool(torch.isfinite(u).all()),
          "RK4 service: non-finite or misshapen controls")
    check(cold_m["converged_frac"] >= 0.9 and m["converged_frac"] >= 0.9,
          f"RK4 service: cold {cold_m}, warm {m}")
    check(launches == rk4_launches == 1 + RK4_WARM_STEPS and ric == 0,
          f"RK4 service: {launches} fused ({rk4_launches} generic) and "
          f"{ric} Riccati launches for {1 + RK4_WARM_STEPS} steps")
    profiled["generic"] = service_profile("service_rk4_profile", svc,
                                          "Generic")

    g_pend = gen["pendulum", "euler"]
    # what the kernels line says of a group body's kernel profiled in a
    # service step
    profiled_in = lambda key: dict(
        profiled_kernel=profiled[key]["kernel"],
        profiled_kernel_device_ms=profiled[key]["kernel_device_ms"])

    def timed_mode(key, **kw):
        """A mode's entry from its timing line: ``ms`` the wrapper's
        fixed-3 warm time by CUDA events (as earlier runs report it),
        ``device_ms`` the kernel's own by the profiler, and the bound's
        share of each; the body the card runs, its threads an instance,
        registers, spills and blocks an SM; the source is the group body's
        where the card runs it, else the library's."""
        t = times[key]
        body, width = t["card_body"]
        library = "mahi_mpc_tpu_torch/csrc/" + t["library"] + ".cu"
        name, integrator, is_linear = key
        return dict(
            mode="ltv" if is_linear else "fast" if integrator == "euler"
            else "generic",
            source="mahi_mpc_tpu_torch/csrc/fused_sqp_group.cuh"
            if body == "group" else library, library=library,
            case=f"{name} {integrator}{' LTV' if is_linear else ''}, "
                 f"fixed-3 warm ({t['kernel']})",
            card_body=[body, width],
            max_abs_err=t["fixed3_warm_max_abs_dxu"],
            ms=t["fixed3_warm_kernel_ms"],
            device_ms=t["fixed3_warm_kernel_device_ms"],
            plain_ms=t["fixed3_warm_plain_ms"],
            bound_ms=t["fixed3_warm_bound_ms"],
            bound_by=t["fixed3_warm_bound_by"],
            share=t["fixed3_warm_roofline_share"],
            device_share=t["fixed3_warm_device_roofline_share"],
            body_bound_ms=t["fixed3_warm_body_bound_ms"],
            registers=t["registers"],
            spill_store_bytes=t["spill_store_bytes"],
            blocks_per_sm=t["blocks_per_sm"],
            adaptive_cold_ms=t["adaptive_cold_kernel_ms"], **kw)

    extra = {("mahi_arm", "euler", True): dict(
                 launches=ltv_launches, service_ms_per_warm_step=ms,
                 relinearize_ms=relin_ms,
                 relinearize_plain_ms=LTV_PATH["relinearize_plain_ms"],
                 **profiled_in("ltv")),
             ("mahi_arm", "rk4", False): dict(
                 launches=rk4_launches, service_ms_per_warm_step=ms_rk4,
                 **profiled_in("generic"))}
    return [timed_mode(key, **extra.get(key, {})) for key in TIMED_MODES] + [
        dict(mode="fast", source="mahi_mpc_tpu_torch/csrc/fused_sqp_models.cu",
             case="pendulum Euler, fixed-3 warm at B=1024",
             max_abs_err=g_pend["warm_max_abs_dxu"])]


def arm_reference(mp, t):
    """A reference for ``calc_u``: joint j follows 0.3 sin(2 pi t + j) rad,
    with its rate, at the plan's N nodes after ``t``."""
    import numpy as np

    nq = mp.num_x // 2
    tt = t + (1 + np.arange(mp.num_shooting_nodes)) * mp.step_size
    w, ph = 2 * np.pi, np.arange(nq)
    return np.concatenate([0.3 * np.sin(w * tt[:, None] + ph),
                           0.3 * w * np.cos(w * tt[:, None] + ph)], axis=1)


def calc_u_params(mc, t, x, u):
    """The batch-of-one params ``mc.calc_u(t, x, u, arm_reference(mp, t))``
    hands its solver (the LTV linearization included)."""
    from mahi_mpc_tpu_torch.ops.precision import strict_fp32
    from mahi_mpc_tpu_torch.transcribe.shooting import LinPoint, map_params

    x0, u0 = mc._tensor(x), mc._tensor(u)
    p = mc._p._replace(x_des=mc._tensor(arm_reference(mc.params, t)), x0=x0,
                       u_prev=u0)
    if mc.params.is_linear:
        with strict_fp32():
            A, B, xd0 = mc.dynamics.linearize(x0, u0)
        p = p._replace(lin=LinPoint(A, B, xd0, x0, u0))
    return map_params(lambda a: a[None], p)


def held_b1(mc, p1, kw):
    """The fused solve at B=1 from ``mc``'s warm start, kernel against
    plain version on the same inputs: max |dX|, |dU| (both statuses
    equal, or the check fails)."""
    from mahi_mpc_tpu_torch.solver.fused import (solve_batch_fused,
                                                 solve_batch_fused_plain)

    X1, U1 = mc._X0[None], mc._U0[None]
    rk, rp = [solve(mc.problem, p1, X1, U1, mc.opts, mu0=mc._mu_warm, **kw)
              for solve in (solve_batch_fused, solve_batch_fused_plain)]
    err = max((rk.X - rp.X).abs().max().item(),
              (rk.U - rp.U).abs().max().item())
    check(int(rk.status[0]) == int(rp.status[0]) and err <= 1e-4,
          f"B=1 {kw}: max|dX|,|dU| {err}, statuses {int(rk.status[0])} / "
          f"{int(rp.status[0])}")
    return err


# Cycles an FP32 operation waits for the one it depends on (the dependent
# issue latency of an FMA on Hopper): the factor of the block body's
# dependency-chain bound.
CHAIN_CYCLES = 4


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out)


def chain_bound(prob, p1, X1, U1, opts, mu, kw, clock_mhz) -> dict:
    """The block body's dependency-chain bound at B=1: the operations of
    its critical path (``count_block_path``: the busiest thread of each
    stretch between two block barriers, by g++ on a counting scalar, these
    inputs) x ``CHAIN_CYCLES`` at the SM clock."""
    from mahi_mpc_tpu_torch.solver.fused import count_block_path

    path = count_block_path(prob, p1, X1, U1, opts, mu0=mu, **kw)
    ops = sum(path.values())
    return dict(chain_ops=ops, chain_ops_by_region=path,
                chain_bound_ms=ops * CHAIN_CYCLES / (clock_mhz * 1e3),
                sm_clock_mhz=clock_mhz)


def calc_u_split(mc, t, x, u, traj, reps=50) -> dict:
    """A warm ``mc.calc_u(t, x, u, traj)`` at B=1 split by stage, each
    stage ended by a device synchronisation (mean ms over ``reps`` calls):
    the tensors made from the host arrays, the params (``_replace``, the
    batch of one, ``_solve``'s preparation up to ``_run_library``: on the
    card one kernel writes the batch-innermost inputs), the ctypes set-up
    in ``_run_library`` (``copies_ctypes``), the kernel, the layout back,
    the status rules (the rest of ``_solve``), and the copy back to the
    host; and ``calc_u`` itself (p50 ms, no
    synchronisation inside).  ``calc_u``'s own steps are done here as it
    does them; the package is not changed.  Leaves ``mc``'s plan as it
    was."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch.solver import fused as fused_mod

    sync = torch.cuda.synchronize
    names = ("tensors", "params", "copies_ctypes", "kernel", "layout_back",
             "status", "copy_back")
    acc = dict.fromkeys(names, 0.0)
    last = [0.0]

    def mark(name):
        sync()
        now = time.perf_counter()
        acc[name] += (now - last[0]) * 1e3
        last[0] = now

    real = fused_mod._run_library

    def run(fn, stream, *a):
        mark("params")

        def launch(*args):
            mark("copies_ctypes")
            rc = fn(*args)
            mark("kernel")
            return rc

        out = real(launch, stream, *a)
        mark("layout_back")
        return out

    X0, U0, mu = mc._X0, mc._U0, mc._mu_warm
    fused_mod._run_library = run
    try:
        for _ in range(reps):
            sync()
            last[0] = time.perf_counter()
            x0, u0 = mc._tensor(x), mc._tensor(u)
            xd = mc._tensor(traj).reshape(mc.params.num_shooting_nodes,
                                          mc.params.num_x)
            mark("tensors")
            p = mc._p._replace(x_des=xd, x0=x0, u_prev=u0)
            res = mc._solve_warm(p, X0, U0, mu)
            mark("status")
            flat = torch.cat([res.X.reshape(-1), res.U.reshape(-1),
                              torch.stack([res.iters.to(res.X.dtype),
                                           res.status.to(res.X.dtype),
                                           res.kkt, res.feas, res.obj])])
            flat.to("cpu", torch.float64).numpy()
            mark("copy_back")
    finally:
        fused_mod._run_library = real
    split = {k: v / reps for k, v in acc.items()}
    plan = mc._plan
    lat = []
    for _ in range(reps):
        mc._X0, mc._U0 = X0, U0
        lat.append(mc.calc_u(t, x, u, traj).solve_time_s * 1e3)
    mc._X0, mc._U0, mc._plan = X0, U0, plan
    return dict(split_ms=split, split_sum_ms=sum(split.values()),
                calc_u_p50_ms=float(np.percentile(lat, 50)),
                reps=reps)


def closed_loop(mc, plant, x, n_warm, t0=0.0, walls=None):
    """One cold and ``n_warm`` warm ``calc_u`` of ``mc`` in closed loop on
    ``plant``, one plan step a call: (cold plan, warm plans, final state,
    largest |q - q_des| over the last half).  ``walls``: a list that gets
    the host ms of each whole ``calc_u`` (a plan's ``solve_time_s`` is the
    solve and its copy back; the LTV linearization comes before it)."""
    import numpy as np

    mp = mc.params
    u = np.zeros(mp.num_u)
    plans, errs = [], []
    for k in range(1 + n_warm):
        t = t0 + k * mp.step_size
        ref = arm_reference(mp, t)
        w0 = time.perf_counter()
        plan = mc.calc_u(t, x, u, ref)
        if walls is not None:
            walls.append((time.perf_counter() - w0) * 1e3)
        plans.append(plan)
        u = plan.U[0]
        x = plant(x, u)
        errs.append(np.abs(x[:mp.num_x // 2] - ref[0, :mp.num_x // 2]).max())
    return plans[0], plans[1:], x, float(np.max(errs[len(errs) // 2:]))


def runtime_phases(dev, mp, Qw, Rw, Rmw, opts, timed, clock_mhz) -> dict:
    """Phase 14, runtime_control: the single-instance runtime of ``mp`` (the
    main path's 4-DOF arm) on the card.  Returns what the kernels line
    reports of the fused kernel at B=1."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.models import euler_step, make_dynamics
    from mahi_mpc_tpu_torch.runtime import ModelControl, generate_model
    from mahi_mpc_tpu_torch.runtime.native import NativePacer
    from mahi_mpc_tpu_torch.solver.fused import (card_body, count_fused_ops,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch

    dyn = make_dynamics("mahi_arm")
    euler = euler_step(dyn.f, mp.step_size)
    plant = lambda x, u: euler(torch.as_tensor(x, dtype=torch.float64),
                               torch.as_tensor(u, dtype=torch.float64)
                               ).numpy()
    weights = dict(Q=Qw, R=Rw, Rm=Rmw)
    # Start on the reference (its value at t = 0, one step before node 0).
    x_start = arm_reference(mp, -mp.step_size)[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    out = {}
    try:
        t0 = time.perf_counter()
        manifest = generate_model(
            mp, directory=tmp, device=dev, opts=SolverOptions(
                tol=opts.tol, max_iter=30, fixed_warm_iters=3))
        gen_s = time.perf_counter() - t0
        libs = json.loads(open(manifest).read())["libraries"]
        check(list(libs) == ["fused_sqp"],
              f"generate_model built {list(libs)} for the Euler arm")

        def reset():
            solve_batch_fused.launches = 0
            solve_batch_fused.mode_launches.update(fast=0, generic=0, ltv=0)
            solve_batch_fused.body_launches.update(thread=0, group=0, block=0)
            solve_lqr_kernel_batch.launches = 0

        def counts():
            return (solve_batch_fused.launches,
                    dict(solve_batch_fused.mode_launches),
                    solve_lqr_kernel_batch.launches)

        # -- the main path: generated model, cold + warm closed loop, for
        # both warm shapes (fixed-3 from the manifest, adaptive by options)
        runs = {}
        for k, given in ((3, None), (0, SolverOptions(
                tol=opts.tol, max_iter=30, fixed_warm_iters=0))):
            mc = ModelControl(mp.name, directory=tmp, opts=given,
                              device=dev, **weights)
            check(mc.warm_solver == "fused" and mc.device == dev,
                  f"ModelControl resolved {mc.warm_solver} on {mc.device}")
            reset()
            cold, warm, x, err = closed_loop(mc, plant, x_start,
                                             RUNTIME_WARM_CALLS)
            launches, modes, ric = counts()
            bodies = dict(solve_batch_fused.body_launches)
            lat = np.array([p.solve_time_s for p in warm]) * 1e3
            st = np.array([p.status for p in warm])
            it = np.array([p.iters for p in warm])
            summ = mc.stats.summary()
            line = dict(fixed_warm_iters=k, cold_status=cold.status,
                        cold_iters=cold.iters, cold_s=cold.solve_time_s,
                        warm_calls=len(warm), launches=launches,
                        launches_fast=modes["fast"], body_launches=bodies,
                        riccati_launches=ric,
                        calc_u_p50_ms=float(np.percentile(lat, 50)),
                        calc_u_p99_ms=float(np.percentile(lat, 99)),
                        calc_u_mean_ms=float(lat.mean()),
                        warm_converged=float((st == 0).mean()),
                        warm_mean_iters=float(it.mean()),
                        failures=summ["failures"],
                        max_track_err_last_half=err,
                        final_state_finite=bool(np.isfinite(x).all()))
            emit(phase="runtime_control", generate_s=gen_s, **line)
            check(cold.status == 0, f"cold calc_u status {cold.status}")
            check(launches == len(warm) == modes["fast"] == bodies["block"]
                  and ric == 0,
                  f"{launches} fused launches ({modes}, {bodies}), {ric} "
                  f"Riccati, for {len(warm)} warm calc_u: every one on the "
                  f"block body")
            check(summ["failures"] == 0 and bool((st != 2).all())
                  and np.isfinite(x).all() and err < TRACK_BAND,
                  f"runtime closed loop {line}")
            if k == 0:
                check((st == 0).mean() >= 0.9, f"adaptive warm {line}")
            runs[k] = (mc, line)

        # -- the fused warm solve at B=1 against its plain version, at the
        # next state the last plan predicts (launches after the counted run)
        mc, line = runs[3]
        mu = mc._mu_warm
        t_last = RUNTIME_WARM_CALLS * mp.step_size
        x_next, u_last = mc._X0[1].cpu().numpy(), mc._U0[0].cpu().numpy()
        p1 = calc_u_params(mc, t_last, x_next, u_last)
        X1, U1 = mc._X0[None], mc._U0[None]
        b1 = {name: held_b1(mc, p1, kw) for name, kw in (
            ("fixed3", dict(n_iter=3)), ("adaptive", dict(adaptive=True)))}
        warm1 = lambda solve: solve(mc.problem, p1, X1, U1, mc.opts,
                                    mu0=mu, n_iter=3)
        reps = 50
        body = card_body(mc.problem, 1)
        kernel = FUSED_ENTRIES[body[0]]
        check(body[0] == "block", f"B=1 arm on {body}")
        prof = profile_step(lambda: [warm1(solve_batch_fused)
                                     for _ in range(reps)], kernel, reps)
        check(prof["kernel_count"] == reps,
              f"{prof['kernel_count']} {kernel} launches for {reps}")
        kernel_ms = prof["kernel_device_ms"] / prof["kernel_count"]
        _, wrapper_ms = timed(lambda: warm1(solve_batch_fused), reps)
        _, plain_ms = timed(lambda: warm1(solve_batch_fused_plain), 3)
        ref_last = arm_reference(mp, t_last)
        prof_calc = profile_step(
            lambda: [mc.calc_u(t_last, x_next, u_last, ref_last)
                     for _ in range(20)], kernel, 20)
        check(prof_calc["kernel_count"] == 20,
              f"{prof_calc['kernel_count']} {kernel} launches for 20 "
              f"calc_u")
        split = calc_u_split(mc, t_last, x_next, u_last, ref_last)
        ops = count_fused_ops(mc.problem, p1, X1, U1, mc.opts, mu0=mu,
                              n_iter=3)
        bound = bound_ms(sum(ops["minimum"].values()),
                         fused_io_bytes(p1, X1, U1, 1))
        chain = chain_bound(mc.problem, p1, X1, U1, mc.opts, mu,
                            dict(n_iter=3), clock_mhz)
        out.update(ms_b1=kernel_ms, plain_ms_b1=plain_ms,
                   max_abs_err_b1=max(b1.values()),
                   bound_ms_b1=bound["bound_ms"],
                   bound_by_b1=bound["bound_by"],
                   chain_bound_ms_b1=chain["chain_bound_ms"],
                   card_body_b1=list(body))
        emit(phase="runtime_fused_b1", card_body=list(body), kernel=kernel,
             max_abs_dxu_fixed3=b1["fixed3"],
             max_abs_dxu_adaptive=b1["adaptive"], kernel_device_ms=kernel_ms,
             wrapper_ms=wrapper_ms, plain_ms=plain_ms,
             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], **chain,
             calc_u_p50_ms=line["calc_u_p50_ms"],
             kernel_share_of_calc_u_p50=kernel_ms / line["calc_u_p50_ms"],
             calc_u_profiled={k: prof_calc[k] for k in (
                 "wall_ms", "device_ms", "kernel_device_ms", "kernel_count",
                 "device_busy_share", "top_kernels")})
        emit(phase="calc_u_split", model="mahi_arm", fixed_warm_iters=3,
             **split)

        # -- the LTV flavour: a generated LTV model, cold + warm closed loop
        lmp = dataclasses.replace(mp, name=mp.name + "_ltv", is_linear=True)
        generate_model(lmp, directory=tmp, device=dev, opts=SolverOptions(
            tol=opts.tol, max_iter=30, fixed_warm_iters=3))
        lmc = ModelControl(lmp.name, directory=tmp, device=dev, **weights)
        reset()
        c0 = ltv_counts()
        walls = []
        cold, warm, x, err = closed_loop(lmc, plant, x_start,
                                         RUNTIME_LTV_CALLS, walls=walls)
        walls = np.array(walls[1:])           # the warm calls
        launches, modes, ric = counts()
        ltv_bodies = dict(solve_batch_fused.body_launches)
        # the linearization kernel at B=1 every call, the discretization
        # every warm (fused) solve; no plain version
        lin_n, dis_n, lin_plain_n, dis_plain_n = (
            int(v) for v in np.subtract(ltv_counts(), c0))
        check((lin_n, dis_n, lin_plain_n, dis_plain_n)
              == (1 + len(warm), len(warm), 0, 0),
              f"LTV runtime: {lin_n} linearization, {dis_n} discretization "
              f"launches, {lin_plain_n} and {dis_plain_n} plain calls for "
              f"1 cold + {len(warm)} warm calc_u")
        LTV_PATH["linearize_launches"] += lin_n
        LTV_PATH["ltv_discrete_launches"] += dis_n
        st = np.array([p.status for p in warm])
        lat = np.array([p.solve_time_s for p in warm]) * 1e3
        emit(phase="runtime_control_ltv", cold_status=cold.status,
             cold_iters=cold.iters, cold_s=cold.solve_time_s,
             warm_calls=len(warm), launches=launches,
             launches_ltv=modes["ltv"], body_launches=ltv_bodies,
             linearize_launches=lin_n, discrete_launches=dis_n,
             calc_u_p50_ms=float(np.percentile(lat, 50)),
             calc_u_p99_ms=float(np.percentile(lat, 99)),
             calc_u_wall_p50_ms=float(np.percentile(walls, 50)),
             calc_u_wall_p99_ms=float(np.percentile(walls, 99)),
             warm_converged=float((st == 0).mean()),
             max_track_err_last_half=err)
        check(cold.status == 0 and launches == len(warm) == modes["ltv"]
              == ltv_bodies["block"] and bool((st != 2).all())
              and np.isfinite(x).all(),
              f"LTV runtime: cold {cold.status}, {launches} launches "
              f"({modes}, {ltv_bodies}) for {len(warm)}, statuses "
              f"{np.unique(st)}: every one on the block body")
        out["ltv_launches"] = launches
        LTV_PATH.update(calc_u_p50_ms=float(np.percentile(lat, 50)),
                        calc_u_p99_ms=float(np.percentile(lat, 99)),
                        calc_u_wall_p50_ms=float(np.percentile(walls, 50)),
                        calc_u_wall_p99_ms=float(np.percentile(walls, 99)))
        # the LTV warm solve at B=1 (Ltv<8, 4> on the block body): held to
        # its plain version, the block kernel's device ms a launch
        # (profiler, by name), its bound and chain bound
        pl = calc_u_params(lmc, RUNTIME_LTV_CALLS * mp.step_size,
                           lmc._X0[1].cpu().numpy(),
                           lmc._U0[0].cpu().numpy())
        out["ltv_max_abs_err_b1"] = max(
            held_b1(lmc, pl, kw) for kw in (dict(n_iter=3),
                                            dict(adaptive=True)))
        XL, UL = lmc._X0[None], lmc._U0[None]
        warm_l = lambda solve: solve(lmc.problem, pl, XL, UL, lmc.opts,
                                     mu0=lmc._mu_warm, n_iter=3)
        body_l = card_body(lmc.problem, 1)
        check(body_l[0] == "block", f"B=1 LTV arm on {body_l}")
        prof_l = profile_step(lambda: [warm_l(solve_batch_fused)
                                       for _ in range(reps)],
                              FUSED_ENTRIES[body_l[0]], reps)
        check(prof_l["kernel_count"] == reps
              and any("Ltv" in k[0] for k in prof_l["top_kernels"]),
              f"LTV B=1: {prof_l['kernel_count']} block kernel launches "
              f"for {reps}: {prof_l['top_kernels']}")
        _, ltv_wrapper_ms = timed(lambda: warm_l(solve_batch_fused), reps)
        _, ltv_plain_ms = timed(lambda: warm_l(solve_batch_fused_plain), 3)
        ops_l = count_fused_ops(lmc.problem, pl, XL, UL, lmc.opts,
                                mu0=lmc._mu_warm, n_iter=3, body="group")
        nxl, nul = lmc.problem.nx, lmc.problem.nu
        bound_l = bound_ms(sum(ops_l["minimum"].values()),
                           fused_io_bytes(pl, XL, UL, 1)
                           + 4 * (nxl * nxl + nxl * nul + nxl))
        chain_l = chain_bound(lmc.problem, pl, XL, UL, lmc.opts,
                              lmc._mu_warm, dict(n_iter=3), clock_mhz)
        out.update(ltv_ms_b1=ltv_wrapper_ms,
                   ltv_device_ms_b1=prof_l["kernel_device_ms"] / reps,
                   ltv_plain_ms_b1=ltv_plain_ms,
                   ltv_bound_ms_b1=bound_l["bound_ms"],
                   ltv_bound_by_b1=bound_l["bound_by"],
                   ltv_chain_bound_ms_b1=chain_l["chain_bound_ms"],
                   ltv_card_body_b1=list(body_l))
        emit(phase="runtime_ltv_b1", card_body=list(body_l),
             max_abs_dxu=out["ltv_max_abs_err_b1"],
             wrapper_ms=ltv_wrapper_ms,
             kernel_device_ms=out["ltv_device_ms_b1"], plain_ms=ltv_plain_ms,
             bound_ms=bound_l["bound_ms"], bound_by=bound_l["bound_by"],
             **chain_l, calc_u_p50_ms=float(np.percentile(lat, 50)),
             kernel=prof_l["top_kernels"][0][0])

        # -- the solver thread: 1 s of start_calc under a 1 kHz
        # control_at_time reader, with the native plan server.  The reader
        # holds the plant to the plan (its state at the read's time): a
        # plant integrated in Python would hold the interpreter lock that
        # the solver thread needs.  The lock is handed over every 0.2 ms
        # (the default 5 ms would pace the reader below 1 kHz).
        tmc = ModelControl(mp.name, directory=tmp, use_native_server=True,
                           device=dev, **weights)
        u = np.zeros(mp.num_u)
        tmc.set_state(0.0, x_start, u, arm_reference(mp, 0.0))
        reset()
        switch = sys.getswitchinterval()
        tmc.start_calc()
        try:
            deadline = time.perf_counter() + 60.0
            while (tmc.control_results().status == -1
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
            check(tmc.control_results().status != -1,
                  "the solver thread made no plan in 60 s")
            sys.setswitchinterval(2e-4)
            solves0 = tmc.stats.summary()["solves"]
            pacer = NativePacer(0.001)
            t_start = time.perf_counter()
            ticks = 0
            while (t := time.perf_counter() - t_start) < THREAD_SECONDS:
                u = tmc.control_at_time(t)
                tmc.set_state(t, tmc.control_results().state_at_time(t), u,
                              arm_reference(mp, t))
                ticks += 1
                pacer.wait()
        finally:
            sys.setswitchinterval(switch)
            tmc.stop_calc()
        launches, modes, ric = counts()
        summ = tmc.stats.summary()
        emit(phase="runtime_thread", seconds=THREAD_SECONDS, reads=ticks,
             solves=summ["solves"], solves_in_window=summ["solves"] - solves0,
             launches=launches,
             served_stale=summ["served_stale"],
             served_placeholder=summ["served_placeholder"],
             failures=summ["failures"], solve_p50_ms=summ["p50_ms"],
             solve_p99_ms=summ["p99_ms"], pacer_misses=pacer.misses,
             pacer_worst_late_ms=pacer.worst_late_s * 1e3,
             published=tmc._native.published_count,
             thread_alive=tmc._calc_thread is not None)
        check(summ["failures"] == 0 and summ["served_stale"] == 0
              and summ["served_placeholder"] == 0
              and summ["solves"] >= 10 and launches == summ["solves"] - 1
              and tmc._calc_thread is None,
              f"solver thread: {summ}, {launches} launches")
        out["thread_launches"] = launches
        check(solve_batch_fused.body_launches["block"] == launches,
              f"solver thread: {solve_batch_fused.body_launches} for "
              f"{launches} launches")
        out["block_launches"] = (runs[3][1]["launches"]
                                 + runs[0][1]["launches"] + launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def runtime_default_example(dev, timed, clock_mhz) -> dict:
    """Phase 14b, runtime_default_example: the reference's default example
    as a user runs it, ``examples/model_generate.py`` at its defaults
    (``double_pendulum``, Euler, dt = 2 ms, N = 25, no control bounds)
    into a temporary directory, then ``examples/model_control.py``'s loop:
    ``ModelControl`` with its options and weights (Q = [10, 1, 5, 5], R =
    0.5, Rm = 0), ``warmup``, the RK4 plant from x = [0.3, 0, 0, 0] on its
    sinusoid reference, a ``calc_u`` every 5th tick (the reference's
    cadence), ``DEFAULT_EXAMPLE_CALLS`` in all.  Counted: one fused launch
    a warm ``calc_u``, all on the nq-row path, every warm solve converged
    or at its cap, none failed.  Then the B=1 warm solve held to its plain
    version, the kernel's device ms a launch in 20 ``calc_u`` under the
    profiler (the body ``card_body`` names, by name), the plain version's
    ms and the bound at B=1.  Returns the kernels line's entry."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.examples import model_control, model_generate
    from mahi_mpc_tpu_torch.runtime import ModelControl
    from mahi_mpc_tpu_torch.solver.fused import (card_body, count_fused_ops,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_default_")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            model_generate.main(["--out", tmp, "--device", str(dev)])
        gen_s = time.perf_counter() - t0
        mc = ModelControl("double_pendulum", directory=tmp, device=dev,
                          opts=SolverOptions(tol=1e-4, max_iter=40))
        mp = mc.params
        mc.update_weights(Q=[10.0, 1.0, 5.0, 5.0], R=[0.5] * mp.num_u,
                          Rm=[0.0] * mp.num_u)
        plant = model_control.plant_step(mc.dynamics, mp.step_size)
        mc.warmup()
        check(mc.warm_solver == "fused" and mp.integrator == "euler"
              and mp.num_shooting_nodes == N_NODES and mp.step_size == 0.002,
              f"default example: {mc.warm_solver}, {mp}")
        x, u = np.array([0.3, 0.0, 0.0, 0.0]), np.zeros(mp.num_u)
        plans = []
        solve_batch_fused.launches = 0
        solve_batch_fused.mode_launches.update(fast=0, generic=0, ltv=0)
        solve_batch_fused.body_launches.update(thread=0, group=0, block=0)
        for k in range(5 * DEFAULT_EXAMPLE_CALLS):
            t = k * mp.step_size
            if k % 5 == 0:
                plans.append(mc.calc_u(t, x, u,
                                       model_control.reference_traj(mp, t)))
            u = mc.control_at_time(t)
            x = plant(x, u)
        launches = solve_batch_fused.launches
        fast = solve_batch_fused.mode_launches["fast"]
        block = solve_batch_fused.body_launches["block"]
        warm = plans[1:]
        lat = np.array([p.solve_time_s for p in warm]) * 1e3
        st = np.array([p.status for p in warm])
        body = card_body(mc.problem, 1)
        line = dict(generate_s=gen_s, card_body=list(body),
                    block_launches=block,
                    cold_status=plans[0].status, cold_iters=plans[0].iters,
                    cold_s=plans[0].solve_time_s, warm_calls=len(warm),
                    launches=launches, launches_fast=fast,
                    calc_u_p50_ms=float(np.percentile(lat, 50)),
                    calc_u_p99_ms=float(np.percentile(lat, 99)),
                    calc_u_mean_ms=float(lat.mean()),
                    warm_converged=float((st == 0).mean()),
                    warm_mean_iters=float(np.mean([p.iters for p in warm])),
                    failures=mc.stats.summary()["failures"],
                    final_state=x.tolist())
        check(plans[0].status == 0 and launches == fast == len(warm)
              == block and body[0] == "block"
              and line["failures"] == 0 and bool((st != 2).all())
              and bool(np.isfinite(x).all()),
              f"default example: {line}")
        # the B=1 warm solve (adaptive, as the example's options make it)
        t_last = 5 * DEFAULT_EXAMPLE_CALLS * mp.step_size
        x1, u1 = mc._X0[1].cpu().numpy(), mc._U0[0].cpu().numpy()
        p1 = calc_u_params(mc, t_last, x1, u1)
        err = held_b1(mc, p1, dict(adaptive=True))
        X1, U1 = mc._X0[None], mc._U0[None]
        warm1 = lambda solve: solve(mc.problem, p1, X1, U1, mc.opts,
                                    mu0=mc._mu_warm, adaptive=True)
        kernel = FUSED_ENTRIES[body[0]]
        ref = model_control.reference_traj(mp, t_last)
        prof = profile_step(lambda: [mc.calc_u(t_last, x1, u1, ref)
                                     for _ in range(20)], kernel, 20)
        check(prof["kernel_count"] == 20,
              f"default example: {prof['kernel_count']} {kernel} launches "
              f"for 20 calc_u: {prof['top_kernels']}")
        kernel_ms = prof["kernel_device_ms"] / prof["kernel_count"]
        _, plain_ms = timed(lambda: warm1(solve_batch_fused_plain), 3)
        # the block body computes the group body's function: its minimum
        ops = count_fused_ops(mc.problem, p1, X1, U1, mc.opts,
                              mu0=mc._mu_warm, adaptive=True, body="group")
        bound = bound_ms(sum(ops["minimum"].values()),
                         fused_io_bytes(p1, X1, U1, 1))
        chain = chain_bound(mc.problem, p1, X1, U1, mc.opts, mc._mu_warm,
                            dict(adaptive=True), clock_mhz)
        split = calc_u_split(mc, t_last, x1, u1, ref)
        emit(phase="calc_u_split", model="double_pendulum", adaptive=True,
             **split)
        line.update(max_abs_dxu_b1=err, kernel_device_ms=kernel_ms,
                    plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"], **chain,
                    kernel_share_of_calc_u_p50=kernel_ms
                    / line["calc_u_p50_ms"],
                    kernel=prof["top_kernels"][0][0])
        emit(phase="runtime_default_example", **line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(
        mode="fast", source="mahi_mpc_tpu_torch/csrc/fused_sqp_block.cuh",
        library="mahi_mpc_tpu_torch/csrc/fused_sqp_models.cu",
        case="ModelControl double_pendulum Euler (the reference's default "
             f"example), B=1: {len(warm)} adaptive warm calc_u",
        card_body=list(body), launches=launches, max_abs_err=err,
        ms=kernel_ms, device_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        chain_bound_ms=chain["chain_bound_ms"],
        calc_u_p50_ms=line["calc_u_p50_ms"],
        calc_u_p99_ms=line["calc_u_p99_ms"],
        calc_u_split_ms=split["split_ms"])


# Phase 14c's batches: the ladder at which the body the launcher's rule
# picks for the small-batch policies is held and timed (one SM, two, a few,
# a quarter of the card, one and two waves of one block an SM, the double
# pendulum's and the arm's thresholds, three and five waves, and past
# them), and the horizons held at B=1 beyond N=25.
CROSSOVER_LADDER = (1, 2, 8, 32, 132, 264, 396, 660, 1024)
# The policies with a block body: (model, LTV), under Euler.
BLOCK_MODELS = (("mahi_arm", False), ("double_pendulum", False),
                ("mahi_arm", True))
LONG_HORIZONS = (100, 200)


def kernel_event_ms(call, reps=20) -> float:
    """Device ms of one launch of the fused kernel that ``call()`` launches
    once: inside that call, with its arguments ready, the launch is
    repeated ``reps`` times back to back between two CUDA events on its
    stream (each repeat reads the same inputs and writes the same
    outputs), after one warm-up, then made once more as the call's own.
    The host's preparation around the launch is not in the time, so small
    batches are timed as the kernel runs, not as the host feeds it."""
    import torch

    from mahi_mpc_tpu_torch.solver import fused as fused_mod

    real, got = fused_mod._run_library, []

    def run(fn, stream, *a):
        def timed(*args):
            fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            got.append(start.elapsed_time(end) / reps)
            return fn(*args)

        return real(timed, stream, *a)

    fused_mod._run_library = run
    try:
        call()
    finally:
        fused_mod._run_library = real
    check(len(got) == 1, f"{len(got)} launches timed in one call")
    return got[0]


def block_kernel_info(builds, prob, N) -> dict:
    """The block body's kernel for ``prob`` at horizon N: its ``-Xptxas
    -v`` line (registers, spills), dynamic shared memory bytes and blocks
    an SM."""
    import ctypes

    from mahi_mpc_tpu_torch.solver.target import INTEGRATORS, kernel_target
    target = kernel_target(prob)
    lib = target.cuda
    if prob.is_linear:
        marks = (f"3LtvIfLi{prob.nx}ELi{prob.nu}E",)
    elif target.unit is not None:
        marks = ("6FastNq" if target.mode == "fast" else "7Generic",
                 "3gen5ModelIf")
    else:
        marks = (MODEL_MARKS[prob.dynamics.name],)
    found = [k for k in ptxas_summary(builds[lib][1])
             if "22fused_sqp_block_kernel" in k["kernel"]
             and all(m in k["kernel"] for m in marks)]
    check(len(found) == 1, f"{lib}: {len(found)} block kernels for "
          f"{prob.dynamics.name}")
    out = (ctypes.c_int * 2)()
    rc = builds[lib][0].mpc_fused_block_info(
        target.model, prob.nx, prob.nu,
        INTEGRATORS.index(prob.integrator), int(prob.is_linear), N, out)
    check(rc == 0 and out[0] > 0, f"{lib} block kernel at N={N}: rc {rc}, "
          f"{out[0]} blocks an SM")
    return dict(registers=found[0]["registers"],
                spill_store_bytes=found[0]["spill_store_bytes"],
                spill_load_bytes=found[0]["spill_load_bytes"],
                smem_bytes=out[1], blocks_per_sm=out[0])


def block_max_batch(prob) -> int:
    """The largest batch at which the launcher's rule (``card_body``) runs
    ``prob`` on the block body (its policy's kMaxBatch at this horizon), 0
    where it never does."""
    from mahi_mpc_tpu_torch.solver.fused import card_body

    lo, hi = 0, 1 << 20
    while lo < hi:                     # the rule is block up to a batch
        mid = (lo + hi + 1) // 2
        if card_body(prob, mid)[0] == "block":
            lo = mid
        else:
            hi = mid - 1
    return lo


# Phase 14c's user models (phase 23's cases with a block body): Van der
# Pol under RK4 (`Generic<gen::Model>`, the two-lane group body at full
# occupancy), the cart-pole's own f and the 4-DOF chain (`FastNq<gen::Model>`,
# one thread at full occupancy).
BLOCK_USER_MODELS = ("user_vdp", "user_cartpole", "user_chain4")


def block_ladder_phase(dev, builds) -> list:
    """Phase 14c, block_ladder: the body the launcher's rule picks
    (``card_body``) for ``FastNq<ArmModel<4>>``, ``FastNq<DoublePendulum>``
    and ``Ltv<8, 4>`` (``BLOCK_MODELS``: Euler, bench-shaped data of
    ``model_batch``) at each B of ``CROSSOVER_LADDER`` (N=25) and at B=1
    with N of ``LONG_HORIZONS``, and for a user's own model under each
    generated policy (``BLOCK_USER_MODELS``, data of ``generated_batch``)
    at B=1 and at its policy's threshold (``block_max_batch``): from the
    adaptive cold plan, a fixed-3 and an adaptive warm solve at x0 + 0.01,
    each launched on the rule's body (``solve_batch_fused.body_launches``)
    and held to the plain version on the same inputs (max |dX|, |dU| <=
    1e-4; statuses equal on every instance at B=1, on >= 99 % above), the
    body's device ms a fixed-3 launch (``kernel_event_ms``), and at B=1
    each model's block kernel (registers, spills, shared memory and blocks
    an SM at each N).  Returns the lines."""
    import numpy as np

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.solver.fused import (card_body,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)

    opts = SolverOptions(tol=1e-4, max_iter=12)
    opts_cold = SolverOptions(tol=1e-4, max_iter=30)
    mu_warm = opts.warm_mu_factor * opts.tol
    bodies = solve_batch_fused.body_launches
    cases = [(name + (" LTV" if ltv else ""), N, B, lambda B, N, name=name,
              ltv=ltv: model_batch(dev, np.random.default_rng(0), name, B,
                                   is_linear=ltv, N=N)[1:])
             for name, ltv in BLOCK_MODELS
             for N, B in [(N_NODES, B) for B in CROSSOVER_LADDER]
             + [(N, 1) for N in LONG_HORIZONS]]
    for name in BLOCK_USER_MODELS:
        make = lambda B, N, name=name: generated_batch(
            dev, np.random.default_rng(0), name, B)
        top = block_max_batch(make(1, N_NODES)[0])
        check(top >= 1, f"{name}: no block body at B=1")
        cases += [(name, N_NODES, B, make) for B in (1, top)]
    lines = []
    for name, N, B, make in cases:
        prob, p = make(B, N)
        rule = card_body(prob, B)
        cold = solve_batch_fused(prob, p, None, None, opts_cold,
                                 mu0=opts_cold.mu_init, adaptive=True)
        pw = p._replace(x0=p.x0 + 0.01)
        line = dict(phase="block_ladder", model=name, batch=B, N=N,
                    rule=list(rule))
        for mode, kw in (("fixed3", dict(n_iter=3)),
                         ("adaptive", dict(adaptive=True))):
            rp = solve_batch_fused_plain(prob, pw, cold.X, cold.U, opts,
                                         mu0=mu_warm, **kw)
            n0 = bodies[rule[0]]
            rk = solve_batch_fused(prob, pw, cold.X, cold.U, opts,
                                   mu0=mu_warm, **kw)
            err = max((rk.X - rp.X).abs().max().item(),
                      (rk.U - rp.U).abs().max().item())
            same = (rk.status == rp.status).float().mean().item()
            line[f"{mode}_max_abs_dxu"] = err
            line[f"{mode}_status_agree"] = same
            check(bodies[rule[0]] == n0 + 1,
                  f"{name} B={B} N={N} {mode}: not launched on {rule}")
            check(err <= 1e-4 and (same == 1.0 if B == 1 else same >= 0.99),
                  f"{name} B={B} N={N} {mode}: max|dX|,|dU| {err}, "
                  f"statuses agree on {same}")
        line["device_ms"] = kernel_event_ms(lambda: solve_batch_fused(
            prob, pw, cold.X, cold.U, opts, mu0=mu_warm, n_iter=3))
        if B == 1:
            line["block_kernel"] = block_kernel_info(builds, prob, N)
        emit(**line)
        lines.append(line)
    return lines


def service_non_lanes(dev, mp, Qw, Rw, Rmw, opts, rng) -> None:
    """Phase 15, service_non_lanes: BatchModelControl over the arm written
    as a per-instance model (no lanes support), B=1024: the route of
    ``solve_batch``."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.models import Dynamics, make_dynamics
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch

    arm = make_dynamics("mahi_arm")
    per_instance = Dynamics("mahi_arm_per_instance", nx=arm.nx, nu=arm.nu,
                            f=arm.f)
    Bs = NON_LANES_BATCH
    svc = BatchModelControl(mp, batch=Bs, dynamics=per_instance, device=dev,
                            opts=SolverOptions(tol=opts.tol, max_iter=30),
                            Q=Qw, R=Rw, Rm=Rmw)
    check(svc.warm_solver == "adaptive" and svc.kkt_backend == "riccati",
          f"non-lanes service: {svc.warm_solver}, {svc.kkt_backend}")
    nx, N = mp.num_x, mp.num_shooting_nodes
    x0 = 0.2 * rng.standard_normal((Bs, nx))
    svc.set_states(x0)
    svc.set_references(0.2 * rng.standard_normal((Bs, N, nx)))
    solve_batch_fused.launches = 0
    solve_lqr_kernel_batch.launches = 0
    u = None
    for k in range(3):
        if k:
            svc.set_states(x0 + 0.01 * rng.standard_normal((Bs, nx)),
                           u_prev=u)
        u = svc.step()
        m = svc.metrics()
        emit(phase="service_non_lanes", step="cold" if k == 0 else "warm",
             batch=Bs, step_s=m["solve_s"],
             converged_frac=m["converged_frac"], mean_iters=m["mean_iters"],
             max_feas=m["max_feas"])
        check(m["converged_frac"] >= 0.9 and bool(torch.isfinite(u).all()),
              f"non-lanes service step {k}: {m}")
    check(solve_batch_fused.launches == 0
          and solve_lqr_kernel_batch.launches == 0,
          "the non-lanes route launched a kernel")


def trajgen_phase(dev) -> dict:
    """Phase 16, trajgen: the trajectory-library generator on the card
    through ``solve_batch``, each case with ``kkt_backend="auto"`` (the
    scan) and ``"pallas"`` (the Riccati kernel at N=40).  Returns what the
    kernels line reports of the Riccati kernel here."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch.examples.trajectory_library import (
        OPTS, demo_waypoints, make_generator)
    from mahi_mpc_tpu_torch.models import make_step
    from mahi_mpc_tpu_torch.solver.riccati import solve_lqr
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch
    from mahi_mpc_tpu_torch.solver.stage_qp import build_stage_qp

    rng = np.random.default_rng(0)
    lib = np.zeros((TRAJ_WAYPOINTS, 4))
    lib[:, :2] = rng.uniform(-0.8, 0.8, (TRAJ_WAYPOINTS, 2))
    cases = (("demo", "pendulum", demo_waypoints(2), None),
             ("library", "double_pendulum", lib, 60.0))
    launches, kkt_err = 0, 0.0
    for case, model, wps, ulim in cases:
        legs = {}
        for backend in ("auto", "pallas"):
            gen = make_generator(model, TRAJ_NODES, TRAJ_DT, ulim, dev,
                                 dataclasses.replace(OPTS,
                                                     kkt_backend=backend))
            torch.cuda.synchronize()
            solve_lqr_kernel_batch.launches = 0
            t0 = time.perf_counter()
            segs = gen.generate(wps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = solve_lqr_kernel_batch.launches
            # the RK4 step's residual along each segment, in float64
            step = make_step(gen.dynamics.f, TRAJ_DT, gen.mp.integrator)
            X = torch.as_tensor(np.stack([g.X for g in segs]),
                                dtype=torch.float64)
            U = torch.as_tensor(np.stack([g.U for g in segs]),
                                dtype=torch.float64)
            nx, nu = X.shape[-1], U.shape[-1]
            xn = step(X[:, :-1].reshape(-1, nx).T, U.reshape(-1, nu).T)
            resid = (xn.T.reshape(U.shape[:2] + (nx,)) - X[:, 1:]).abs()
            status = [g.status for g in segs]
            line = dict(
                phase="trajgen", case=case, model=model, backend=backend,
                segments=len(segs), nodes=TRAJ_NODES, dt=TRAJ_DT,
                u_limit=ulim, wall_s=wall, al_rounds=gen.rounds,
                mean_iters=float(gen.iters.mean()),
                max_iters=int(gen.iters.max()),
                iters_per_round_max=gen.iters.max(axis=1).tolist(),
                statuses={str(c): status.count(c) for c in sorted(set(status))},
                worst_endpoint_err=max(g.endpoint_err for g in segs),
                worst_step_residual=float(resid.max()),
                riccati_launches=n)
            emit(**line)
            check(bool(torch.isfinite(X).all() and torch.isfinite(U).all()),
                  f"trajgen {case} {backend}: non-finite trajectory")
            if backend == "pallas":
                check(n > 0, f"trajgen {case}: the Riccati kernel never ran")
                launches += n
            else:
                check(n == 0, f"trajgen {case}: {n} Riccati launches on the "
                              f"scan")
            if case == "demo":
                check(line["worst_endpoint_err"] < 1e-3
                      and line["worst_step_residual"] < 1e-4,
                      f"trajgen demo {backend}: {line}")
            legs[backend] = (X, U)
        dx = float((legs["auto"][0] - legs["pallas"][0]).abs().max())
        du = float((legs["auto"][1] - legs["pallas"][1]).abs().max())
        # the Riccati kernel against the scan on two KKT systems of this
        # batch at N=40: the first one (the straight-line warm start, the
        # barrier's first mu) and one at the iterate the kernel's leg ended
        # at (the barrier's floor); compared after the counted runs
        pb, X0, U0 = gen.problem_batch(wps)
        full = lambda v: torch.full((X0.shape[0],), v, device=dev)
        rel = 0.0
        for X_at, U_at, mu in ((X0, U0, OPTS.mu_init),
                               (legs["pallas"][0], legs["pallas"][1],
                                max(OPTS.mu_min, 0.1 * OPTS.tol))):
            qp = build_stage_qp(gen.problem, X_at.to(dev, X0.dtype),
                                U_at.to(dev, U0.dtype), pb, full(mu),
                                full(1e-8))
            k, ref = solve_lqr(qp, "pallas"), solve_lqr(qp, "riccati")
            rel = max([rel] + [float(((a - b).abs().amax(dim=(1, 2))
                                      / b.abs().amax(dim=(1, 2))).max())
                               for a, b in ((k.dz, ref.dz), (k.du, ref.du))])
        kkt_err = max(kkt_err, rel)
        emit(phase="trajgen_backends", case=case, model=model,
             max_abs_dx=dx, max_abs_du=du, kkt_nodes=TRAJ_NODES,
             kkt_max_rel_err_kernel_vs_scan=rel)
        check(rel <= TRAJ_KKT_BAND,
              f"trajgen {case}: Riccati kernel vs scan {rel} > "
              f"{TRAJ_KKT_BAND} of max|ref|")
        if case == "demo":
            check(max(dx, du) <= TRAJ_BACKEND_BAND,
                  f"trajgen demo: backends differ by {max(dx, du)} > "
                  f"{TRAJ_BACKEND_BAND}")
    return dict(launches=launches, max_rel_err_n40=kkt_err)


def batch_scenarios_phase(dev) -> int:
    """Phase 17, batch_scenarios: the example at its defaults inside
    ``device_trace`` (the example wraps each step in ``annotate``).
    Returns the fused kernel's launches."""
    import tempfile

    from mahi_mpc_tpu_torch.examples.batch_scenarios import run
    from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused
    from mahi_mpc_tpu_torch.utils import device_trace

    with tempfile.TemporaryDirectory() as tmp:
        solve_batch_fused.launches = 0
        with device_trace(tmp, device=dev):
            out = run(device=dev)
        launches = solve_batch_fused.launches
        (trace,) = [p.read_bytes() for p in Path(tmp).glob("trace_*.json")]
    # The group kernel's events in the trace and their device time, read
    # from the file (the profiler's own key_averages() takes minutes over
    # the ~1.5 M events of the eager plant).
    durs = re.findall(rb'"cat":\s*"kernel",\s*"name":\s*"[^"]*fused_sqp_group'
                      rb'_kernel[^"]*",[^{}]*?"dur":\s*([0-9.]+)', trace)
    line = dict(
        phase="batch_scenarios", batch=out["last"]["batch"],
        steps=SCENARIO_STEPS, seconds=out["seconds"],
        solve_s=out["last"]["solve_s"],
        converged_frac_cold=out["cold"]["converged_frac"],
        converged_frac_last=out["last"]["converged_frac"],
        mean_iters_last=out["last"]["mean_iters"],
        within_0p05_rad=out["within_frac"],
        median_err0=out["median_err0"], median_err=out["median_err"],
        launches=launches, trace_mbytes=len(trace) / 1e6,
        trace_names_fused_kernel=b"fused_sqp_group_kernel" in trace,
        trace_names_annotation=b'"step_0"' in trace,
        trace_fused_kernel_events=len(durs),
        trace_fused_kernel_device_ms=sum(float(d) for d in durs) / 1e3)
    emit(**line)
    check(line["converged_frac_cold"] >= 0.9,
          f"batch_scenarios cold: {line}")
    check(line["trace_names_fused_kernel"] and line["trace_names_annotation"],
          f"batch_scenarios: the trace misses the kernel or the label {line}")
    check(launches == SCENARIO_STEPS,
          f"batch_scenarios: {launches} fused launches for "
          f"{SCENARIO_STEPS} steps")
    return launches


def _step_timed(svc):
    """One service step between CUDA events: (controls, ms)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    u = svc.step()
    end.record()
    torch.cuda.synchronize()
    return u, start.elapsed_time(end)


def sharded_service_phase(dev, mp, Qw, Rw, Rmw, rng, warm_schedule) -> dict:
    """Phase 18, sharded_service: the main path's service (``mahi_arm``
    Euler, fixed-3 warm, B=16384, 1 cold + 10 warm steps on bench-shaped
    data) with no mesh, on a mesh of the one card, and on a mesh of the
    card twice (two shards) at B=16384 and at B=16383 (padded by one).
    Each service runs the fused kernel once a shard a step (counted from
    0 just before it) and converges >= 0.9 after every step; the one-card
    mesh's controls and plan equal the meshless service's bitwise, the
    two-shard services' within SHARD_DU_BAND with equal statuses.  Returns
    the launches and the median ms per warm step of each service."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.parallel import make_mesh
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused

    nx, N, Bs = mp.num_x, mp.num_shooting_nodes, SERVICE_BATCH
    x0 = 0.2 * rng.standard_normal((Bs, nx))
    x_des = 0.2 * rng.standard_normal((Bs, N, nx))
    perts, refs = warm_schedule(Bs, WARM_STEPS)
    opts = SolverOptions(tol=1e-4, max_iter=30, fixed_warm_iters=3)
    # Collect the earlier phases' cyclic garbage (the profiler's events of
    # phase 17) now, not in whichever timed step trips the collector.
    t0 = time.perf_counter()
    collected = gc.collect()
    gc_s = time.perf_counter() - t0

    def drive(name, mesh, B):
        svc = BatchModelControl(mp, batch=B, device=dev, mesh=mesh,
                                opts=opts, Q=Qw, R=Rw, Rm=Rmw)
        shards = svc.mesh.shape["batch"]
        svc.set_states(x0[:B])
        svc.set_references(x_des[:B])
        torch.cuda.synchronize()
        solve_batch_fused.launches = 0
        u, _ = _step_timed(svc)
        out = dict(us=[u.clone()], status=[svc.last.status.clone()],
                   conv=[svc.metrics()["converged_frac"]], ms=[])
        for i in range(WARM_STEPS):
            svc.set_states(x0[:B] + perts[i][:B], u_prev=u)
            svc.set_references(refs[i][:B])
            u, ms = _step_timed(svc)
            out["ms"].append(ms)
            out["us"].append(u.clone())
            out["status"].append(svc.last.status.clone())
            out["conv"].append(svc.metrics()["converged_frac"])
        launches = solve_batch_fused.launches
        out.update(plan=svc._U.clone(), launches=launches, shards=shards)
        emit(phase="sharded_service", service=name, batch=B, shards=shards,
             mesh=[str(d) for d in svc.mesh.devices.flat],
             ms_per_warm_step=float(np.mean(out["ms"])),
             ms_per_warm_step_median=float(np.median(out["ms"])),
             ms_per_warm_step_all=out["ms"], converged_frac_each=out["conv"],
             launches=launches)
        check(tuple(u.shape) == (B, mp.num_u)
              and bool(torch.isfinite(u).all()),
              f"sharded_service {name}: non-finite or misshapen controls")
        check(min(out["conv"]) >= 0.9,
              f"sharded_service {name}: converged_frac {out['conv']}")
        check(launches == shards * (1 + WARM_STEPS),
              f"sharded_service {name}: {launches} fused launches for "
              f"{shards} shards x {1 + WARM_STEPS} steps")
        return out

    card = make_mesh(n_batch=1, devices=[dev])
    twice = make_mesh(n_batch=2, devices=[dev, dev])
    runs = {"meshless": drive("meshless", None, Bs),
            "one_card": drive("one_card", card, Bs),
            "two_shards": drive("two_shards", twice, Bs),
            "two_shards_padded": drive("two_shards_padded", twice, Bs - 1)}
    ref = runs["meshless"]
    line = {}
    for name, r in runs.items():
        if name == "meshless":
            continue
        B = r["us"][0].shape[0]
        pairs = list(zip(r["us"] + [r["plan"]],
                         ref["us"] + [ref["plan"]]))
        du = max(float((a - b[:B]).abs().max()) for a, b in pairs)
        same = all(torch.equal(a, b[:B]) for a, b in pairs)
        st = all(torch.equal(a, b[:B]) for a, b in zip(r["status"],
                                                        ref["status"]))
        line[name] = dict(max_abs_du_vs_meshless=du, bitwise=same,
                          statuses_equal=st,
                          ms_per_warm_step_median=float(np.median(r["ms"])))
        if name == "one_card":
            check(same and st, f"sharded_service: the one-card mesh is not "
                               f"bitwise the meshless service ({du})")
        check(du <= SHARD_DU_BAND and st,
              f"sharded_service {name}: max|dU| {du} vs the meshless "
              f"service, statuses equal {st}")
    # medians: a single host stall of one step would move a mean of ten
    ms0 = float(np.median(ref["ms"]))
    emit(phase="sharded_service_compare", batch=Bs,
         gc_collect_s=gc_s, gc_collected=collected,
         meshless_ms_per_warm_step_median=ms0,
         two_shard_overhead_ms=(line["two_shards"]["ms_per_warm_step_median"]
                                - ms0),
         **line)
    return dict(launches=sum(r["launches"] for r in runs.values()),
                ms_median={k: float(np.median(r["ms"]))
                           for k, r in runs.items()})


def sharded_lanes_phase(dev, mp, Qw, Rw, Rmw, rng) -> int:
    """Phase 19, sharded_lanes: the lanes route (``warm_solver="adaptive"``,
    the Riccati kernel at (12, 4)) at B=1024 over a mesh of the card twice,
    against the unsharded service, 1 cold + LANES_WARM_STEPS warm steps:
    statuses equal and controls within LANES_SHARD_BAND after every step;
    the Riccati kernel launched once a shard an SQP iteration (counted from
    0 just before each service).  Returns the sharded service's
    launches."""
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.parallel import make_mesh
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.fused import solve_batch_fused
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch

    nx, N, B = mp.num_x, mp.num_shooting_nodes, PARITY_BATCH
    x0 = 0.2 * rng.standard_normal((B, nx))
    x_des = 0.2 * rng.standard_normal((B, N, nx))
    perts = 0.01 * rng.standard_normal((LANES_WARM_STEPS, B, nx))

    def drive(mesh):
        svc = BatchModelControl(
            mp, batch=B, device=dev, mesh=mesh,
            opts=SolverOptions(tol=1e-4, max_iter=30, warm_solver="adaptive"),
            Q=Qw, R=Rw, Rm=Rmw)
        check(svc.kkt_backend == "pallas",
              f"sharded_lanes: kkt_backend {svc.kkt_backend}")
        svc.set_states(x0)
        svc.set_references(x_des)
        solve_lqr_kernel_batch.launches = 0
        solve_batch_fused.launches = 0
        us, status, loop_iters, ms = [], [], 0, []
        u = None
        for i in range(1 + LANES_WARM_STEPS):
            if i:
                svc.set_states(x0 + perts[i - 1], u_prev=u)
            u, t = _step_timed(svc)
            ms.append(t)
            us.append(u.clone())
            status.append(svc.last.status.clone())
            loop_iters += sum(int(r.iters.max()) for r in svc._results)
            check(svc.metrics()["converged_frac"] >= 0.9,
                  f"sharded_lanes: {svc.metrics()}")
        launches = solve_lqr_kernel_batch.launches
        check(launches == loop_iters and solve_batch_fused.launches == 0,
              f"sharded_lanes: {launches} Riccati launches for {loop_iters} "
              f"shard-iterations, {solve_batch_fused.launches} fused")
        return us, status, launches, ms, svc.mesh.shape["batch"]

    ref = drive(None)
    got = drive(make_mesh(n_batch=2, devices=[dev, dev]))
    du = max(float((a - b).abs().max()) for a, b in zip(got[0], ref[0]))
    st = all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    emit(phase="sharded_lanes", batch=B, shards=got[4],
         steps=1 + LANES_WARM_STEPS, max_abs_du_vs_unsharded=du,
         statuses_equal=st, riccati_launches=got[2],
         riccati_launches_unsharded=ref[2], ms_per_step=got[3],
         ms_per_step_unsharded=ref[3])
    check(st and du <= LANES_SHARD_BAND,
          f"sharded_lanes: statuses equal {st}, max|dU| {du}")
    return got[2]


def _run_children(cmds, timeout) -> list:
    """Start every command at once (cwd the checkout, its package on the
    path, one thread each), wait for all; kill every one that is left if
    any fails or runs out of time.  Returns (seconds, last stdout line as
    JSON) for each; raises with the stderr's tail on a failure."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for c, p, (out, err) in zip(cmds, procs, outs):
        check(p.returncode == 0, f"{' '.join(c[2:])} exited {p.returncode}: "
                                 f"{err[-2000:]}")
    return [(secs, json.loads(out.strip().splitlines()[-1]))
            for out, _ in outs]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_phase() -> dict:
    """Phase 20, distributed: ``examples/distributed_solve.py`` (the
    double-pendulum problem of tests/test_distributed.py, B=16384) as two
    processes on the one card over gloo (NCCL refuses two ranks on one
    card), each solving its half on cuda:0 with the libraries this run
    built (no library in ``_build/`` may be new or rewritten), then as one
    process over NCCL at world size 1 with ``scaling_table``.  Every rank
    must exit 0; the gathered U and statuses of the two runs must agree (U
    within SHARD_DU_BAND).  Returns the children's fused launches and the
    one_chip row."""
    import tempfile

    import numpy as np

    from mahi_mpc_tpu_torch._build import BUILD_DIR

    mod = [sys.executable, "-m", "mahi_mpc_tpu_torch.examples.distributed_solve",
           "--device", "cuda", "--local-device-ids", "0", "--batch",
           str(SERVICE_BATCH)]
    libraries = lambda: {f.name: f.stat().st_mtime_ns
                         for f in BUILD_DIR.glob("*.so")}
    built = libraries()
    with tempfile.TemporaryDirectory() as tmp:
        gloo_dir, nccl_dir = Path(tmp, "gloo"), Path(tmp, "nccl")
        port = _free_port()
        gloo = _run_children(
            [mod + ["--backend", "gloo", "--coordinator", f"localhost:{port}",
                    "--num-processes", "2", "--rank", str(r), "--out",
                    str(gloo_dir)] for r in range(2)], DIST_TIMEOUT)
        port = _free_port()
        (nccl,) = _run_children(
            [mod + ["--backend", "nccl", "--coordinator", f"localhost:{port}",
                    "--num-processes", "1", "--rank", "0", "--out",
                    str(nccl_dir), "--scaling"]], DIST_TIMEOUT)
        U2, U1 = (np.load(d / "U.npy") for d in (gloo_dir, nccl_dir))
        s2, s1 = (np.load(d / "status.npy") for d in (gloo_dir, nccl_dir))
    du = float(np.abs(U2 - U1).max())
    rebuilt = sorted(set(libraries().items()) - set(built.items()))
    one_chip = nccl[1]["scaling"]["one_chip"]
    launches = sum(r["fused_launches"] for _, r in gloo) + \
        nccl[1]["fused_launches"]
    emit(phase="distributed", batch=SERVICE_BATCH,
         gloo=dict(backend=gloo[0][1]["backend"], processes=2,
                   seconds=gloo[0][0], ranks=[r for _, r in gloo]),
         nccl=dict(backend=nccl[1]["backend"], processes=1,
                   seconds=nccl[0], rank=nccl[1]),
         max_abs_du_gloo_vs_nccl=du, statuses_equal=bool((s2 == s1).all()),
         one_chip=one_chip, fused_launches=launches,
         libraries_built_by_children=rebuilt)
    check(not rebuilt, f"distributed: the children built {rebuilt}")
    check(all(r["backend"] == "gloo" and r["processes"] == 2
              and r["local_batch"] == SERVICE_BATCH // 2 for _, r in gloo),
          f"distributed: gloo ranks {gloo}")
    check(nccl[1]["backend"] == "nccl", f"distributed: {nccl}")
    check(U2.shape == (SERVICE_BATCH, 8, 2) and bool(np.isfinite(U2).all()),
          f"distributed: gathered U {U2.shape}")
    check(du <= SHARD_DU_BAND and bool((s2 == s1).all()),
          f"distributed: two ranks vs one, max|dU| {du}")
    check(min(r["converged_frac"] for _, r in gloo) >= 0.9
          and one_chip["converged_frac"] >= 0.9,
          f"distributed: converged {gloo}, {one_chip}")
    return dict(launches=launches, one_chip=one_chip)


def pariccati_phase(dev, timed) -> None:
    """Phase 21, pariccati: ``kkt_backend="pariccati"`` (the log-depth
    scans, plain PyTorch) against the scan and, where it is small, the
    dense oracle, in float64 and float32 on the card: a (12, 4) QP at B=1,
    N=25; B=16 at N=512, (6, 2) (the JAX package's long-horizon case); the
    trajgen demo's first QP at N=40, (3, 1); a (12, 4) QP at N=1000; and
    B=1024 at N=25, (12, 4), with the Riccati kernel beside them.  dz, du
    within 1e-9 of max|ref| of the scan in float64 (the dense oracle
    1e-8); in float32 within 1e-4 of the float32 scan at N=25 (reported
    only at the longer horizons, where float32 roundoff grows).  Wall ms
    (CUDA events) of the scan, pariccati and the Riccati kernel at each
    shape, float32 and float64."""
    import torch

    from mahi_mpc_tpu_torch.examples.trajectory_library import (
        OPTS, demo_waypoints, make_generator)
    from mahi_mpc_tpu_torch.solver.pariccati import solve_lqr_parallel
    from mahi_mpc_tpu_torch.solver.riccati import (solve_lqr,
                                                   solve_lqr_dense,
                                                   solve_lqr_scan)
    from mahi_mpc_tpu_torch.solver.stage_qp import StageQP, build_stage_qp

    to64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    gen = make_generator("pendulum", TRAJ_NODES, TRAJ_DT, None, dev)
    pb, X0, U0 = gen.problem_batch(demo_waypoints(2))
    full = lambda v: torch.full((X0.shape[0],), v, device=dev)
    traj = build_stage_qp(gen.problem, X0, U0, pb, full(OPTS.mu_init),
                          full(1e-8))
    cases = (("b1_n25", random_qp(1, 25, 12, 4, seed=21, to=to64), True),
             ("b16_n512", random_qp(16, 512, 6, 2, seed=22, to=to64), False),
             ("trajgen_n40", StageQP(*[a.double() for a in traj]), True),
             ("b1_n1000", random_qp(1, 1000, 12, 4, seed=23, to=to64),
              False),
             ("b1024_n25", random_qp(1024, 25, 12, 4, seed=24, to=to64),
              False))

    def rel(got, ref):
        """max over dz, du of max|got - ref| / max|ref|."""
        return max(float((g.double() - r.double()).abs().max()
                         / r.double().abs().max())
                   for g, r in ((got.dz, ref.dz), (got.du, ref.du)))

    for name, qp64, dense in cases:
        B, N = qp64.Az.shape[0], qp64.Az.shape[1]
        nz, nu = qp64.Az.shape[-1], qp64.Bz.shape[-1]
        qp32 = StageQP(*[a.float() for a in qp64])
        reps = 3 if N > 100 else 20
        s64, scan64_ms = timed(lambda: solve_lqr_scan(qp64), reps)
        p64, par64_ms = timed(lambda: solve_lqr_parallel(qp64), reps)
        s32, scan32_ms = timed(lambda: solve_lqr_scan(qp32), reps)
        p32, par32_ms = timed(lambda: solve_lqr_parallel(qp32), reps)
        k32, kernel_ms = timed(lambda: solve_lqr(qp32, "pallas"), reps)
        line = dict(phase="pariccati", case=name, batch=B, nodes=N, nz=nz,
                    nu=nu, f64_rel_err_vs_scan=rel(p64, s64),
                    f32_rel_err_vs_scan_f32=rel(p32, s32),
                    f32_rel_err_vs_scan_f64=rel(p32, s64),
                    f32_scan_rel_err_vs_scan_f64=rel(s32, s64),
                    f32_kernel_rel_err_vs_scan_f64=rel(k32, s64),
                    scan_ms_f64=scan64_ms, pariccati_ms_f64=par64_ms,
                    scan_ms_f32=scan32_ms, pariccati_ms_f32=par32_ms,
                    kernel_ms_f32=kernel_ms,
                    pariccati_over_scan_f32=par32_ms / scan32_ms)
        if dense:
            line["f64_rel_err_vs_dense"] = rel(p64, solve_lqr_dense(qp64))
        emit(**line)
        check(line["f64_rel_err_vs_scan"] <= 1e-9,
              f"pariccati {name}: float64 {line['f64_rel_err_vs_scan']}")
        check(line.get("f64_rel_err_vs_dense", 0.0) <= 1e-8,
              f"pariccati {name}: vs dense {line}")
        if N == 25:
            check(line["f32_rel_err_vs_scan_f32"] <= 1e-4,
                  f"pariccati {name}: float32 {line}")


def time_shard_phase(dev) -> None:
    """Phase 22, time_shard: ``solve_lqr_time_sharded`` over a ``time``
    mesh of the card repeated T = 2 and 4, at N=24 and N=1000 ((6, 2)
    QPs, float64): dz, du within 1e-9 of max|ref| of the scan; then one
    SQP ``solve`` of tests/test_time_shard.py:65-94's double pendulum with
    the registered backend against ``kkt_backend="riccati"`` (both
    converged, U within 1e-7)."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
    from mahi_mpc_tpu_torch.models import make_double_pendulum
    from mahi_mpc_tpu_torch.parallel import (enable_time_shard_backend,
                                             make_mesh,
                                             solve_lqr_time_sharded)
    from mahi_mpc_tpu_torch.solver import solve
    from mahi_mpc_tpu_torch.solver.riccati import solve_lqr_scan
    from mahi_mpc_tpu_torch.transcribe.shooting import (default_params,
                                                        make_problem)

    to64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    for T in (2, 4):
        mesh = make_mesh(n_batch=1, n_time=T, devices=[dev] * T)
        for N in (24, 1000):
            qp = random_qp(1, N, 6, 2, seed=30 + N, to=to64)
            ref = solve_lqr_scan(qp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = solve_lqr_time_sharded(qp, mesh)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            err = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in ((got.dz, ref.dz), (got.du, ref.du)))
            emit(phase="time_shard", time_shards=T, nodes=N,
                 rel_err_vs_scan=err, wall_ms=wall)
            check(err <= 1e-9, f"time_shard T={T} N={N}: {err}")

    name = enable_time_shard_backend(make_mesh(n_batch=1, n_time=4,
                                               devices=[dev] * 4))
    N = 24
    mp = ModelParameters("ts_e2e", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=N, u_min=[-5.0, -5.0],
                         u_max=[5.0, 5.0])
    prob = make_problem(mp, make_double_pendulum())
    rng = np.random.default_rng(1)
    p = default_params(mp, dtype=torch.float64, device=dev)._replace(
        q=to64([10.0, 1.0, 5.0, 5.0]), r=to64([5.0, 5.0]),
        rm=to64([0.1, 0.1]), x_des=to64(0.3 * rng.standard_normal((N, 4))),
        x0=to64([0.1, -0.05, 0.0, 0.0]))
    kw = dict(tol=1e-8, max_iter=60, dtype="float64")
    t0 = time.perf_counter()
    ref = solve(prob, p, opts=SolverOptions(kkt_backend="riccati", **kw))
    t1 = time.perf_counter()
    got = solve(prob, p, opts=SolverOptions(kkt_backend=name, **kw))
    t2 = time.perf_counter()
    du = float((got.U - ref.U).abs().max())
    emit(phase="time_shard_solve", backend=name, time_shards=4, nodes=N,
         status=int(got.status), status_riccati=int(ref.status),
         iters=int(got.iters), iters_riccati=int(ref.iters),
         max_abs_du=du, wall_s=t2 - t1, wall_s_riccati=t1 - t0)
    check(int(got.status) == 0 and int(ref.status) == 0 and du <= 1e-7,
          f"time_shard solve: statuses {int(got.status)}, "
          f"{int(ref.status)}, max|dU| {du}")


# Phase 23's user models: Dynamics as a user writes them (a
# lanes-polymorphic f and no CUDA form of their own), each served by a
# fused-kernel instantiation generated from its traced f and built at
# first use (models/codegen.py, solver/target.py `kernel_target`), and the
# LTV step at two shapes outside the four hand-written ones.
GEN_WARM_STEPS = 3                # warm service steps a generated case
GEN_B1_CALLS = 20                 # warm calc_u of Van der Pol, B=1
CHAIN4_B1_CALLS = 200             # warm calc_u of the 4-DOF chain, B=1
GEN_DT = 0.02
VDP_MU = 1.0
# The generated nq-row cart-pole against the hand-written FastNq<Cartpole>
# on the same inputs: the same expression trees, so a difference is only
# nvcc's contraction of either.
GEN_HAND_BAND = 1e-5


def user_dynamics() -> dict:
    """Phase 23's cases: {name: (Dynamics, integrator, is_linear, |u|
    bound)}.  A Van der Pol oscillator (first order, RK4), a kinematic
    unicycle (first order, Euler), the cart-pole's own f given as a user
    model with nq = 2 and no closed form (the nq-row step over a generated
    acc), a chain of nq pendulums coupled by springs at nq = 4 under Euler
    (nx = 8, nu = 4: a user's 4-DOF model at the exoskeleton's shape, the
    nq-row step with more controls than its two lanes), and LTV at (6, 3)
    and (12, 6): the chain at nq = 3 and 6, frozen at each instance's
    state."""
    import torch

    from mahi_mpc_tpu_torch.models import make_dynamics
    from mahi_mpc_tpu_torch.models.base import Dynamics

    def vdp(x, u):
        return torch.stack([x[1], VDP_MU * (1.0 - x[0] * x[0]) * x[1] - x[0]
                            + u[0]])

    def unicycle(x, u):
        return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]),
                            u[1]])

    def chain(nq):
        def f(x, u):
            q, qd = x[:nq], x[nq:]
            left = torch.cat([q[:1], q[:-1]])
            right = torch.cat([q[1:], q[-1:]])
            return torch.cat([qd, u - torch.sin(q) - 0.1 * qd
                              + 0.5 * ((left - 2.0 * q) + right)])
        return Dynamics(f"user_chain{nq}", 2 * nq, nq, f,
                        supports_lanes=True, nq=nq)

    return {
        "user_vdp": (Dynamics("user_vdp", 2, 1, vdp, supports_lanes=True),
                     "rk4", False, 5.0),
        "user_unicycle": (Dynamics("user_unicycle", 3, 2, unicycle,
                                   supports_lanes=True), "euler", False, 2.0),
        "user_cartpole": (Dynamics("user_cartpole", 4, 1,
                                   make_dynamics("cartpole").f,
                                   supports_lanes=True, nq=2),
                          "euler", False, 60.0),
        "user_chain4": (chain(4), "euler", False, 20.0),
        "ltv_6x3": (chain(3), "euler", True, 20.0),
        "ltv_12x6": (chain(6), "euler", True, 20.0)}


def user_problem(name, dyn, integrator, is_linear, ulim):
    """(ModelParameters, problem) of a phase-23 case at N=25, dt=20 ms."""
    from mahi_mpc_tpu_torch import ModelParameters
    from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

    mp = ModelParameters(f"smoke_{name}", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=GEN_DT, num_shooting_nodes=N_NODES,
                         u_min=[-ulim] * dyn.nu, u_max=[ulim] * dyn.nu,
                         integrator=integrator, is_linear=is_linear)
    return mp, make_problem(mp, dyn)


def generated_batch(dev, rng, name, B):
    """(problem, params) of B instances of a phase-23 case
    (``user_problem``: N=25, dt=20 ms) with ``model_batch``'s bench-shaped
    data: Q = 10, R = 0.1, Rm = 0.01, x0 and x_des ~ 0.2 N(0, 1); an LTV
    case frozen at each instance's (x0, u_prev)."""
    import numpy as np
    import torch
    from torch.func import vmap

    from mahi_mpc_tpu_torch.ops.precision import strict_fp32
    from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                        default_params)

    dyn, integrator, is_linear, ulim = user_dynamics()[name]
    mp, prob = user_problem(name, dyn, integrator, is_linear, ulim)
    nx, nu, N = dyn.nx, dyn.nu, mp.num_shooting_nodes
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    p = default_params(mp, device=dev)._replace(
        q=f32([10.0] * nx), r=f32([0.1] * nu), rm=f32([0.01] * nu))
    ex = lambda a: a.expand((B,) + a.shape).clone()
    p = MPCParams(*[type(f)(*[ex(a) for a in f]) if isinstance(f, tuple)
                    else ex(f) for f in p])
    p = p._replace(x0=f32(0.2 * rng.standard_normal((B, nx))),
                   x_des=f32(0.2 * rng.standard_normal((B, N, nx))))
    if is_linear:
        with strict_fp32():
            A, Bm, xd0 = vmap(dyn.linearize)(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, Bm, xd0, p.x0, p.u_prev))
    return prob, p


def followable_reference(dyn, integrator, x0, rng, ulim):
    """x_des (B, N, nx) that instance b can follow: the model's own
    rollout from x0[b] (float64, on the host) under a smooth control,
    a + 0.5 a sin(2 pi t + phase) with a ~ 0.3 N(0, 1) within |u| / 2."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch.models.integrators import make_step

    B = x0.shape[0]
    step = make_step(dyn.f, GEN_DT, integrator)
    amp = np.clip(0.3 * rng.standard_normal((dyn.nu, B)), -ulim / 2,
                  ulim / 2)
    phase = rng.uniform(0.0, 2 * np.pi, (1, B))
    x = torch.as_tensor(x0.T, dtype=torch.float64)
    out = []
    for k in range(N_NODES):
        u = amp * (1.0 + 0.5 * np.sin(2 * np.pi * k * GEN_DT + phase))
        x = step(x, torch.as_tensor(u, dtype=torch.float64))
        out.append(x.T.numpy())
    return np.stack(out, axis=1)


def generated_libraries() -> dict:
    """{case: generated library name} of phase 23, registered (traced and
    lowered here) so that the build phase starts their nvcc with the
    others."""
    from mahi_mpc_tpu_torch.solver.target import kernel_target

    names = {}
    for name, (dyn, integrator, is_linear, ulim) in user_dynamics().items():
        target = kernel_target(user_problem(name, dyn, integrator, is_linear,
                                            ulim)[1])
        check(target.unit is not None,
              f"{name}: a hand-written instantiation serves it")
        names[name] = target.cuda
    return names


def generated_phase(dev, rng, timed, builds, gen_libs, clock_mhz) -> list:
    """Phase 23, generated: each user model (and LTV shape) of
    ``user_dynamics`` through ``BatchModelControl`` at B=16384 (1 cold + 3
    warm steps, its generated library's launches counted from 0), then
    its fixed-3 warm solve held to the plain version within 1e-4 (the
    user cart-pole also to the hand-written FastNq<Cartpole> within
    1e-5), timed (wrapper by CUDA events, the kernel's device ms by the
    profiler), with the bound (the generated build's own operation count,
    ``mpc_fused_count_ops``), ptxas line, blocks an SM and nvcc seconds;
    an adaptive cold solve, timed, its converged share printed; then
    ``generate_model`` + ``ModelControl`` of the Van der Pol model (20 warm
    ``calc_u``) and of the 4-DOF chain (200) at B=1 on the block body
    (``generated_model_control``).  Returns the kernels line's entries."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.models import make_dynamics
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.fused import (card_body, count_fused_ops,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)
    from mahi_mpc_tpu_torch.solver.target import kernel_target
    from mahi_mpc_tpu_torch.transcribe.shooting import make_problem

    Bs = SERVICE_BATCH
    opts = SolverOptions(tol=1e-4, max_iter=12)
    opts_cold = SolverOptions(tol=1e-4, max_iter=30)
    svc_opts = SolverOptions(tol=1e-4, max_iter=30, fixed_warm_iters=3)
    mu_warm = opts.warm_mu_factor * opts.tol
    frac = lambda m: m.float().mean().item()
    entries = []
    for name, (dyn, integrator, is_linear, ulim) in user_dynamics().items():
        mp, prob = user_problem(name, dyn, integrator, is_linear, ulim)
        lib = kernel_target(prob).cuda
        check(lib == gen_libs[name], f"{name}: library {lib}")
        kernel_of = fused_instantiation(builds, prob)
        nx, nu = dyn.nx, dyn.nu
        Qw = [10.0] * nx
        svc = BatchModelControl(mp, batch=Bs, dynamics=dyn, device=dev,
                                opts=svc_opts, Q=Qw, R=[0.1] * nu,
                                Rm=[0.01] * nu)
        check(svc.warm_solver == "fused", f"{name}: {svc.warm_solver}")
        # each instance tracks a path its model can follow, from near its
        # start
        x0 = 0.2 * rng.standard_normal((Bs, nx))
        svc.set_references(followable_reference(dyn, integrator, x0, rng,
                                                ulim))
        svc.set_states(x0 + 0.02 * rng.standard_normal((Bs, nx)))
        # the main path: the service's steps, counted from 0 (in LTV the
        # user chain's linearization and the discretization, from the same
        # generated library, once a step)
        n0 = solve_batch_fused.launches
        c0 = ltv_counts()
        u = svc.step()
        cold_m = svc.metrics()
        for _ in range(GEN_WARM_STEPS):
            svc.set_states(x0 + 0.02 * rng.standard_normal((Bs, nx)),
                           u_prev=u)
            u = svc.step()
        torch.cuda.synchronize()
        launches = solve_batch_fused.launches - n0
        ltv_n = tuple(int(v) for v in np.subtract(ltv_counts(), c0))
        m = svc.metrics()
        check(launches == 1 + GEN_WARM_STEPS, f"{name}: launches {launches}")
        steps = 1 + GEN_WARM_STEPS
        check(ltv_n == ((steps, steps, 0, 0) if is_linear else (0, 0, 0, 0)),
              f"{name}: LTV kernel launches and plain calls {ltv_n}")
        LTV_PATH["linearize_launches"] += ltv_n[0]
        LTV_PATH["ltv_discrete_launches"] += ltv_n[1]
        check(tuple(u.shape) == (Bs, nu) and bool(torch.isfinite(u).all()),
              f"{name}: non-finite or misshapen controls")
        # the kernel against its plain version on the service's inputs (its
        # last relinearization in LTV), from its plan
        p, X, U = svc._p, svc._X, svc._U
        p2 = p._replace(x0=p.x0 + 0.01)
        warm3 = lambda solve: solve(prob, p2, X, U, opts, mu0=mu_warm,
                                    n_iter=3)
        cold = lambda: solve_batch_fused(prob, p, None, None, opts_cold,
                                         mu0=opts_cold.mu_init, adaptive=True)
        ct, cold_ms = timed(cold, 1)
        wk, warm_ms = timed(lambda: warm3(solve_batch_fused), 10)
        wp, plain_ms = timed(lambda: warm3(solve_batch_fused_plain), 1)
        err = max((wk.X - wp.X).abs().max().item(),
                  (wk.U - wp.U).abs().max().item())
        prof = profile_step(lambda: [warm3(solve_batch_fused)
                                     for _ in range(5)], "fused_sqp", 5)
        check(prof["kernel_count"] == 5,
              f"{name}: {prof['kernel_count']} kernel launches for 5 solves")
        device_ms = prof["kernel_device_ms"] / 5
        S = COUNT_SAMPLE
        counted = count_fused_ops(prob, head(p2, S), X[:S], U[:S], opts,
                                  mu0=mu_warm, n_iter=3,
                                  body=card_body(prob)[0])
        ops = sum(counted["minimum"].values()) / S
        io = fused_io_bytes(p, X, U, Bs) + (
            4 * Bs * (nx * nx + nx * nu + nx) if is_linear else 0)
        bound = bound_ms(ops * Bs, io)
        line = dict(
            phase="generated", case=name, integrator=integrator,
            is_linear=is_linear, nx=nx, nu=nu, batch=Bs,
            nvcc_s=builds[lib][2], **kernel_of,
            service_launches=launches,
            service_cold_converged_frac=cold_m["converged_frac"],
            service_warm_converged_frac=m["converged_frac"],
            fixed3_warm_max_abs_dxu=err,
            fixed3_warm_status_agree=frac(wk.status == wp.status),
            fixed3_warm_kernel_ms=warm_ms,
            fixed3_warm_kernel_device_ms=device_ms,
            fixed3_warm_plain_ms=plain_ms,
            fixed3_ops_per_instance=ops, io_mbytes=io / 1e6,
            fixed3_warm_bound_ms=bound["bound_ms"],
            fixed3_warm_bound_by=bound["bound_by"],
            fixed3_warm_device_roofline_share=bound["bound_ms"] / device_ms,
            adaptive_cold_kernel_ms=cold_ms,
            adaptive_cold_converged=frac(ct.status == 0),
            adaptive_cold_mean_iters=frac(ct.iters),
            kernel=[k[0] for k in prof["top_kernels"]
                    if "fused_sqp" in k[0]][0])
        if name == "user_cartpole":
            # the same problem through the hand-written FastNq<Cartpole>
            hand = make_problem(mp, make_dynamics("cartpole"))
            check(kernel_target(hand).cuda == "fused_sqp_models",
                  f"cart-pole: {kernel_target(hand).cuda}")
            wh = solve_batch_fused(hand, p2, X, U, opts, mu0=mu_warm,
                                   n_iter=3)
            torch.cuda.synchronize()
            line.update(
                hand_written_max_abs_dxu=max(
                    (wh.X - wk.X).abs().max().item(),
                    (wh.U - wk.U).abs().max().item()),
                hand_written_bitwise=bool(torch.equal(wh.X, wk.X)
                                          and torch.equal(wh.U, wk.U)))
        emit(**line)
        check(err <= 1e-4, f"{name}: fixed-3 warm {err} > 1e-4")
        check(line["fixed3_warm_status_agree"] >= 0.99,
              f"{name}: statuses agree on {line['fixed3_warm_status_agree']}")
        if "hand_written_max_abs_dxu" in line:
            check(line["hand_written_max_abs_dxu"] <= GEN_HAND_BAND,
                  f"{name}: {line['hand_written_max_abs_dxu']} from "
                  f"FastNq<Cartpole>")
        body, width = line["card_body"]
        entries.append(dict(
            name=f"fused_sqp_generated:{name}", route="cuda",
            source="mahi_mpc_tpu_torch/csrc/" + (
                "fused_sqp_group.cuh" if body == "group" else "fused_sqp.cuh"),
            generator="mahi_mpc_tpu_torch/models/codegen.py"
            if not is_linear else "mahi_mpc_tpu_torch/solver/fused.py",
            replaces="mahi_mpc_tpu/solver/fused.py:186",
            launches=launches, max_abs_err=err, ms=warm_ms,
            device_ms=device_ms, plain_ms=plain_ms,
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            library_ms=None, library=lib, card_body=[body, width],
            registers=line["registers"],
            spill_store_bytes=line["spill_store_bytes"],
            blocks_per_sm=line["blocks_per_sm"], nvcc_s=line["nvcc_s"],
            batch=Bs, mode=f"fixed-3 warm, {name} {integrator}"
            + (" LTV" if is_linear else ""),
            adaptive_cold_converged=line["adaptive_cold_converged"]))

    # ---- the single-instance runtime of a user's model: generate_model
    # builds its library (the reference's gcc step), ModelControl loads it
    # and runs it at B=1 on the block body (a cold solve of the chain took
    # 35 iterations in float32 on the CPU: the cap is 60)
    b1_opts = SolverOptions(tol=1e-4, max_iter=60, fixed_warm_iters=3)
    entries.append(generated_model_control(
        dev, "user_vdp", GEN_B1_CALLS, np.array([1.0, 0.0]),
        lambda mp, t: np.zeros((mp.num_shooting_nodes, mp.num_x)),
        dict(Q=[10.0] * 2, R=[0.1], Rm=[0.0]), b1_opts, builds,
        gen_libs, timed, clock_mhz))
    chain_mp = user_problem("user_chain4", *user_dynamics()["user_chain4"])[0]
    entries.append(generated_model_control(
        dev, "user_chain4", CHAIN4_B1_CALLS,
        arm_reference(chain_mp, -chain_mp.step_size)[0], arm_reference,
        dict(Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4, Rm=[0.0] * 4),
        b1_opts, builds, gen_libs, timed, clock_mhz, TRACK_BAND))
    return entries


def generated_model_control(dev, name, n_warm, x_start, reference, weights,
                            opts, builds, gen_libs, timed, clock_mhz,
                            track_band=None) -> dict:
    """Phase 23's single-instance runtime of user model ``name`` (a case of
    ``user_dynamics``): ``generate_model`` into a temporary directory (it
    must name the model's generated library), ``ModelControl`` loaded
    from it with ``weights``, one cold and ``n_warm`` warm ``calc_u`` in
    closed loop on the model's own step from ``x_start``, following
    ``reference(mp, t)`` (N, nx): the rule's body at B=1 must be the block
    body, every warm call one launch of the model's library on it, no
    failure, the cold plan converged, no warm plan diverged, and with
    ``track_band`` |q - q_des| below it over the last half; ``calc_u``
    p50 / p99 ms.  Then the B=1 warm solve (fixed-3 and adaptive) held to
    its plain version, the block kernel's device ms a fixed-3 launch
    (``kernel_event_ms``) and in 20 ``calc_u`` under the profiler, the
    plain version's ms, the bound and the chain bound at B=1, and the
    block kernel's registers, spills and shared memory.
    Returns the kernels line's entry."""
    import tempfile

    import numpy as np
    import torch

    from mahi_mpc_tpu_torch._build import cuda_build
    from mahi_mpc_tpu_torch.models.integrators import make_step
    from mahi_mpc_tpu_torch.runtime import ModelControl, generate_model
    from mahi_mpc_tpu_torch.solver.fused import (card_body, count_fused_ops,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)
    from mahi_mpc_tpu_torch.solver.target import kernel_target

    dyn, integrator, _, ulim = user_dynamics()[name]
    mp, _ = user_problem(name, dyn, integrator, False, ulim)
    mp = dataclasses.replace(mp, name=name)
    lib = gen_libs[name]
    step = make_step(dyn.f, mp.step_size, integrator)
    plant = lambda x, u: step(
        torch.as_tensor(x, dtype=torch.float64)[:, None],
        torch.as_tensor(u, dtype=torch.float64)[:, None])[:, 0].numpy()
    nq = mp.num_x // 2
    bodies = solve_batch_fused.body_launches
    with tempfile.TemporaryDirectory() as d:
        man = json.loads(generate_model(mp, dynamics=dyn, directory=d,
                                        opts=opts, device=dev).read_text())
        check(man["warm_solver"] == "fused" and list(man["libraries"]) ==
              [lib], f"{name} manifest: {man}")
        mc = ModelControl(name, directory=d, dynamics=dyn, device=dev,
                          **weights)
        # the library generate_model built is the one ModelControl launches
        check(mc.warm_solver == "fused" and kernel_target(mc.problem).cuda
              == lib
              and cuda_build(lib)[0]._name == man["libraries"][lib],
              f"ModelControl {name}: {mc.warm_solver}, {man}")
        body = card_body(mc.problem, 1)
        check(body == ("block", 256), f"{name} at B=1 on {body}")
        x, u = np.asarray(x_start, dtype=np.float64), np.zeros(mp.num_u)
        n0 = solve_batch_fused.launches
        bodies.update(thread=0, group=0, block=0)
        plans, errs = [], []
        for k in range(1 + n_warm):
            t = k * mp.step_size
            ref = reference(mp, t)
            plans.append(mc.calc_u(t, x, u, ref))
            u = plans[-1].U[0]
            x = plant(x, u)
            errs.append(float(np.abs(x[:nq] - ref[0, :nq]).max()))
        torch.cuda.synchronize()
        launches, on_body = solve_batch_fused.launches - n0, dict(bodies)
        warm = plans[1:]
        lat = np.array([pl.solve_time_s for pl in warm]) * 1e3
        st = np.array([pl.status for pl in warm])
        summ = mc.stats.summary()
        line = dict(case=name, library=lib, card_body=list(body),
                    cold_status=plans[0].status,
                    cold_s=plans[0].solve_time_s, warm_calls=n_warm,
                    launches=launches, body_launches=on_body,
                    calc_u_p50_ms=float(np.percentile(lat, 50)),
                    calc_u_p99_ms=float(np.percentile(lat, 99)),
                    warm_converged=float((st == 0).mean()),
                    max_track_err_last_half=float(np.max(
                        errs[len(errs) // 2:])),
                    final_state=x.tolist(), **summ)
        check(launches == n_warm and on_body["block"] == n_warm
              and plans[0].status == 0 and summ["failures"] == 0
              and bool((st != 2).all()) and bool(np.isfinite(x).all())
              and (track_band is None
                   or line["max_track_err_last_half"] < track_band),
              f"ModelControl {name}: {line}")
        # the B=1 warm solve, next state the last plan predicts
        t_last = (n_warm + 1) * mp.step_size
        x1, u1 = mc._X0[1].cpu().numpy(), mc._U0[0].cpu().numpy()
        ref_last = reference(mp, t_last)
        p1 = calc_u_params(mc, t_last, x1, u1)._replace(
            x_des=mc._tensor(ref_last)[None])
        b1 = {mode: held_b1(mc, p1, kw) for mode, kw in (
            ("fixed3", dict(n_iter=3)), ("adaptive", dict(adaptive=True)))}
        X1, U1, mu = mc._X0[None], mc._U0[None], mc._mu_warm
        event_ms = kernel_event_ms(lambda: solve_batch_fused(
            mc.problem, p1, X1, U1, mc.opts, mu0=mu, n_iter=3))
        prof = profile_step(lambda: [mc.calc_u(t_last, x1, u1, ref_last)
                                     for _ in range(20)],
                            FUSED_ENTRIES["block"], 20)
        check(prof["kernel_count"] == 20,
              f"{name}: {prof['kernel_count']} block kernel launches for 20 "
              f"calc_u: {prof['top_kernels']}")
        device_ms = prof["kernel_device_ms"] / prof["kernel_count"]
        _, plain_ms = timed(lambda: solve_batch_fused_plain(
            mc.problem, p1, X1, U1, mc.opts, mu0=mu, n_iter=3), 3)
        # the block body computes the group body's function: its minimum
        ops = count_fused_ops(mc.problem, p1, X1, U1, mc.opts, mu0=mu,
                              n_iter=3, body="group")
        bound = bound_ms(sum(ops["minimum"].values()),
                         fused_io_bytes(p1, X1, U1, 1))
        chain = chain_bound(mc.problem, p1, X1, U1, mc.opts, mu,
                            dict(n_iter=3), clock_mhz)
        kernel = block_kernel_info(builds, mc.problem, mc.problem.N)
        line.update(max_abs_dxu_fixed3=b1["fixed3"],
                    max_abs_dxu_adaptive=b1["adaptive"],
                    kernel_device_ms=device_ms,
                    block_event_ms=event_ms,
                    plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"], **chain,
                    kernel_share_of_calc_u_p50=device_ms
                    / line["calc_u_p50_ms"], block_kernel=kernel,
                    calc_u_profiled={k: prof[k] for k in (
                        "wall_ms", "device_ms", "kernel_device_ms",
                        "kernel_count", "device_busy_share")})
        emit(phase="generated_model_control", **line)
    return dict(
        name=f"fused_sqp_generated_block:{name}", route="cuda",
        source="mahi_mpc_tpu_torch/csrc/fused_sqp_block.cuh",
        generator="mahi_mpc_tpu_torch/models/codegen.py",
        replaces="mahi_mpc_tpu/solver/fused.py:186",
        launches=n_warm, max_abs_err=max(b1.values()), ms=device_ms,
        device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
        bound_by=bound["bound_by"], library_ms=None,
        chain_bound_ms=chain["chain_bound_ms"], library=lib,
        card_body=list(body), batch=1,
        mode=f"ModelControl {name} {integrator}, B=1: {n_warm} fixed-3 warm "
             f"calc_u (block body)",
        block_event_ms=event_ms, calc_u_p50_ms=line["calc_u_p50_ms"],
        calc_u_p99_ms=line["calc_u_p99_ms"],
        registers=kernel["registers"],
        spill_store_bytes=kernel["spill_store_bytes"],
        smem_bytes=kernel["smem_bytes"], nvcc_s=builds[lib][2])


def ltv_kernel_entries(ltv) -> list:
    """The kernels line's entries of the LTV path's two kernels: their
    launches on the main paths (``LTV_PATH``), the worst error against the
    plain version over ``LTV_*_CASES``, the launch's ms (CUDA events around
    the launcher) against the plain version's at B=16384, the bound,
    registers, spills and blocks an SM; the LTV service's and ModelControl's
    readings beside them."""
    keys = ("max_rel_err", "wrapper_ms", "share", "ops_per_instance",
            "io_mbytes", "registers", "spill_store_bytes", "blocks_per_sm",
            "tile", "ms_b1", "plain_ms_b1", "ms_turns", "plain_ms_turns",
            "ms_b1_turns", "cases")
    svc = {k: LTV_PATH.get(k) for k in (
        "service_ms_per_warm_step", "relinearize_ms", "relinearize_plain_ms",
        "service_discrete_ms", "service_discrete_kernel_ms",
        "service_routes_max_abs_du", "calc_u_p50_ms", "calc_u_p99_ms",
        "calc_u_wall_p50_ms", "calc_u_wall_p99_ms")}
    out = []
    for kind, name, replaces, mode in (
            ("linearize", "ltv_linearize",
             "mahi_mpc_tpu/runtime/batch_service.py:122",
             "mahi_arm at B=16384, the folded columns, a thread a joint's "
             "columns, the tile staged through shared memory "
             "(jax.jit(jax.vmap(dynamics.linearize)); no pl.pallas_call)"),
            ("ltv_discrete", "ltv_discrete",
             "mahi_mpc_tpu/solver/batched.py:58",
             "(8, 4) Euler at B=16384, Ad - I, Bd, cd batch-innermost, a "
             "thread a column, the tile staged through shared memory "
             "(_ltv_discrete; no pl.pallas_call)")):
        k = ltv[kind]
        out.append({
            "name": name, "route": "cuda",
            "source": "mahi_mpc_tpu_torch/csrc/model_linearize.cuh",
            "replaces": replaces,
            "launches": LTV_PATH[f"{kind}_launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "batch": k["batch"], "mode": mode,
            **{key: k[key] for key in keys}, **svc})
    out[1]["ptxas_12x6"] = ltv["ltv_discrete"]["ptxas_12x6"]
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
    from mahi_mpc_tpu_torch._build import cpu_build_all, cuda_build_all
    from mahi_mpc_tpu_torch.models import make_dynamics
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.fused import (count_fused_ops,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)
    from mahi_mpc_tpu_torch.solver.riccati_kernel import \
        solve_lqr_kernel_batch
    from mahi_mpc_tpu_torch.solver.target import ARM_IDS
    from mahi_mpc_tpu_torch.transcribe.shooting import (MPCParams,
                                                        default_params,
                                                        make_problem)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build: one nvcc per library (phase 23's generated ones too),
    # started together, and beside them g++'s operation counters
    # (csrc/flop_count.cpp and each generated library's build) for the
    # bounds, with the g++ build that prepares their inputs
    t_gen = time.perf_counter()
    gen_libs = generated_libraries()
    emit(phase="generate", seconds=time.perf_counter() - t_gen,
         libraries=gen_libs)
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        counter = ex.submit(cpu_build_all, ["flop_count", "fused_sqp",
                                            *gen_libs.values()])
        builds = cuda_build_all(extra=list(gen_libs.values()))
        counter.result()
    emit(phase="build", seconds=time.perf_counter() - t_build,
         seconds_each={name: b[2] for name, b in builds.items()},
         ptxas={name: ptxas_summary(b[1]) for name, b in builds.items()})
    # the main path's instantiation: four threads an instance
    group = [k for k in ptxas_summary(builds["fused_sqp"][1])
             if "fused_sqp_group_kernel" in k["kernel"]]
    per_sm = {nq: builds["fused_sqp"][0].mpc_fused_blocks_per_sm(
        ARM_IDS[nq], 2 * nq, nq, 0, 0) for nq in (2, 4)}
    emit(phase="group_kernel", threads_per_instance=4, instances_per_block=32,
         blocks_per_sm=per_sm, ptxas=group)
    check(len(group) == 2 and min(per_sm.values()) > 0,
          f"group kernel: {len(group)} instantiations, blocks/SM {per_sm}")
    # beside it the arm under RK4 (``Generic<ArmModel<4>>``), whose
    # dual-number passes run the chain's code (``arm_chain``) as well
    _, rk4_arm, _ = model_batch(dev, np.random.default_rng(0), "mahi_arm", 1,
                                integrator="rk4")
    emit(phase="group_kernel_rk4_arm", **fused_instantiation(builds, rk4_arm))
    # the Riccati kernel: a group of threads an instance, every stage shape
    ric_lib = builds["riccati"][0]
    ric_k = {tuple(k["template_args"]): k
             for k in ptxas_summary(builds["riccati"][1])
             if "riccati_group_kernel" in k["kernel"]}
    for (nz, nu), k in sorted(ric_k.items(), reverse=True):
        k.update(smem_bytes=ric_lib.mpc_riccati_smem_bytes(nz, nu),
                 blocks_per_sm=ric_lib.mpc_riccati_blocks_per_sm(nz, nu))
        emit(phase="riccati_kernel", nz=nz, nu=nu, **k)
        check(k["spill_store_bytes"] == 0 and k["blocks_per_sm"] >= 2,
              f"Riccati kernel ({nz}, {nu}): {k}")
    check(sorted(ric_k) == [(3, 1), (5, 1), (6, 2), (12, 4)],
          f"Riccati kernel instantiations {sorted(ric_k)}")
    # registers, spill store bytes, shared memory bytes, blocks an SM
    ric_ptxas = {f"{nz}x{nu}": [k["registers"], k["spill_store_bytes"],
                                k["smem_bytes"], k["blocks_per_sm"]]
                 for (nz, nu), k in ric_k.items()}

    # ---- problem and bench-shaped data (bench.py:75-99, 128-138)
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("bench_mahi", num_x=dyn.nx, num_u=dyn.nu,
                         step_size=0.002, num_shooting_nodes=N_NODES,
                         u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
                         dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    nx, nu, N = prob.nx, prob.nu, prob.N
    Qw, Rw, Rmw = [10.0] * 4 + [1.0] * 4, [0.1] * nu, [0.01] * nu
    opts = SolverOptions(tol=1e-4, max_iter=12)
    opts_cold = SolverOptions(tol=1e-4, max_iter=30)
    mu_warm = opts.warm_mu_factor * opts.tol
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)

    def batch_params(B, gen=rng):
        p = default_params(mp, device=dev)._replace(
            q=f32(Qw), r=f32(Rw), rm=f32(Rmw))
        ex = lambda a: a.expand((B,) + a.shape).clone()
        p = MPCParams(*[type(f)(*[ex(a) for a in f])
                        if isinstance(f, tuple) else ex(f) for f in p])
        return p._replace(x0=f32(0.2 * gen.standard_normal((B, nx))),
                          x_des=f32(0.2 * gen.standard_normal((B, N, nx))))

    def warm_schedule(B, n_rounds):
        perts = 0.01 * rng.standard_normal((n_rounds, B, nx))
        tgrid = np.arange(1, N + 1) * mp.step_size
        phase = rng.uniform(0, 2 * np.pi, (B, 1, 1))
        amp = 0.2 * rng.standard_normal((B, 1, nx))
        refs = [amp * np.sin(2 * np.pi * (tgrid[None, :, None]
                                          + r * mp.step_size) + phase)
                for r in range(n_rounds)]
        return perts, refs

    def timed(fn, reps):
        """(result, ms per call) by CUDA events, after one warm-up call."""
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    # ---- parity: kernel vs plain version on the card
    B = PARITY_BATCH
    p = batch_params(B)
    perts, refs = warm_schedule(B, 1)
    cold = lambda solve, pp: solve(prob, pp, None, None, opts_cold,
                                   mu0=opts_cold.mu_init, adaptive=True)
    rk = cold(solve_batch_fused, p)
    rp = cold(solve_batch_fused_plain, p)
    # The plain version in float64 on the same inputs: the exact answer of
    # the algorithm, against which float32 roundoff is judged.
    r64 = cold(solve_batch_fused_plain, to_f64(p))
    torch.cuda.synchronize()
    same = (rk.status == rp.status).float().mean().item()
    both = (rk.status == 0) & (rp.status == 0) & (r64.status == 0)
    n_both = int(both.sum())
    du = lambda a, b: (a.U.double() - b.U.double()).abs().amax(dim=(1, 2))
    du_kp, du_k64 = du(rk, rp)[both], du(rk, r64)[both]
    du_p64 = du(rp, r64)[both]
    far_k64 = int((du_k64 > COLD_DU_BAND).sum())
    emit(phase="parity_adaptive_cold", batch=B, status_agree=same,
         converged_kernel=(rk.status == 0).float().mean().item(),
         converged_plain=(rp.status == 0).float().mean().item(),
         converged_plain_f64=(r64.status == 0).float().mean().item(),
         mean_iters_kernel=rk.iters.float().mean().item(),
         mean_iters_plain=rp.iters.float().mean().item(),
         mean_iters_plain_f64=r64.iters.float().mean().item(),
         n_all_converged=n_both,
         max_abs_du_kernel_vs_plain=du_kp.max().item(),
         max_abs_du_kernel_vs_plain_f64=du_k64.max().item(),
         max_abs_du_plain_vs_plain_f64=du_p64.max().item(),
         n_beyond_band_kernel_vs_plain_f64=far_k64,
         n_beyond_band_plain_vs_plain_f64=int((du_p64 > COLD_DU_BAND).sum()))
    check(same >= 0.99, f"adaptive statuses agree on only {same:.4f}")
    check(far_k64 <= 0.01 * n_both,
          f"{far_k64} of {n_both} adaptive solves beyond |dU| {COLD_DU_BAND} "
          f"of the float64 solution")

    pw = p._replace(x0=p.x0 + f32(perts[0]), x_des=f32(refs[0]))
    warm = lambda solve: solve(prob, pw, rk.X, rk.U, opts, mu0=mu_warm,
                               n_iter=3)
    wk, wp = warm(solve_batch_fused), warm(solve_batch_fused_plain)
    dx = (wk.X - wp.X).abs().max().item()
    du_w = (wk.U - wp.U).abs().max().item()
    emit(phase="parity_fixed3_warm", batch=B, max_abs_dx=dx, max_abs_du=du_w,
         status_agree=(wk.status == wp.status).float().mean().item(),
         converged_kernel=(wk.status == 0).float().mean().item(),
         converged_plain=(wp.status == 0).float().mean().item())
    check(max(dx, du_w) <= 1e-4,
          f"fixed-3 max|dX|,|dU| {max(dx, du_w)} > 1e-4")

    # ---- times of kernel and plain version at the service's batch
    Bt = SERVICE_BATCH
    pt = batch_params(Bt)
    ct, cold_ms = timed(lambda: cold(solve_batch_fused, pt), 3)
    cp, cold_plain_ms = timed(lambda: cold(solve_batch_fused_plain, pt), 1)
    ptw = pt._replace(x0=pt.x0 + 0.01)
    warm_t = lambda solve: solve(prob, ptw, ct.X, ct.U, opts, mu0=mu_warm,
                                 n_iter=3)
    wkt, warm_ms = timed(lambda: warm_t(solve_batch_fused), 20)
    wpt, warm_plain_ms = timed(lambda: warm_t(solve_batch_fused_plain), 2)
    warm_err_t = max((wkt.X - wpt.X).abs().max().item(),
                     (wkt.U - wpt.U).abs().max().item())
    same_t = (ct.status == cp.status).float().mean().item()
    emit(phase="timing", batch=Bt, fixed3_warm_kernel_ms=warm_ms,
         fixed3_warm_plain_ms=warm_plain_ms, adaptive_cold_kernel_ms=cold_ms,
         adaptive_cold_plain_ms=cold_plain_ms,
         adaptive_cold_mean_iters=ct.iters.float().mean().item(),
         adaptive_cold_status_agree=same_t, fixed3_warm_max_abs_dxu=warm_err_t)
    check(warm_err_t <= 1e-4,
          f"B={Bt} fixed-3 max|dX|,|dU| {warm_err_t} > 1e-4")
    check(same_t >= 0.99, f"B={Bt} adaptive statuses agree on {same_t:.4f}")

    # ---- the group kernel's bound: the function's operations (the group
    # body's tally less the work its lanes repeat), counted by g++ on the
    # first COUNT_SAMPLE instances of these inputs (csrc/flop_count.cpp),
    # scaled to the batch; the adaptive solve's per instance-iteration,
    # times this run's iterations.  The body's own tally beside it.
    S = COUNT_SAMPLE
    ops_w = count_fused_ops(prob, head(ptw, S), ct.X[:S], ct.U[:S], opts,
                            mu0=mu_warm, n_iter=3)
    ops_c1 = count_fused_ops(prob, head(pt, S), None, None, opts_cold,
                             mu0=opts_cold.mu_init, n_iter=1, adaptive=True)
    total = lambda ops, part: sum(ops[part].values()) / S
    warm_ops = total(ops_w, "minimum") * Bt
    cold_ops = total(ops_c1, "minimum") * float(ct.iters.sum())
    io = fused_io_bytes(ptw, ct.X, ct.U, Bt)
    warm_bound, cold_bound = bound_ms(warm_ops, io), bound_ms(cold_ops, io)
    warm_body_bound = bound_ms(total(ops_w, "body") * Bt, io)
    cold_body_bound = bound_ms(total(ops_c1, "body") * float(ct.iters.sum()),
                               io)
    emit(phase="bound_fused", batch=Bt, count_sample=S,
         ops_per_instance_fixed3=total(ops_w, "minimum"),
         ops_by_kind_fixed3=ops_w["minimum"],
         ops_per_instance_iteration_adaptive=total(ops_c1, "minimum"),
         body_ops_per_instance_fixed3=total(ops_w, "body"),
         body_ops_by_kind_fixed3=ops_w["body"],
         body_ops_per_instance_iteration_adaptive=total(ops_c1, "body"),
         io_mbytes=io / 1e6,
         fixed3_warm_ops=warm_ops, fixed3_warm_bound_ms=warm_bound["bound_ms"],
         fixed3_warm_bound_by=warm_bound["bound_by"],
         fixed3_warm_roofline_share=warm_bound["bound_ms"] / warm_ms,
         fixed3_warm_body_bound_ms=warm_body_bound["bound_ms"],
         adaptive_cold_ops=cold_ops,
         adaptive_cold_bound_ms=cold_bound["bound_ms"],
         adaptive_cold_roofline_share=cold_bound["bound_ms"] / cold_ms,
         adaptive_cold_body_bound_ms=cold_body_bound["bound_ms"])

    # ---- the batch ladder, kernel only (its own draw of data)
    lad_rng = np.random.default_rng(1)
    ladder = []
    for Bl in LADDER:
        pl = batch_params(Bl, lad_rng)
        cl, cms = timed(lambda: cold(solve_batch_fused, pl), 2)
        plw = pl._replace(x0=pl.x0 + 0.01)
        _, wms = timed(lambda: solve_batch_fused(prob, plw, cl.X, cl.U, opts,
                                                 mu0=mu_warm, n_iter=3), 10)
        ladder.append(dict(batch=Bl, fixed3_warm_kernel_ms=wms,
                           fixed3_warm_solves_per_s=Bl / (wms * 1e-3),
                           adaptive_cold_kernel_ms=cms,
                           adaptive_cold_mean_iters=cl.iters.float().mean()
                           .item(),
                           adaptive_cold_converged=(cl.status == 0).float()
                           .mean().item()))
        check(ladder[-1]["adaptive_cold_converged"] >= 0.99,
              f"B={Bl} adaptive cold converged {ladder[-1]}")
    emit(phase="batch_ladder", rungs=ladder)

    # ---- service: the main path, counted
    def service(fixed_warm_iters, n_warm):
        svc = BatchModelControl(
            mp, batch=SERVICE_BATCH, device=dev,
            opts=SolverOptions(tol=1e-4, max_iter=30,
                               fixed_warm_iters=fixed_warm_iters),
            Q=Qw, R=Rw, Rm=Rmw)
        Bs = SERVICE_BATCH
        x0 = 0.2 * rng.standard_normal((Bs, nx))
        svc.set_states(x0)
        svc.set_references(0.2 * rng.standard_normal((Bs, N, nx)))
        perts, refs = warm_schedule(Bs, n_warm)
        before = solve_batch_fused.launches
        u = svc.step()
        m = svc.metrics()
        emit(phase="service_cold", fixed_warm_iters=fixed_warm_iters,
             batch=Bs, cold_s=m["solve_s"],
             converged_frac=m["converged_frac"], mean_iters=m["mean_iters"])
        check(m["converged_frac"] >= 0.9, f"cold converged_frac {m}")
        step_ms = []
        for i in range(n_warm):
            svc.set_states(x0 + perts[i], u_prev=u)
            svc.set_references(refs[i])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            u = svc.step()
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        m = svc.metrics()
        check(tuple(u.shape) == (Bs, nu) and bool(torch.isfinite(u).all()),
              "non-finite or misshapen controls")
        launches = solve_batch_fused.launches - before
        ms = float(np.mean(step_ms))
        emit(phase="service_warm", fixed_warm_iters=fixed_warm_iters,
             batch=Bs, warm_steps=n_warm, ms_per_warm_step=ms,
             ms_per_warm_step_all=step_ms, solves_per_s=Bs / (ms * 1e-3),
             converged_frac=m["converged_frac"], mean_iters=m["mean_iters"],
             max_feas=m["max_feas"], launches=launches)
        check(m["converged_frac"] >= 0.9, f"warm converged_frac {m}")
        check(launches == 1 + n_warm,
              f"kernel launched {launches} times for {1 + n_warm} steps")
        return svc, ms

    solve_batch_fused.launches = 0
    solve_batch_fused.prepare_launches = 0
    solve_batch_fused.mode_launches.update(fast=0, generic=0, ltv=0)
    solve_lqr_kernel_batch.launches = 0
    svc3, step_ms = service(3, WARM_STEPS)
    # fixed-3 steps under the profiler: the kernel's device time within a
    # step, its share of the unprofiled step (CUDA events above), and that
    # the main path ran the group kernel by its name
    prof = profile_step(svc3.step, "fused_sqp_group_kernel", 1)
    emit(phase="service_profile", fixed_warm_iters=3, batch=SERVICE_BATCH,
         ms_per_warm_step=step_ms,
         kernel_share_of_step=prof["kernel_device_ms"] / step_ms,
         host_side_ms=step_ms - prof["kernel_device_ms"], **prof)
    check(prof["kernel_count"] == 1 and prof["kernel_device_ms"] > 0,
          f"the profiled service step ran {prof['kernel_count']} "
          f"fused_sqp_group_kernel launches")
    service(0, ADAPTIVE_WARM_STEPS)
    launches = solve_batch_fused.launches
    fast_launches = solve_batch_fused.mode_launches["fast"]
    check(launches > 0 and fast_launches == launches,
          f"the main path launched the kernel {launches} times "
          f"({fast_launches} on the nq-row path)")
    check(solve_lqr_kernel_batch.launches == 0,
          "the fused route launched the Riccati kernel")
    prepare_launches = solve_batch_fused.prepare_launches
    check(prepare_launches == launches,
          f"the main path prepared {prepare_launches} solves and launched "
          f"{launches}")
    prepare = fused_prepare_phase(dev, rng, timed)
    prepare["launches"] = prepare_launches

    ltv = ltv_kernel_phase(dev, np.random.default_rng(15), timed, builds,
                           gen_libs)
    modes = fused_mode_phases(dev, rng, timed, warm_schedule, builds)
    ric = lanes_phases(dev, f32, rng, timed, batch_params, warm_schedule,
                       mp, prob, opts, opts_cold, mu_warm, Qw, Rw, Rmw)
    next(m for m in modes if m["case"].startswith("double_pendulum rk4,"))[
        "launches"] = ric["dp_fused_launches"]
    modes.insert(0, dict(
        mode="fast", source="mahi_mpc_tpu_torch/csrc/fused_sqp_group.cuh",
        case="mahi_arm Euler, fixed-3 warm (group body)",
        launches=fast_launches, max_abs_err=warm_err_t, ms=warm_ms,
        plain_ms=warm_plain_ms, bound_ms=warm_bound["bound_ms"],
        body_bound_ms=warm_body_bound["bound_ms"],
        adaptive_cold_ms=cold_ms, adaptive_cold_plain_ms=cold_plain_ms,
        adaptive_cold_bound_ms=cold_bound["bound_ms"]))
    launches += sum(m.get("launches", 0) for m in modes[1:])

    clock_mhz = sm_clock_mhz()
    b1 = runtime_phases(dev, mp, Qw, Rw, Rmw, opts, timed, clock_mhz)
    default_example = runtime_default_example(dev, timed, clock_mhz)
    block_launches = (b1["block_launches"] + b1["ltv_launches"]
                      + default_example["launches"])
    check(block_launches > 0, "the main path launched no block kernel")
    block_modes = [dict(
        mode="fast", source="mahi_mpc_tpu_torch/csrc/fused_sqp_block.cuh",
        library="mahi_mpc_tpu_torch/csrc/fused_sqp.cu",
        case="ModelControl mahi_arm Euler, B=1: 200 fixed-3 and 200 "
             "adaptive warm calc_u, the solver thread",
        card_body=b1["card_body_b1"], launches=b1["block_launches"],
        max_abs_err=b1["max_abs_err_b1"], ms=b1["ms_b1"],
        device_ms=b1["ms_b1"], plain_ms=b1["plain_ms_b1"],
        bound_ms=b1["bound_ms_b1"], bound_by=b1["bound_by_b1"],
        chain_bound_ms=b1["chain_bound_ms_b1"]), default_example, dict(
        mode="ltv", source="mahi_mpc_tpu_torch/csrc/fused_sqp_block.cuh",
        library="mahi_mpc_tpu_torch/csrc/fused_sqp_ltv.cu",
        case="ModelControl LTV mahi_arm, B=1: 50 fixed-3 warm calc_u "
             "(block body, Ltv<8, 4>)",
        card_body=b1["ltv_card_body_b1"], launches=b1["ltv_launches"],
        max_abs_err=b1["ltv_max_abs_err_b1"], ms=b1["ltv_ms_b1"],
        device_ms=b1["ltv_device_ms_b1"], plain_ms=b1["ltv_plain_ms_b1"],
        bound_ms=b1["ltv_bound_ms_b1"], bound_by=b1["ltv_bound_by_b1"],
        chain_bound_ms=b1["ltv_chain_bound_ms_b1"],
        share=b1["ltv_bound_ms_b1"] / b1["ltv_ms_b1"],
        device_share=b1["ltv_bound_ms_b1"] / b1["ltv_device_ms_b1"])]
    ladder = block_ladder_phase(dev, builds)
    service_non_lanes(dev, mp, Qw, Rw, Rmw, opts, rng)
    traj = trajgen_phase(dev)
    scenario_launches = batch_scenarios_phase(dev)
    launches += scenario_launches
    sharded = sharded_service_phase(dev, mp, Qw, Rw, Rmw, rng, warm_schedule)
    launches += sharded["launches"]
    lanes_sharded = sharded_lanes_phase(dev, mp, Qw, Rw, Rmw, rng)
    dist = distributed_phase()
    pariccati_phase(dev, timed)
    time_shard_phase(dev)
    generated = generated_phase(dev, rng, timed, builds, gen_libs,
                                clock_mhz)

    emit(phase="done")
    arm_b1 = block_modes[0]
    print(json.dumps({"kernels": [{
        "name": "fused_sqp",
        "route": "cuda",
        "source": "mahi_mpc_tpu_torch/csrc/fused_sqp_group.cuh",
        "replaces": "mahi_mpc_tpu/solver/fused.py:186",
        "launches": launches,
        "max_abs_err": max(m["max_abs_err"] for m in modes),
        "ms": warm_ms,
        "plain_ms": warm_plain_ms,
        "bound_ms": warm_bound["bound_ms"],
        "bound_by": warm_bound["bound_by"],
        "library_ms": None,
        "body_bound_ms": warm_body_bound["bound_ms"],
        "batch": SERVICE_BATCH,
        "mode": "fixed-3 warm, mahi_arm Euler (group body, nq-row path)",
        "adaptive_cold_max_abs_du_vs_f64": du_k64.max().item(),
        "batch_scenarios_launches": scenario_launches,
        "sharded_service_launches": sharded["launches"],
        "sharded_service_ms_median": sharded["ms_median"],
        "distributed_child_launches": dist["launches"],
        "modes": modes}, {
        "name": "fused_sqp_block",
        "route": "cuda",
        "source": "mahi_mpc_tpu_torch/csrc/fused_sqp_block.cuh",
        "replaces": "mahi_mpc_tpu/solver/fused.py:186",
        "launches": block_launches,
        "max_abs_err": max(m["max_abs_err"] for m in block_modes),
        "ms": arm_b1["device_ms"],
        "plain_ms": arm_b1["plain_ms"],
        "bound_ms": arm_b1["bound_ms"],
        "bound_by": arm_b1["bound_by"],
        "library_ms": None,
        "chain_bound_ms": arm_b1["chain_bound_ms"],
        "batch": 1,
        "mode": "fixed-3 warm, mahi_arm Euler at B=1 (block body)",
        "modes": block_modes,
        "ladder": [{k: c[k] for k in (
            "model", "batch", "N", "rule", "device_ms")} for c in ladder]}, {
        "name": "riccati",
        "route": "cuda",
        "source": "mahi_mpc_tpu_torch/csrc/riccati.cu",
        "replaces": "mahi_mpc_tpu/solver/pallas_riccati.py:128",
        "launches": ric["launches"] + traj["launches"] + lanes_sharded,
        "max_abs_err": ric["max_abs_err"],
        "ms": ric["ms"],
        "plain_ms": ric["plain_ms"],
        "bound_ms": ric["bound_ms"],
        "bound_by": ric["bound_by"],
        "library_ms": None,
        "design_bound_ms": ric["design_bound_ms"],
        "batch": SERVICE_BATCH,
        "mode": "N=25, nz=12, nu=4, batch-leading in and out (group body)",
        "batch_entry_ms": ric["batch_entry_ms"],
        "multipliers_ms": ric["multipliers_ms"],
        "lanes_entry_ms": ric["lanes_entry_ms"],
        "trajgen_launches_n40": traj["launches"],
        "sharded_lanes_launches": lanes_sharded,
        "trajgen_max_rel_err_n40": traj["max_rel_err_n40"],
        "ms_6x2": ric["ms_6x2"], "bound_ms_6x2": ric["bound_ms_6x2"],
        "design_bound_ms_6x2": ric["design_bound_ms_6x2"],
        "ptxas": ric_ptxas}, *generated, *ltv_kernel_entries(ltv),
        prepare]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
