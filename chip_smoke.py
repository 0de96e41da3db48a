#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA Hopper card (the kernel is built for sm_90a), the CUDA toolkit's
``nvcc`` (``/usr/local/cuda`` or on PATH), and no network.  Phases, one JSON
line each, with the seconds since start in ``t``:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — nvcc builds ``mahi_mpc_tpu_torch/csrc/fused_sqp.cu``; registers
   and spill bytes from ``-Xptxas -v``;
3. parity — the fused kernel against its plain PyTorch version, both on the
   card, at B=1024 on the 4-DOF ``mahi_arm`` (N=25, dt=2 ms, |u| <= 20,
   float32) with bench-shaped data:
   - adaptive cold solve: statuses agree on >= 99 % of instances, and at
     most 1 % of the converged instances lie beyond |dU| 5e-3 of the plain
     version's float64 solution.  The float32 answer of this algorithm is
     itself only determined to ~1e-2 on about 1 % of instances (Armijo
     rejects steps on float32 merit noise after a barrier decrease, so the
     last iterations crawl), so the plain version in float32 is no closer
     to the float64 solution there; the line prints both counts;
   - fixed-3 warm solve from the kernel's cold plan: max|dX|, max|dU|
     <= 1e-4;
   then times of both at the service's batch (B=16384);
4. service — ``BatchModelControl`` on the card at B=16384 with
   ``fixed_warm_iters=3``: one cold step, then 10 warm steps with 0.01 N(0,1)
   state noise and a phase-shifted sinusoid reference (converged_frac >= 0.9
   after the cold and the last warm step; the kernel's launch count rises by
   11); then a service with adaptive warm steps (1 cold + 3 warm).

Then one line ``{"kernels": [...]}`` with each kernel's launches in the
service phase, its error against the plain version and both times, the
``nvidia-smi`` line as it printed it, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
CUDA device it exits 1 and prints no result.
"""

import json
import re
import subprocess
import sys
import time

T0 = time.perf_counter()

N_NODES = 25
PARITY_BATCH = 1024
SERVICE_BATCH = 16384
WARM_STEPS = 10
ADAPTIVE_WARM_STEPS = 3
COLD_DU_BAND = 5e-3


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
        nq = re.search(r"ILi(\d+)E", name)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        out.append({
            "kernel": name, "nq": int(nq.group(1)) if nq else None,
            "registers": int(regs.group(1)) if regs else None,
            "stack_frame_bytes": int(spill.group(1)) if spill else None,
            "spill_store_bytes": int(spill.group(2)) if spill else None,
            "spill_load_bytes": int(spill.group(3)) if spill else None})
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
    from mahi_mpc_tpu_torch._build import cuda_build
    from mahi_mpc_tpu_torch.models import make_dynamics
    from mahi_mpc_tpu_torch.runtime import BatchModelControl
    from mahi_mpc_tpu_torch.solver.fused import (solve_batch_fused,
                                                 solve_batch_fused_plain)
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

    # ---- build
    _, report, build_s = cuda_build()
    emit(phase="build", seconds=build_s, ptxas=ptxas_summary(report))

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

    def batch_params(B):
        p = default_params(mp, device=dev)._replace(
            q=f32(Qw), r=f32(Rw), rm=f32(Rmw))
        ex = lambda a: a.expand((B,) + a.shape).clone()
        p = MPCParams(*[type(f)(*[ex(a) for a in f])
                        if isinstance(f, tuple) else ex(f) for f in p])
        return p._replace(x0=f32(0.2 * rng.standard_normal((B, nx))),
                          x_des=f32(0.2 * rng.standard_normal((B, N, nx))))

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
    p64 = MPCParams(*[type(f)(*[a.double() for a in f])
                      if isinstance(f, tuple) else f.double() for f in p])
    r64 = cold(solve_batch_fused_plain, p64)
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
    _, cold_plain_ms = timed(lambda: cold(solve_batch_fused_plain, pt), 1)
    ptw = pt._replace(x0=pt.x0 + 0.01)
    warm_t = lambda solve: solve(prob, ptw, ct.X, ct.U, opts, mu0=mu_warm,
                                 n_iter=3)
    _, warm_ms = timed(lambda: warm_t(solve_batch_fused), 20)
    _, warm_plain_ms = timed(lambda: warm_t(solve_batch_fused_plain), 2)
    emit(phase="timing", batch=Bt, fixed3_warm_kernel_ms=warm_ms,
         fixed3_warm_plain_ms=warm_plain_ms, adaptive_cold_kernel_ms=cold_ms,
         adaptive_cold_plain_ms=cold_plain_ms,
         adaptive_cold_mean_iters=ct.iters.float().mean().item())

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
        return launches

    solve_batch_fused.launches = 0
    service(3, WARM_STEPS)
    service(0, ADAPTIVE_WARM_STEPS)
    launches = solve_batch_fused.launches
    check(launches > 0, "the main path never launched the kernel")

    emit(phase="done")
    print(json.dumps({"kernels": [{
        "name": "fused_sqp",
        "route": "cuda",
        "source": "mahi_mpc_tpu_torch/csrc/fused_sqp.cu",
        "replaces": "mahi_mpc_tpu/solver/fused.py:186",
        "launches": launches,
        "max_abs_err": max(dx, du_w),
        "ms": warm_ms,
        "plain_ms": warm_plain_ms,
        "batch": SERVICE_BATCH,
        "mode": "fixed-3 warm",
        "adaptive_cold_ms": cold_ms,
        "adaptive_cold_plain_ms": cold_plain_ms,
        "adaptive_cold_max_abs_du_vs_f64": du_k64.max().item()}]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
