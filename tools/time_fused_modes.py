#!/usr/bin/env python3
"""Time the fused kernel's step modes on one CUDA card, for one checkout of
the port: how two versions of the kernel are compared on the same card.

    python3 tools/time_fused_modes.py [--root DIR] [--save FILE.json]
        [--match REGEX] [--compare A.json B.json]

Imports ``mahi_mpc_tpu_torch`` from the checkout at DIR (default: the one
this file is in), builds its fused kernel's CUDA libraries, and for each
case of ``CASES`` (``chip_smoke.py``'s ``model_batch``: N=25, dt=2 ms,
bench-shaped data from numpy seed 0) times with CUDA events the fixed-3
warm solve (10 calls after one warm-up) and the adaptive cold solve (2
calls), wrapper included, as ``chip_smoke.py``'s ``timing_fused_modes``
does, and the kernel's own device time a fixed-3 launch
(``torch.profiler``, 5 launches); it holds the fixed-3 warm solve to the
plain version on the same inputs (max |dX|, |dU|, the smoke's 1e-4).
Each case runs on the body the launcher's rule picks at its batch, which
its line names: the registered policies (``CASES``), and the generated
instantiations of ``GENERATED`` (``chip_smoke.py`` phase 23's LTV chains
and a user's own model under each generated policy, ``user_vdp``,
``user_cartpole``, ``user_chain4``, data from its ``generated_batch``),
those with a block body over the batches of ``BLOCK_LADDER``.
The LTV path's own two kernels, linearization and discretization
(``ltv-kernel`` cases: ``chip_smoke.py``'s ``LTV_LINEARIZE_CASES`` and
``LTV_DISCRETE_CASES`` at B=16384 and B=1, its ``ltv_case`` data from
numpy seed ``LTV_SEED``): one launch timed with CUDA events around 50
launches of its launcher, the inputs ready (``chip_smoke.py``
``ltv_kernel_event_ms``), the outputs held to the plain version run in
float64 on the same inputs (``LTV_BAND`` of max|.|; the float32 plain
version's own Ad - I loses digits to cancellation), with the kernel's
tile where the checkout reports one; and the LTV service's warm step at
B=16384 (``ltv-service``: ``chip_smoke.py``'s ``service_ltv`` set-up,
``LTV_WARM_STEPS`` steps timed with CUDA events after a cold one).
``--match REGEX`` keeps the cases whose key (``mahi_arm-euler-ltv-b1``,
``ltv-kernel-linearize-mahi_arm-euler-b1``, ``ltv-service-mahi_arm-b16384``,
as ``--save`` names them) it finds, to repeat a few cases in turns.
``--save``
writes the SHA-256 of each case's adaptive cold and fixed-3 warm X, U and
iterations (their bytes), and the body that computed them, and of each
LTV kernel case's inputs and outputs, to a JSON file (the LTV kernels'
outputs themselves to an .npz beside it), so that two checkouts' outputs
on the card can be compared bit for bit: ``--compare A.json B.json``
prints, for each case and run, whether they are equal (a case whose
bodies differ between the two is listed and not compared) and, for an
output that differs where both .npz files are there, its largest
difference (absolute, and over max|.|), and builds nothing.  Prints one
JSON line a case, the ``-Xptxas -v`` lines of the libraries it loaded,
and the card's ``nvidia-smi`` name and power limit.  A checkout with
``solver/target.py`` names its libraries there (they are built together
first, and each case's line gives its kernel's blocks an SM); in one
without it each solve builds its own library at first use.  To compare two checkouts, run it for
each in turns on the same card (parent, change, change, parent, ...).
Exits 1 without a CUDA device, or when a case is beyond the band of its
plain version.
"""

import argparse
import concurrent.futures
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# (model, integrator, LTV, batch): the main path, the policies of the
# four-lane group body over a dense step at B=16384 (LTV at (8, 4); the
# 4-DOF arm under RK4 and midpoint, the 2-DOF arm under RK4), the small LTV
# shapes (4, 2), (4, 1), (2, 1), the closed forms under Euler and RK4, the
# double pendulum also at B=65536 (a higher rung of the JAX ladder), and
# the three policies with a block body (the arm and the double
# pendulum under Euler: the single robot's warm calc_u and the reference's
# default example; LTV at (8, 4): the LTV single robot) over the batches of
# BLOCK_LADDER
BLOCK_LADDER = (1, 2, 8, 32, 132, 264, 396, 528, 660, 792, 1024)
CASES = (("mahi_arm", "euler", False, 16384),
         ("mahi_arm", "euler", True, 16384),
         ("double_pendulum", "euler", True, 16384),
         ("cartpole", "euler", True, 16384),
         ("pendulum", "euler", True, 16384),
         ("mahi_arm", "rk4", False, 16384),
         ("mahi_arm", "midpoint", False, 16384),
         ("two_link_arm", "rk4", False, 16384),
         *((name, integrator, False, 16384)
           for name in ("pendulum", "cartpole", "double_pendulum", "acrobot")
           for integrator in ("euler", "rk4")),
         ("double_pendulum", "euler", False, 65536),
         ("double_pendulum", "rk4", False, 65536),
         *((name, "euler", ltv, batch)
           for name, ltv in (("mahi_arm", False), ("double_pendulum", False),
                             ("mahi_arm", True))
           for batch in BLOCK_LADDER))
# Generated instantiations (chip_smoke.py `user_dynamics`): the LTV shapes
# whose controls outnumber their group's lanes, at B=16384; and a user's
# own model under each generated step policy with a block body, over
# BLOCK_LADDER and at B=16384: Van der Pol under RK4 (`Generic`, the
# two-lane group body at full occupancy), the cart-pole's own f and the
# 4-DOF chain (`FastNq`, one thread at full occupancy).
GENERATED = (("ltv_12x6", 16384), ("ltv_6x3", 16384),
             *((name, batch)
               for name in ("user_vdp", "user_cartpole", "user_chain4")
               for batch in BLOCK_LADDER + (16384,)))
LIBRARIES = ("fused_sqp", "fused_sqp_ltv", "fused_sqp_generic",
             "fused_sqp_models")
PLAIN_BAND = 1e-4
# the LTV path's kernels at the LTV service's batch and the single robot's,
# on data from one seed in every checkout; the LTV service's warm steps
LTV_BATCHES = (16384, 1)
LTV_SEED = 16
LTV_WARM_STEPS = 20


def compare(a: str, b: str) -> int:
    """Print, for each array of two ``--save`` files, whether its bytes
    are equal in both, and an LTV kernel output's largest difference where
    they are not; 0 when every array matches."""
    import numpy as np

    A, B = (json.loads(Path(f).read_text()) for f in (a, b))
    arrays = [np.load(Path(f).with_suffix(".npz"))
              if Path(f).with_suffix(".npz").exists() else None
              for f in (a, b)]
    same = sorted(A) == sorted(B)
    for key in sorted(set(A) & set(B)):
        if key.endswith("/body"):
            continue
        case = key.split("/")[0]
        bodies = [D.get(f"{case}/body") for D in (A, B)]
        if bodies[0] != bodies[1]:
            print(json.dumps(dict(key=key, bitwise_equal=None,
                                  bodies=bodies)))
            continue
        line = dict(key=key, bitwise_equal=A[key] == B[key], body=bodies[0])
        npz = key.replace("/", ":")
        if not line["bitwise_equal"] and all(
                z is not None and npz in z for z in arrays):
            x, y = (z[npz].astype(np.float64) for z in arrays)
            d = float(np.abs(x - y).max())
            line.update(max_abs_diff=d, max_rel_diff=d / max(
                float(np.abs(y).max()), 1e-300))
        print(json.dumps(line))
        same &= A[key] == B[key]
    print(json.dumps(dict(compared=[a, b], all_bitwise_equal=same)))
    return 0 if same else 1


def ltv_case_keys(smoke) -> list:
    """(key, kind, model, integrator, batch) of the LTV kernel cases."""
    cases = [("linearize", name, "euler")
             for name in smoke.LTV_LINEARIZE_CASES] + \
        [("ltv_discrete", name, integrator)
         for name, integrator in smoke.LTV_DISCRETE_CASES]
    return [(f"ltv-kernel-{kind}-{name}-{integrator}-b{B}", kind, name,
             integrator, B) for kind, name, integrator in cases
            for B in LTV_BATCHES]


def ltv_kernel_case(smoke, lz, case, data, saved, arrays) -> dict:
    """One LTV kernel case: its launch ms, its outputs held to the float64
    plain version, their digests (and the outputs) into saved (arrays)."""
    import torch

    key, kind, name, integrator, B = case
    dyn, prob, p = data
    if kind == "linearize":
        call = lambda: lz.linearize_batch(dyn, p.x0, p.u_prev)
        plain = lz.linearize_batch_plain(dyn, p.x0.double(),
                                         p.u_prev.double())
        ins, tile = (p.x0, p.u_prev), getattr(lz, "linearize_tile", None)
        tile = tile(dyn) if tile else None
    else:
        call = lambda: lz.ltv_discrete(prob, p)
        lin64 = type(p.lin)(*[t.double() for t in p.lin])
        plain = lz.ltv_discrete_plain(prob, p._replace(x0=p.x0.double(),
                                                       lin=lin64))
        ins, tile = tuple(p.lin), getattr(lz, "ltv_discrete_tile", None)
        tile = tile(prob) if tile else None
    out = call()
    torch.cuda.synchronize()
    err = max(((g.double() - w).abs().max() / w.abs().max()).item()
              for g, w in zip(out, plain))
    digest = lambda t: hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    for i, t in enumerate(ins):
        saved[f"{key}/in/{i}"] = digest(t)
    for i, t in enumerate(out):
        saved[f"{key}/out/{i}"] = digest(t)
        arrays[f"{key}:out:{i}"] = t.detach().cpu().numpy()
    return dict(case=key, batch=B, ms=smoke.ltv_kernel_event_ms(call),
                max_rel_err_vs_plain=err, within_band=err <= smoke.LTV_BAND,
                tile=tile)


def ltv_service_case(smoke, dev) -> dict:
    """The LTV service's warm step at chip_smoke.py's ``service_ltv``
    set-up (the 4-DOF arm, B=16384, fixed-3 warm solves): a cold step,
    then LTV_WARM_STEPS warm steps each timed with CUDA events."""
    import numpy as np
    import torch

    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch.runtime import BatchModelControl

    rng = np.random.default_rng(LTV_SEED)
    mp, _, _ = smoke.model_batch(dev, rng, "mahi_arm", 1, is_linear=True)
    Bs, nx, N = smoke.SERVICE_BATCH, mp.num_x, smoke.N_NODES
    svc = BatchModelControl(mp, batch=Bs, device=dev,
                            opts=SolverOptions(tol=1e-4, max_iter=30,
                                               fixed_warm_iters=3),
                            Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4,
                            Rm=[0.01] * 4)
    x0 = 0.2 * rng.standard_normal((Bs, nx))
    svc.set_states(x0)
    svc.set_references(0.2 * rng.standard_normal((Bs, N, nx)))
    u = svc.step()
    tgrid = np.arange(1, N + 1) * mp.step_size
    phase = rng.uniform(0, 2 * np.pi, (Bs, 1, 1))
    amp = 0.2 * rng.standard_normal((Bs, 1, nx))
    step_ms = []
    for i in range(LTV_WARM_STEPS):
        svc.set_states(x0 + 0.01 * rng.standard_normal((Bs, nx)), u_prev=u)
        svc.set_references(amp * np.sin(2 * np.pi * (
            tgrid[None, :, None] + i * mp.step_size) + phase))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = svc.step()
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    return dict(case=f"ltv-service-mahi_arm-b{Bs}", batch=Bs,
                warm_solver=svc.warm_solver,
                ms_per_warm_step=float(np.mean(step_ms)),
                ms_p50=float(np.percentile(step_ms, 50)),
                ms_all=step_ms,
                converged_frac=svc.metrics()["converged_frac"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose mahi_mpc_tpu_torch is timed")
    ap.add_argument("--save", default=None,
                    help="JSON file for the digests of the cases' outputs "
                         "(X, U, iterations)")
    ap.add_argument("--compare", nargs=2, default=None,
                    help="two --save files to compare")
    ap.add_argument("--match", default=None,
                    help="time only the cases whose key this regex finds")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_fused_modes: no CUDA device", file=sys.stderr)
        return 1
    import inspect

    import mahi_mpc_tpu_torch
    from mahi_mpc_tpu_torch import SolverOptions
    from mahi_mpc_tpu_torch._build import cuda_build
    from mahi_mpc_tpu_torch.solver import linearize as lz
    from mahi_mpc_tpu_torch.solver.fused import (card_body, solve_batch_fused,
                                                 solve_batch_fused_plain)
    try:
        from mahi_mpc_tpu_torch.solver.target import (INTEGRATORS,
                                                      kernel_target,
                                                      model_kernel)
    except ImportError:          # the checkout names no library up front
        kernel_target = model_kernel = None
    # the checkout's body at a batch (a checkout before the block body has
    # one body a policy at every batch)
    takes_batch = "B" in inspect.signature(card_body).parameters
    body_at = lambda prob, batch: (card_body(prob, batch) if takes_batch
                                   else card_body(prob))[0]

    # chip_smoke.py of this checkout: its bench-shaped data and helpers
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    imported = Path(mahi_mpc_tpu_torch.__file__).resolve().parent.parent
    assert imported == root, f"imported {imported}, not {root}"

    label = str(root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kept = lambda key: not args.match or re.search(args.match, key)
    user = smoke.user_dynamics()
    cases = [(f"{name}-{integrator}" + ("-ltv" if is_linear else "")
              + f"-b{batch}", name, integrator, is_linear, batch)
             for name, integrator, is_linear, batch in list(CASES) + [
                 (name, user[name][1], user[name][2], batch)
                 for name, batch in GENERATED]]
    cases = [c for c in cases if kept(c[0])]
    generated = {(name, batch): smoke.generated_batch(
        dev, np.random.default_rng(0), name, batch)
        for name, batch in GENERATED
        if any(c[1:2] + c[4:] == (name, batch) for c in cases)}
    ltv_cases = [c for c in ltv_case_keys(smoke) if kept(c[0])]
    ltv_data = {c[0]: smoke.ltv_case(dev, np.random.default_rng(LTV_SEED),
                                     c[2], c[4], c[3]) for c in ltv_cases}
    # the generated libraries and the LTV kernels' libraries
    names = list(LIBRARIES)
    if kernel_target is not None:
        names = list(dict.fromkeys(names + [
            kernel_target(prob).cuda for prob, _ in generated.values()] + [
            model_kernel(dyn).library if c[1] == "linearize"
            else kernel_target(prob).cuda
            for c in ltv_cases for dyn, prob, _ in [ltv_data[c[0]]]]))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(cuda_build, names))
    build_s = time.perf_counter() - t0

    opts = SolverOptions(tol=1e-4, max_iter=12)
    opts_cold = SolverOptions(tol=1e-4, max_iter=30)
    mu_warm = opts.warm_mu_factor * opts.tol

    def timed(fn, reps):
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

    def held(r, ref):
        """max |dX|, |dU| of r from ref."""
        return max((r.X - ref.X).abs().max().item(),
                   (r.U - ref.U).abs().max().item())

    saved, arrays, bad = {}, {}, 0
    for key, name, integrator, is_linear, batch in cases:
        if (name, batch) in generated:
            prob, p = generated[name, batch]
        else:
            _, prob, p = smoke.model_batch(dev, np.random.default_rng(0),
                                           name, batch, integrator,
                                           is_linear)
        cold = lambda: solve_batch_fused(prob, p, None, None, opts_cold,
                                         mu0=opts_cold.mu_init,
                                         adaptive=True)
        ct, cold_ms = timed(cold, 2)
        pw = p._replace(x0=p.x0 + 0.01)
        warm = lambda: solve_batch_fused(prob, pw, ct.X, ct.U, opts,
                                         mu0=mu_warm, n_iter=3)
        wk, warm_ms = timed(warm, 10)
        wp = solve_batch_fused_plain(prob, pw, ct.X, ct.U, opts,
                                     mu0=mu_warm, n_iter=3)
        err = held(wk, wp)
        bad += not err <= PLAIN_BAND
        prof = smoke.profile_step(lambda: [warm() for _ in range(5)],
                                  "fused_sqp")
        kernels = [k for k in prof["top_kernels"] if "fused_sqp" in k[0]]
        body = body_at(prob, batch)
        per_sm = None
        if kernel_target is not None:
            target = kernel_target(prob)
            per_sm = cuda_build(target.cuda)[0].mpc_fused_blocks_per_sm(
                target.model, prob.nx, prob.nu,
                INTEGRATORS.index(integrator), int(is_linear))
        line = dict(
            label=label, model=name, integrator=integrator,
            is_linear=is_linear, batch=batch, body=body,
            fixed3_warm_ms=warm_ms, adaptive_cold_ms=cold_ms,
            fixed3_kernel_device_ms=prof["kernel_device_ms"]
            / max(prof["kernel_count"], 1),
            kernel=kernels[0][0] if kernels else None,
            kernel_count=prof["kernel_count"],
            adaptive_cold_mean_iters=ct.iters.float().mean().item(),
            adaptive_cold_converged=(ct.status == 0).float().mean().item(),
            fixed3_converged=(wk.status == 0).float().mean().item(),
            fixed3_max_abs_dxu_vs_plain=err,
            blocks_per_sm=per_sm, build_s=build_s, nvidia_smi=smi)
        print(json.dumps(line), flush=True)
        saved[f"{key}/body"] = body
        for run, r in (("cold", ct), ("fixed3", wk)):
            for field in ("X", "U", "iters"):
                saved[f"{key}/{run}/{field}"] = hashlib.sha256(
                    getattr(r, field).cpu().numpy().tobytes()).hexdigest()
    for case in ltv_cases:
        line = ltv_kernel_case(smoke, lz, case, ltv_data[case[0]], saved,
                               arrays)
        bad += not line["within_band"]
        print(json.dumps(dict(label=label, **line, nvidia_smi=smi)),
              flush=True)
    if kept(f"ltv-service-mahi_arm-b{smoke.SERVICE_BATCH}"):
        print(json.dumps(dict(label=label, **ltv_service_case(smoke, dev),
                              nvidia_smi=smi)), flush=True)
    for name in list(getattr(cuda_build, "seconds", {})):
        for k in smoke.ptxas_summary(cuda_build(name)[1]):
            print(json.dumps(dict(label=label, library=name, **k)),
                  flush=True)
    if args.save:
        Path(args.save).write_text(json.dumps(saved, indent=0))
        if arrays:
            np.savez(Path(args.save).with_suffix(".npz"), **arrays)
    print(smi, flush=True)
    if bad:
        print(f"time_fused_modes: {bad} cases beyond {PLAIN_BAND} of the "
              f"plain version", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
