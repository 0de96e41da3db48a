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
Where the checkout has the block body (``solve_batch_fused_body``), each
case at a batch of ``BLOCK_LADDER`` whose policy has a block body is also
timed on both bodies, the block body and the body the rule runs at full
occupancy (group or one thread; device ms a fixed-3 launch by CUDA events
around 20 launches of the kernel alone, ``chip_smoke.py``
``kernel_event_ms``, in turns other, block, block, other), each held to
the plain version: the registered policies (``CASES``) and a user's own
model under each generated policy (``GENERATED``: ``chip_smoke.py``
phase 23's ``user_vdp``, ``user_cartpole``, ``user_chain4``, data from
its ``generated_batch``); and each generated LTV chain of ``GENERATED``
on the one-thread body and the group body where the checkout has a
timing build that holds both (``_cuda_library(prob, both_bodies=True)``;
in turns thread, group, group, thread), with whether the two bodies'
fixed-3 outputs are equal bit for bit; the case's line names the body
the launcher's rule picks.
``--match REGEX`` keeps the cases whose key (``mahi_arm-euler-ltv-b1``,
as ``--save`` names them) it finds, to repeat a few cases in turns.
``--save``
writes the SHA-256 of each case's adaptive cold and fixed-3 warm X, U and
iterations (their bytes), and the body that computed them, to a JSON
file, so that two checkouts' outputs on the card can be compared bit for
bit: ``--compare A.json B.json`` prints, for each case and run, whether
they are equal (a case whose bodies differ between the two is listed and
not compared), and builds nothing.  Prints one JSON line a case, the libraries'
``-Xptxas -v`` lines of the fused kernels, and the card's ``nvidia-smi``
name and power limit.  To compare two checkouts, run it for each in turns
on the same card (parent, change, change, parent, ...).  Exits 1 without a
CUDA device, or when a case is beyond the band of its plain version.
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


def compare(a: str, b: str) -> int:
    """Print, for each array of two ``--save`` files, whether its bytes
    are equal in both; 0 when every array matches."""
    A, B = (json.loads(Path(f).read_text()) for f in (a, b))
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
        print(json.dumps(dict(key=key, bitwise_equal=A[key] == B[key],
                              body=bodies[0])))
        same &= A[key] == B[key]
    print(json.dumps(dict(compared=[a, b], all_bitwise_equal=same)))
    return 0 if same else 1


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
    from mahi_mpc_tpu_torch.solver import fused as fused_mod
    from mahi_mpc_tpu_torch.solver.fused import (INTEGRATORS, _cuda_library,
                                                 _model_id, card_body,
                                                 solve_batch_fused,
                                                 solve_batch_fused_plain)
    # the checkout's body at a batch (a checkout before the block body has
    # one body a policy at every batch)
    takes_batch = "B" in inspect.signature(card_body).parameters
    body_at = lambda prob, batch: (card_body(prob, batch) if takes_batch
                                   else card_body(prob))[0]
    on_body = getattr(fused_mod, "solve_batch_fused_body", None)

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
    generated = {(name, batch): smoke.generated_batch(
        dev, np.random.default_rng(0), name, batch)
        for name, batch in GENERATED}
    # the generated libraries, and their timing builds where the checkout
    # has them (both bodies of an LTV shape)
    timing = "both_bodies" in inspect.signature(_cuda_library).parameters
    names = list(dict.fromkeys(list(LIBRARIES) + [
        lib for prob, _ in generated.values()
        for lib in ([_cuda_library(prob)] + ([_cuda_library(
            prob, both_bodies=True)] if timing else []))]))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(cuda_build, names)))
    build_s = time.perf_counter() - t0
    for name, (_, report, _) in libs.items():
        for k in smoke.ptxas_summary(report):
            print(json.dumps(dict(label=label, library=name, **k)),
                  flush=True)

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

    saved, bad = {}, 0
    user = smoke.user_dynamics()
    cases = list(CASES) + [(name, user[name][1], user[name][2], batch)
                           for name, batch in GENERATED]
    for name, integrator, is_linear, batch in cases:
        key = (f"{name}-{integrator}" + ("-ltv" if is_linear else "")
               + f"-b{batch}")
        if args.match and not re.search(args.match, key):
            continue
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
        bodies, outs, turns = {}, {}, ()
        if on_body is not None and batch in BLOCK_LADDER and \
                body_at(prob, 1) == "block":
            # the block body against the body at full occupancy
            other = body_at(prob, None)
            turns = (other, "block", "block", other)
        elif on_body is not None and is_linear and (name, batch) in generated:
            turns = ("thread", "group", "group", "thread")
        for b in turns:
            solve_b = lambda: on_body(prob, pw, ct.X, ct.U, opts,
                                      mu0=mu_warm, n_iter=3, body=b)
            try:
                rb = solve_b()
            except ValueError as e:      # the checkout has no such body
                bodies[b] = dict(error=str(e))
                continue
            outs[b] = rb
            err_b = held(rb, wp)
            bad += not err_b <= PLAIN_BAND
            bodies.setdefault(b, dict(device_ms=[], max_abs_dxu=err_b))
            bodies[b]["device_ms"].append(smoke.kernel_event_ms(solve_b))
        if len(outs) == 2:
            a, b = outs.values()
            bodies["bitwise_equal"] = bool(torch.equal(a.X, b.X)
                                           and torch.equal(a.U, b.U))
        # blocks an SM of the kernel that serves it (where the checkout's
        # library reports it; a checkout before the body argument takes
        # five)
        per_sm = getattr(libs[_cuda_library(prob)][0],
                         "mpc_fused_blocks_per_sm", None)
        if per_sm is not None:
            occupancy = per_sm
            per_sm = lambda *a: occupancy(*a[:len(occupancy.argtypes)])
        model = _model_id(prob)[0]
        line = dict(
            label=label, model=name, integrator=integrator,
            is_linear=is_linear, batch=batch, body=body, bodies=bodies,
            fixed3_warm_ms=warm_ms, adaptive_cold_ms=cold_ms,
            fixed3_kernel_device_ms=prof["kernel_device_ms"]
            / max(prof["kernel_count"], 1),
            kernel=kernels[0][0] if kernels else None,
            kernel_count=prof["kernel_count"],
            adaptive_cold_mean_iters=ct.iters.float().mean().item(),
            adaptive_cold_converged=(ct.status == 0).float().mean().item(),
            fixed3_converged=(wk.status == 0).float().mean().item(),
            fixed3_max_abs_dxu_vs_plain=err,
            blocks_per_sm=None if per_sm is None else per_sm(
                model, prob.nx, prob.nu, INTEGRATORS.index(integrator),
                int(is_linear), -1),
            build_s=build_s, nvidia_smi=smi)
        print(json.dumps(line), flush=True)
        saved[f"{key}/body"] = body
        for run, r in (("cold", ct), ("fixed3", wk)):
            for field in ("X", "U", "iters"):
                saved[f"{key}/{run}/{field}"] = hashlib.sha256(
                    getattr(r, field).cpu().numpy().tobytes()).hexdigest()
    if args.save:
        Path(args.save).write_text(json.dumps(saved, indent=0))
    print(smi, flush=True)
    if bad:
        print(f"time_fused_modes: {bad} cases beyond {PLAIN_BAND} of the "
              f"plain version", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
