"""How ``correct`` is decided: the answers of the timed path against the
plain float64 reference (``reference/``), on a sample drawn from the seed.

The sample: the cell's ``check_instances`` instances (drawn at set-up) at
``check_steps`` of the window's steps (the last one and others drawn from
the seed), and the same instances' cold seed step.  For each, the
reference works the service step out again from what the harness handed
the program: the measured state, the previous control and the reference
trajectory of that step, and the warm start, which is the program's own
plan of the step before, passed through the reference's own rule for a
failed instance (the reference follows the program step by step; the
cold step, from zeros, is checked on its own).  The discrete model is the
configuration's own reference step (``reference/steps/<reference>.py``);
in LTV it linearizes the arm at the measured state and discretizes again.

The numbers compared, each against its limit in ``limits/<cell>.json``:
``u_gap``, the widest gap between a control the program returned in the
window and the reference's; ``cold_u_gap``, the same at the cold step;
``plan_x_gap`` and ``plan_u_gap``, the widest gap over the whole plan the
service keeps (every node's state and control, the next step's warm
start) at the sampled steps and the cold step, so a plan that is wrong
beyond its first control is caught at the step that made it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .reference.service import service_step, step_module
from .reference.sqp import Params, failed_rule

NAMES = ("u_gap", "cold_u_gap", "plan_x_gap", "plan_u_gap")


def check_steps(first: int, last: int, count: int, seed: int) -> list:
    """The window's steps to compare: the last, and ``count - 1`` more
    drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    others = np.arange(first, last)
    pick = rng.choice(others, min(count - 1, len(others)), replace=False)
    return sorted(int(k) for k in pick) + [last]


def program_answers(cap: dict, steps: list) -> tuple:
    """What the program returned at the sampled steps, in ``NAMES``'
    order: the warm controls, the cold controls, and the kept plans (X, U)
    of the warm steps then the cold step."""
    ks = np.asarray(steps)
    t = lambda a: torch.as_tensor(np.asarray(a))
    idx = np.concatenate([ks, [0]])
    _, _, X, U = failed_rule(t(cap["status"][idx]).reshape(-1),
                             t(cap["X"][idx]).flatten(0, 1),
                             t(cap["U"][idx]).flatten(0, 1))
    return (t(cap["u"][ks]).flatten(0, 1), t(cap["u"][0]), X, U)


def reference_answers(cfg: dict, mix: dict, gen, cap: dict, steps: list,
                      rows, device, dtype, seconds=None) -> tuple:
    """The reference's answers for the sampled instances, in ``dtype``, in
    the order of ``program_answers``; ``seconds``, a dict, gets the time
    of each part."""
    m, w = cfg["model"], cfg["weights"]
    nx, nu = m["num_x"], m["num_u"]
    kw = dict(dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a), **kw)
    steps_mod = step_module(cfg)
    S = len(rows)

    def params(x0, u_prev, x_des):
        M = x0.shape[0]
        row = lambda v, n: t(v).reshape(1, n).expand(M, n)
        inf = float("inf")
        return Params(x0=x0, u_prev=u_prev, x_des=x_des,
                      q=row(w["Q"], nx), r=row(w["R"], nu),
                      rm=row(w["Rm"], nu), qf=row([0.0] * nx, nx),
                      xf_des=row([0.0] * nx, nx),
                      u_min=row(m["u_min"], nu), u_max=row(m["u_max"], nu),
                      x_min=row([-inf] * nx, nx), x_max=row([inf] * nx, nx))

    def one_step(p, X0, U0, warm, fixed_iters):
        step = steps_mod.make(cfg, p, dtype, device)
        return service_step(step, cfg, p, X0, U0, warm, fixed_iters)

    ref = lambda k: gen.reference(k, rows=rows).to(**kw)
    t0 = time.perf_counter()
    # the cold step: from zeros, the program's initial plan
    N = m["num_shooting_nodes"]
    p0 = params(t(cap["x0"][0]), torch.zeros(S, nu, **kw), ref(0))
    u_cold, cold = one_step(p0, torch.zeros(S, N + 1, nx, **kw),
                            torch.zeros(S, N, nu, **kw), False, 0)
    t1 = time.perf_counter()
    ks = np.asarray(steps)
    _, _, Xw, Uw = failed_rule(t(cap["status"][ks - 1]).reshape(-1),
                               t(cap["X"][ks - 1]).flatten(0, 1),
                               t(cap["U"][ks - 1]).flatten(0, 1))
    p = params(t(cap["x0"][ks]).flatten(0, 1),
               t(cap["u"][ks - 1]).flatten(0, 1),
               torch.cat([ref(k) for k in steps]))
    u_warm, warm = one_step(p, Xw, Uw, True, int(mix["fixed_warm_iters"]))
    if seconds is not None:
        seconds.update(cold=t1 - t0, warm=time.perf_counter() - t1)
    return tuple(a.cpu() for a in (u_warm, u_cold,
                                   torch.cat([warm.X, cold.X]),
                                   torch.cat([warm.U, cold.U])))


def gaps(answers, truth) -> dict:
    """The widest gap of each kind; an answer that is missing or not
    finite reads inf."""
    out = {}
    for name, a, b in zip(NAMES, answers, truth):
        d = (a.double() - b.double()).abs()
        out[name] = float(d.max()) if bool(torch.isfinite(d).all()) \
            else float("inf")
    return out


def compare(cell, gen, cap: dict, first: int, last: int, seed: int, device,
            control_dtypes=()):
    """(the compared numbers with their limits; for each of
    ``control_dtypes`` the same numbers with the reference in that dtype
    put in the program's place; the seconds of the float64 reference's
    cold and warm parts)."""
    cfg, mix = cell.config, cell.mix
    steps = check_steps(first, last, int(mix["check_steps"]), seed)
    rows = cap["rows"]
    timing: dict = {}
    truth = reference_answers(cfg, mix, gen, cap, steps, rows, device,
                              torch.float64, timing)
    compared = {k: {"value": v, "limit": cell.limits[k]}
                for k, v in gaps(program_answers(cap, steps), truth).items()}
    control = {}
    for dt in control_dtypes:
        ctrl = reference_answers(cfg, mix, gen, cap, steps, rows, device,
                                 getattr(torch, dt))
        control[dt] = gaps(ctrl, truth)
    return compared, control, timing
