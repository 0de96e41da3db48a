"""The service step worked out again: the solve the service runs for a
cold or a warm step, and its rule for a failed instance.  The model's
discrete step is the configuration's own (``reference/steps/<name>.py``,
named by the configuration's ``reference``).  Every function takes
batch-leading tensors of one dtype; nothing here reads what the program
derived."""

from __future__ import annotations

from pathlib import Path

from .sqp import Params, Result, failed_rule, solve

STEPS = Path(__file__).resolve().parent / "steps"


def step_module(cfg: dict):
    """The configuration's reference step, found by the name it gives
    (``make(cfg, params, dtype, device)`` returns the discrete step)."""
    from portbench.core import load_module
    path = STEPS / f"{cfg['reference']}.py"
    if not path.exists():
        raise FileNotFoundError(f"{cfg['name']}: no reference step {path}")
    return load_module(path)


def service_step(step, cfg: dict, p: Params, X0, U0, warm: bool,
                 fixed_iters: int):
    """One step of the service for M independent instances, in the
    discrete ``step``: a cold step (adaptive from mu_init) or a warm step
    (``fixed_iters`` iterations at the warm barrier, or adaptive when it
    is 0).  Returns the control each instance gets and the solve's result
    with the plan as the service keeps it (zeros for a failed instance)."""
    sv = cfg["solver"]
    tol, mu_min = float(sv["tol"]), float(sv["mu_min"])
    if warm:
        mu0 = max(float(sv["warm_mu_factor"]) * tol, mu_min)
        adaptive = fixed_iters == 0
        n_iter = int(sv["max_iter"]) if adaptive else fixed_iters
    else:
        mu0, adaptive, n_iter = float(sv["mu_init"]), True, int(sv["max_iter"])
    res = solve(step, p, X0, U0, mu0, n_iter, adaptive, tol, mu_min,
                float(sv["kappa_mu"]))
    _, u, X, U = failed_rule(res.status, res.X, res.U)
    return u, Result(X, U, res.status, res.iters)
