"""Batched scenario MPC service (port of
``mahi_mpc_tpu/runtime/batch_service.py``, without the device mesh).

One service owns B instances of one model — per-instance states,
references and weights — and advances them together: each ``step()`` is
one batched solve, warm-started from the previous plan.  Two routes, as
``solver/select.py`` resolves ``opts.warm_solver``:

- ``"fused"``: the fused kernel.  The first step seeds cold through its
  adaptive mode; warm steps run ``opts.fixed_warm_iters`` fixed
  iterations, or adaptive when that is 0.
- ``"fixed"`` / ``"adaptive"``: the lanes SQP ``solve_batch_lanes`` (with
  the Riccati kernel under it on a CUDA device), cold and warm, to
  tolerance from the cold or warm barrier; ``fixed_warm_iters`` has no
  effect there, as in the JAX package's service.  Dynamics that are
  neither lanes-polymorphic nor LTV take ``solve_batch`` instead, the
  counterpart of the JAX service's ``jax.vmap(solve)``.

LTV models (``params.is_linear``, reference C8) refreeze each instance's
linearization at its measured state before every step (``relinearize``)
and then take the same route.

Instances carry independent status: a failed instance (DIVERGED or
non-finite) gets a zero warm start, returns a zero control this step, and
re-solves from scratch next step, as in the JAX package.
``state_dict``/``load_state`` snapshot the (params, plan) pair in the JAX
package's format, so either package loads the other's.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from ..convert import params_from_numpy, params_to_numpy
from ..models.base import Dynamics, make_dynamics
from ..ops.precision import strict_fp32
from ..params import ModelParameters, SolverOptions
from ..solver.batched import solve_batch_lanes
from ..solver.fused import solve_batch_fused
from ..solver.riccati import resolve_kkt_backend
from ..solver.select import resolve_warm_solver
from ..solver.sqp import DIVERGED, solve_batch
from ..transcribe.shooting import (LinPoint, default_params, make_problem,
                                   map_params)


class BatchModelControl:
    """Receding-horizon MPC for a batch of B instances of one model, on one
    device: the CUDA card unless ``device`` says otherwise (``"cpu"`` runs
    the kernels' plain PyTorch versions)."""

    def __init__(self, params: ModelParameters, batch: int,
                 dynamics: Optional[Dynamics] = None,
                 opts: SolverOptions = SolverOptions(),
                 device="cuda", Q=None, R=None, Rm=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchModelControl runs on a CUDA device by default and none "
                "is available; pass device=\"cpu\" to run on the CPU")
        if dynamics is None:
            dynamics = make_dynamics(params.dynamics_name,
                                     **params.dynamics_kwargs)
        self.params = params
        self.dynamics = dynamics
        self.opts = opts
        self.batch = batch
        self.device = device
        self.problem = make_problem(params, dynamics)
        self.warm_solver = resolve_warm_solver(opts, self.problem,
                                               self.device)
        nx, nu, N = params.num_x, params.num_u, params.num_shooting_nodes
        # Off the fused route: the lanes SQP, or one instance at a time
        # through solve_batch for dynamics it cannot batch in lanes (the
        # JAX service's use_lanes rule).
        self._lanes = params.is_linear or dynamics.supports_lanes
        # The KKT backend as the solver resolves it ("pallas" is the
        # Riccati kernel); None on the fused route.
        self.kkt_backend = None if self.warm_solver == "fused" else \
            resolve_kkt_backend(opts.kkt_backend, batched=self._lanes,
                                dims=(N, nx + nu, nu), device=self.device)
        self._dtype = getattr(torch, opts.dtype)

        p = default_params(params, dtype=self._dtype, device=self.device)
        if Q is not None:
            p = p._replace(q=self._tensor(Q))
        if R is not None:
            p = p._replace(r=self._tensor(R))
        if Rm is not None:
            p = p._replace(rm=self._tensor(Rm))
        self._p = map_params(
            lambda a: a.expand((batch,) + a.shape).clone(), p)
        self._X = torch.zeros(batch, N + 1, nx, dtype=self._dtype,
                              device=self.device)
        self._U = torch.zeros(batch, N, nu, dtype=self._dtype,
                              device=self.device)
        self._mu_cold = float(opts.mu_init)
        self._mu_warm = max(opts.warm_mu_factor * opts.tol, opts.mu_min)
        self._warm = False
        # LTV: (A, B, x_dot0) of every instance at once, built once.
        self._relin = vmap(dynamics.linearize) if params.is_linear else None
        self.last = None          # last SolveResult
        self.solve_time_s = 0.0

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=self._dtype, device=self.device)

    # -- per-instance mutation ------------------------------------------------

    def set_states(self, x0, u_prev=None):
        """Measured states for all instances: (B, nx)."""
        self._p = self._p._replace(x0=self._tensor(x0))
        if u_prev is not None:
            self._p = self._p._replace(u_prev=self._tensor(u_prev))

    def set_references(self, x_des):
        """Per-instance reference trajectories: (B, N, nx)."""
        self._p = self._p._replace(x_des=self._tensor(x_des))

    def relinearize(self):
        """LTV mode (C8): refreeze each instance's (A, B, x_dot0) at its
        current measured state and previous control — the batched analogue
        of the reference's per-cycle ``get_A/get_B/get_x_dot``
        (``ModelControl.cpp:125-135``).  No-op for nonlinear models."""
        if self._relin is None:
            return
        p = self._p
        with strict_fp32():
            A, B, xd0 = self._relin(p.x0, p.u_prev)
        self._p = p._replace(lin=LinPoint(A, B, xd0, p.x0, p.u_prev))

    def update_weights(self, Q=None, R=None, Rm=None):
        """Per-instance (B, nx)/(B, nu) or broadcastable weight updates."""
        p = self._p
        B = self.batch
        cast = lambda v, n: self._tensor(v).expand(B, n).clone()
        if Q is not None:
            p = p._replace(q=cast(Q, self.params.num_x))
        if R is not None:
            p = p._replace(r=cast(R, self.params.num_u))
        if Rm is not None:
            p = p._replace(rm=cast(Rm, self.params.num_u))
        self._p = p

    # -- the service step -----------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> torch.Tensor:
        """One batched warm-started solve; returns first controls (B, nu)
        on the service's device."""
        self.relinearize()
        opts = self.opts
        if self.warm_solver != "fused":
            solve, kw = (solve_batch_lanes if self._lanes else solve_batch), {}
        elif self._warm and opts.fixed_warm_iters > 0:
            solve, kw = solve_batch_fused, dict(n_iter=opts.fixed_warm_iters)
        else:
            solve, kw = solve_batch_fused, dict(adaptive=True)
        self._sync()
        t0 = time.perf_counter()
        res = solve(self.problem, self._p, self._X, self._U, opts,
                    mu0=self._mu_warm if self._warm else self._mu_cold, **kw)
        self._sync()
        self.solve_time_s = time.perf_counter() - t0

        # A failed instance re-solves from scratch: zero warm start.
        ok = ((res.status != DIVERGED)
              & torch.isfinite(res.X).all(dim=(1, 2))
              & torch.isfinite(res.U).all(dim=(1, 2)))
        self._X = torch.where(ok[:, None, None], res.X, 0.0)
        self._U = torch.where(ok[:, None, None], res.U, 0.0)
        self._warm = True
        self.last = res
        return torch.where(ok[:, None], res.U[:, 0], 0.0)

    def metrics(self) -> dict:
        res = self.last
        if res is None:
            return {}
        return {
            "batch": self.batch,
            "solve_s": self.solve_time_s,
            "solves_per_s": self.batch / max(self.solve_time_s, 1e-12),
            "mean_iters": float(res.iters.float().mean()),
            "converged_frac": float((res.status == 0).float().mean()),
            "max_feas": float(res.feas.max()),
        }

    # -- checkpoint / resume --------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "params": params_to_numpy(self._p),
            "X": self._X.cpu().numpy(),
            "U": self._U.cpu().numpy(),
            "warm": self._warm,
        }

    def load_state(self, st: dict) -> None:
        """Load a ``state_dict`` of this package or of the JAX package's
        ``BatchModelControl``."""
        self._p = params_from_numpy(st["params"], self.device, self._dtype)
        self._X = self._tensor(st["X"])
        self._U = self._tensor(st["U"])
        self._warm = bool(st["warm"])
