"""Batched scenario MPC service (port of
``mahi_mpc_tpu/runtime/batch_service.py``).

One service owns B instances of one model — per-instance states,
references and weights — and advances them together: each ``step()`` is
one batched solve, warm-started from the previous plan.  The instances are
split over a device mesh's batch axis (``parallel/mesh.py``): each shard
holds its parameters and plan on its device and solves there, with no
collective.  A mesh of one device (the default on one card, and on the
CPU) holds the whole batch as one shard: no split, no copy.  Two routes, as
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
linearization at its measured state before every step (``relinearize``:
on the card the linearization kernel of ``solver/linearize.py`` on each
shard's device, for every model with a CUDA form) and then take the same
route; the fused route's discretization is a kernel too.

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

from ..convert import params_from_numpy, params_to_numpy
from ..models.base import Dynamics, make_dynamics
from ..ops.precision import strict_fp32
from ..parallel.mesh import (Mesh, axis_devices, default_devices,
                             gather_batch, make_mesh, shard_params,
                             split_batch, synchronize)
from ..params import ModelParameters, SolverOptions
from ..solver.batched import solve_batch_lanes
from ..solver.fused import solve_batch_fused
from ..solver.linearize import linearize_batch
from ..solver.riccati import resolve_kkt_backend
from ..solver.select import resolve_warm_solver
from ..solver.sqp import DIVERGED, SolveResult, solve_batch
from ..transcribe.shooting import (LinPoint, MPCParams, default_params,
                                   make_problem, map_params)
from ..utils.profiling import annotate


class BatchModelControl:
    """Receding-horizon MPC for a batch of B instances of one model, on a
    mesh of devices: by default every visible CUDA card (at most B of
    them) for ``device="cuda"``, else ``device`` alone (``"cuda:1"``; or
    ``"cpu"``, which runs the kernels' plain PyTorch versions).  ``mesh``
    (``parallel.make_mesh``) overrides that; its devices must belong to
    this process."""

    def __init__(self, params: ModelParameters, batch: int,
                 dynamics: Optional[Dynamics] = None,
                 opts: SolverOptions = SolverOptions(),
                 device="cuda", mesh: Optional[Mesh] = None,
                 Q=None, R=None, Rm=None):
        device = torch.device(device)
        if mesh is None:
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "BatchModelControl runs on a CUDA device by default and "
                    "none is available; pass device=\"cpu\" to run on the "
                    "CPU")
            # "cuda" means every visible card, "cuda:k" that card alone.
            devices = (default_devices()
                       if device.type == "cuda" and device.index is None
                       else [device])
            mesh = make_mesh(n_batch=min(batch, len(devices)),
                             devices=devices)
        if mesh.device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{mesh} needs a CUDA device and none is "
                               "available")
        if (mesh.ranks != mesh.ranks.flat[0]).any():
            raise ValueError("BatchModelControl serves a mesh of one "
                             "process's devices")
        if dynamics is None:
            dynamics = make_dynamics(params.dynamics_name,
                                     **params.dynamics_kwargs)
        self.params = params
        self.dynamics = dynamics
        self.opts = opts
        self.batch = batch
        self.mesh = mesh
        self._devices = axis_devices(mesh, "batch")
        self.device = self._devices[0]
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
        # Per shard: parameters, plan (X, U) and the last SolveResult.
        self._ps = shard_params(map_params(
            lambda a: a.expand((batch,) + a.shape).clone(), p), mesh)
        self._Xs = self._split(torch.zeros(batch, N + 1, nx,
                                           dtype=self._dtype,
                                           device=self.device))
        self._Us = self._split(torch.zeros(batch, N, nu, dtype=self._dtype,
                                           device=self.device))
        self._mu_cold = float(opts.mu_init)
        self._mu_warm = max(opts.warm_mu_factor * opts.tol, opts.mu_min)
        self._warm = False
        self._results = None
        self._last = None
        self.solve_time_s = 0.0
        # Steps taken; the step id of the spans a step opens.
        self.steps = 0

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=self._dtype, device=self.device)

    def _split(self, v) -> list:
        """A whole batch as the mesh's shards (itself on a one-device mesh)."""
        return split_batch(self._tensor(v), self.mesh)

    def _gather(self, parts) -> torch.Tensor:
        return gather_batch(parts, self.batch, self.device)

    def _set(self, **fields) -> None:
        """Replace parameter fields, each given as a whole batch."""
        cols = {k: self._split(v) for k, v in fields.items()}
        self._ps = [p._replace(**{k: c[i] for k, c in cols.items()})
                    for i, p in enumerate(self._ps)]

    # The whole batch, gathered from the shards (one shard: itself).
    @property
    def _p(self) -> MPCParams:
        if len(self._ps) == 1:
            return self._ps[0]
        return MPCParams(*[
            LinPoint(*[self._gather(parts) for parts in zip(*f)])
            if isinstance(f[0], LinPoint) else self._gather(f)
            for f in zip(*self._ps)])

    @property
    def _X(self) -> torch.Tensor:
        return self._gather(self._Xs)

    @property
    def _U(self) -> torch.Tensor:
        return self._gather(self._Us)

    @property
    def last(self) -> Optional[SolveResult]:
        """The last step's SolveResult over the whole batch."""
        if self._last is None and self._results is not None:
            self._last = SolveResult(*[self._gather(parts)
                                       for parts in zip(*self._results)])
        return self._last

    # -- per-instance mutation ------------------------------------------------

    def set_states(self, x0, u_prev=None):
        """Measured states for all instances: (B, nx)."""
        with annotate("service.set_states", step=self.steps + 1):
            self._set(x0=x0)
            if u_prev is not None:
                self._set(u_prev=u_prev)

    def set_references(self, x_des):
        """Per-instance reference trajectories: (B, N, nx)."""
        with annotate("service.set_references", step=self.steps + 1):
            self._set(x_des=x_des)

    def relinearize(self):
        """LTV mode (C8): refreeze each instance's (A, B, x_dot0) at its
        current measured state and previous control — the batched analogue
        of the reference's per-cycle ``get_A/get_B/get_x_dot``
        (``ModelControl.cpp:125-135``), on each shard's device: one launch
        of the linearization kernel a shard (``linearize_batch``; its plain
        version on the CPU and on the eager route).  No-op for nonlinear
        models."""
        if not self.params.is_linear:
            return
        with annotate("service.relinearize"):
            ps = []
            for p in self._ps:
                with strict_fp32():
                    A, B, xd0 = linearize_batch(self.dynamics, p.x0,
                                                p.u_prev)
                ps.append(p._replace(lin=LinPoint(A, B, xd0, p.x0,
                                                  p.u_prev)))
            self._ps = ps

    def update_weights(self, Q=None, R=None, Rm=None):
        """Per-instance (B, nx)/(B, nu) or broadcastable weight updates."""
        B = self.batch
        cast = lambda v, n: self._tensor(v).expand(B, n).clone()
        if Q is not None:
            self._set(q=cast(Q, self.params.num_x))
        if R is not None:
            self._set(r=cast(R, self.params.num_u))
        if Rm is not None:
            self._set(rm=cast(Rm, self.params.num_u))

    # -- the service step -----------------------------------------------------

    def _sync(self):
        synchronize(self._devices)

    def step(self) -> torch.Tensor:
        """One batched warm-started solve, each shard on its device;
        returns first controls (B, nu) on the service's device.  Its spans
        (``utils.profiling.annotate``, recorded while a profiler collects)
        carry the step's number, ``steps``."""
        self.steps += 1
        with annotate("service.step", step=self.steps):
            self.relinearize()
            opts = self.opts
            if self.warm_solver != "fused":
                solve = solve_batch_lanes if self._lanes else solve_batch
                kw = {}
            elif self._warm and opts.fixed_warm_iters > 0:
                solve = solve_batch_fused
                kw = dict(n_iter=opts.fixed_warm_iters)
            else:
                solve, kw = solve_batch_fused, dict(adaptive=True)
            mu0 = self._mu_warm if self._warm else self._mu_cold
            with annotate("service.sync", at="before"):
                self._sync()
            t0 = time.perf_counter()
            with annotate("service.solve"):
                results = [solve(self.problem, p, X, U, opts, mu0=mu0, **kw)
                           for p, X, U in zip(self._ps, self._Xs, self._Us)]
            with annotate("service.sync", at="after"):
                self._sync()
            self.solve_time_s = time.perf_counter() - t0

            # A failed instance re-solves from scratch: zero warm start.
            with annotate("service.status"):
                us = []
                for k, res in enumerate(results):
                    ok = ((res.status != DIVERGED)
                          & torch.isfinite(res.X).all(dim=(1, 2))
                          & torch.isfinite(res.U).all(dim=(1, 2)))
                    self._Xs[k] = torch.where(ok[:, None, None], res.X, 0.0)
                    self._Us[k] = torch.where(ok[:, None, None], res.U, 0.0)
                    us.append(torch.where(ok[:, None], res.U[:, 0], 0.0))
            self._warm = True
            self._results, self._last = results, None
            with annotate("service.gather"):
                return self._gather(us)

    def metrics(self) -> dict:
        res = self.last
        if res is None:
            return {}
        return {
            "batch": self.batch,
            "solve_s": self.solve_time_s,
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
        ``BatchModelControl``, onto this service's mesh."""
        self._ps = shard_params(
            params_from_numpy(st["params"], self.device, self._dtype),
            self.mesh)
        self._Xs = self._split(st["X"])
        self._Us = self._split(st["U"])
        self._warm = bool(st["warm"])
