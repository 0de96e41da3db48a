"""Online receding-horizon control runtime for one model (port of
``mahi_mpc_tpu/runtime/control.py``).

The reference's ``ModelControl`` (``src/Mahi/Mpc/ModelControl.cpp``): load
the model ``ModelGenerator`` wrote, run warm-started solves (``calc_u``,
``:116-172``), and serve a 1 kHz control thread from a free-running solver
thread (``start_calc``, ``:83-112``) through an immutable ``Plan`` swapped
by reference instead of the reference's three mutexes.

Cold solves go through ``solve``.  Warm re-solves go where
``resolve_warm_solver`` sends them for this device: on the card, by
default, the fused SQP kernel at batch 1 (``fixed_warm_iters`` iterations,
or adaptive when that is 0); else ``solve_fixed`` ("fixed") or ``solve``
from the warm barrier ("adaptive").  The warm start stays on the device,
and each ``calc_u`` copies its result to the host once.

Runtime mutation parity (C10): ``set_state`` (``:75-81``),
``update_weights`` (``:199-203``) and ``update_control_limits``
(``:205-209``) change solver inputs; the last two restart the barrier cold.
A solve that diverges or returns non-finite values keeps the previous plan
served (the stale-plan fallback) and is counted.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.base import Dynamics, make_dynamics
from ..ops.precision import strict_fp32
from ..params import ModelParameters, SolverOptions
from ..solver.fixed import solve_fixed
from ..solver.fused import solve_batch_fused
from ..solver.linearize import linearize_batch
from ..solver.select import resolve_warm_solver
from ..solver.sqp import DIVERGED, SolveResult, solve
from ..transcribe.shooting import (LinPoint, default_params, make_problem,
                                   map_params)
from .generate import read_manifest
from .plan import Plan, empty_plan


class SolveStats:
    """Per-solve metrics: latency quantiles, iteration and failure counts
    (the reference prints one rolling mean at shutdown,
    ``ModelControl.cpp:93-108``), and the fallback serves of
    ``control_at_time``: ``served_placeholder`` before any solve (undefined
    behaviour in the reference, ``ModelControl.cpp:195-196``) and
    ``served_stale`` while the last solve failed."""

    def __init__(self, capacity: int = 4096):
        self._times: list[float] = []
        self._iters: list[int] = []
        self._fails = 0
        self._count = 0
        self._cap = capacity
        self.served_placeholder = 0
        self.served_stale = 0

    def record(self, dt_s: float, iters: int, ok: bool) -> None:
        self._count += 1
        if not ok:
            self._fails += 1
        if len(self._times) < self._cap:
            self._times.append(dt_s)
            self._iters.append(iters)
        else:  # overwrite cyclically
            i = self._count % self._cap
            self._times[i] = dt_s
            self._iters[i] = iters

    def summary(self) -> dict:
        if not self._times:
            return {"solves": 0,
                    "served_placeholder": self.served_placeholder,
                    "served_stale": self.served_stale}
        t = np.asarray(self._times)
        return {
            "solves": self._count,
            "failures": self._fails,
            "served_placeholder": self.served_placeholder,
            "served_stale": self.served_stale,
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "mean_iters": float(np.mean(self._iters)),
        }


class ModelControl:
    """Warm-started receding-horizon MPC runtime for one model, on the CUDA
    card unless ``device`` says otherwise (``"cpu"`` runs the kernels'
    plain versions).

    Construction mirrors ``ModelControl(model_name, Q, R, Rm, opts)``
    (``ModelControl.hpp:26-33``): the name of a model in ``directory``
    (written by this package's ``generate_model`` or the JAX package's,
    whose ``.mpcx`` files are ignored and the model rebuilt from its
    ``dynamics_name``), or a ``ModelParameters`` (+ ``dynamics``).
    ``opts=None`` takes the options the model was generated for (its
    manifest), else the defaults; given options always decide.
    """

    def __init__(self, model_name: str | ModelParameters,
                 Q: Optional[Sequence[float]] = None,
                 R: Optional[Sequence[float]] = None,
                 Rm: Optional[Sequence[float]] = None,
                 opts: Optional[SolverOptions] = None,
                 directory: str | Path = ".",
                 dynamics: Optional[Dynamics] = None,
                 use_native_server: bool = False,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelControl runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" to run on the CPU")
        self.device = device
        if isinstance(model_name, ModelParameters):
            self.params, self.manifest = model_name, None
        else:
            self.params = ModelParameters.load(model_name, directory)
            self.manifest = read_manifest(self.params.name, directory)
        if opts is None:
            opts = (self.manifest["solver_options"] if self.manifest
                    else SolverOptions())
        self.opts = opts
        mp = self.params
        if dynamics is None:
            if not mp.dynamics_name:
                raise ValueError(
                    f"model {mp.name!r} names no dynamics to rebuild from; "
                    "pass a Dynamics")
            dynamics = make_dynamics(mp.dynamics_name, **mp.dynamics_kwargs)
        self.dynamics = dynamics
        self.problem = make_problem(mp, dynamics)
        self._dtype = getattr(torch, opts.dtype)
        self.warm_solver = resolve_warm_solver(opts, self.problem, device)

        nx, nu, N = mp.num_x, mp.num_u, mp.num_shooting_nodes
        p = default_params(mp, dtype=self._dtype, device=device)
        if Q is not None:
            p = p._replace(q=self._tensor(Q))
        if R is not None:
            p = p._replace(r=self._tensor(R))
        if Rm is not None:
            p = p._replace(rm=self._tensor(Rm))
        self._p = p

        # Warm start (C7: the previous optimum seeds the next solve,
        # ModelControl.cpp:161; zeros on load, :29-45), kept on the device.
        self._X0 = torch.zeros(N + 1, nx, dtype=self._dtype, device=device)
        self._U0 = torch.zeros(N, nu, dtype=self._dtype, device=device)
        # Cold solves descend from mu_init; warm ones restart near tol.
        self._mu_cold = float(opts.mu_init)
        self._mu_warm = max(opts.warm_mu_factor * opts.tol, opts.mu_min)
        self._is_warm = False

        # Latest measured inputs (set_state, ModelControl.cpp:75-81).
        self._state_lock = threading.Lock()
        self._t = 0.0
        self._x = np.zeros(nx)
        self._u = np.zeros(nu)
        self._traj = np.zeros((N, nx))

        # The served plan: immutable, swapped by reference
        # (ModelControl.cpp:186-189's m_output_mutex).
        self._plan: Plan = empty_plan(nx, nu)
        # Optional native plan server: a wait-free seqlock handoff for
        # hard-real-time consumers (runtime/native/plan_server.cpp).
        self._native = None
        if use_native_server:
            from .native import NativePlanServer
            self._native = NativePlanServer(nx, nu, N)

        self._calc_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stale = False
        self.stats = SolveStats()

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               dtype=self._dtype, device=self.device)

    # -- the solves ----------------------------------------------------------

    def _solve_cold(self, p, X0, U0, mu0) -> SolveResult:
        return solve(self.problem, p, X0, U0, self.opts, mu0=mu0)

    def _solve_warm(self, p, X0, U0, mu0) -> SolveResult:
        prob, opts = self.problem, self.opts
        k = opts.fixed_warm_iters
        if self.warm_solver == "fused":
            # One launch of the fused kernel for the one instance.
            kw = dict(n_iter=k) if k > 0 else dict(adaptive=True)
            res = solve_batch_fused(prob, map_params(lambda a: a[None], p),
                                    X0[None], U0[None], opts, mu0=mu0, **kw)
            return SolveResult(*[a[0] for a in res])
        if self.warm_solver == "fixed":
            return solve_fixed(prob, p, X0, U0, opts, mu0=mu0, n_iter=k)
        return solve(prob, p, X0, U0, opts, mu0=mu0)

    def warmup(self) -> None:
        """Pay first-use costs now (the reference's first cold solve hides
        in a 100 ms sleep, ``thread_model_control_example.cpp:66-68``): one
        cold solve from the default inputs, and the build of the libraries
        its calls launch (``generate.kernel_libraries``: the fused kernel's
        when warm solves launch it, in LTV the linearization's)."""
        self._solve_cold(self._p, self._X0, self._U0, self._mu_cold)
        from .._build import cuda_build
        from .generate import kernel_libraries
        for name in kernel_libraries(self.problem, self.opts, self.device):
            cuda_build(name)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- runtime mutation (C10) ----------------------------------------------

    def set_state(self, t: float, x: Sequence[float], u: Sequence[float],
                  traj: np.ndarray) -> None:
        """Latest measurement + reference trajectory for the solver thread
        (``ModelControl.cpp:75-81``).  traj: (N, nx)."""
        with self._state_lock:
            self._t = float(t)
            self._x = np.asarray(x, float).copy()
            self._u = np.asarray(u, float).copy()
            self._traj = np.asarray(traj, float).reshape(
                self.params.num_shooting_nodes, self.params.num_x).copy()

    def update_weights(self, Q: Optional[Sequence[float]] = None,
                       R: Optional[Sequence[float]] = None,
                       Rm: Optional[Sequence[float]] = None) -> None:
        """(``ModelControl.cpp:199-203``).  The warm start was optimal for
        the old weights, so the next solve restarts the barrier cold."""
        with self._state_lock:
            p = self._p
            if Q is not None:
                p = p._replace(q=self._tensor(Q))
            if R is not None:
                p = p._replace(r=self._tensor(R))
            if Rm is not None:
                p = p._replace(rm=self._tensor(Rm))
            self._p = p
            self._is_warm = False

    def update_control_limits(self, u_min: Sequence[float],
                              u_max: Sequence[float]) -> None:
        """(``ModelControl.cpp:205-209``).  Restarts the barrier cold: a
        warm interior-point start across a change of the feasible set can
        sit outside or hug the new bounds, and a floor-level barrier gives
        Newton no centering."""
        with self._state_lock:
            self._p = self._p._replace(u_min=self._tensor(u_min),
                                       u_max=self._tensor(u_max))
            self._is_warm = False

    # -- the hot path (calc_u, ModelControl.cpp:116-172) ---------------------

    def calc_u(self, t: float, state: Sequence[float],
               control: Sequence[float], traj: np.ndarray) -> Plan:
        """One warm-started solve; returns (and installs) the new plan."""
        mp = self.params
        x0, u0 = self._tensor(state), self._tensor(control)
        with self._state_lock:
            p, warm = self._p, self._is_warm
        p = p._replace(x_des=self._tensor(traj).reshape(
            mp.num_shooting_nodes, mp.num_x), x0=x0, u_prev=u0)
        if mp.is_linear:
            # Successive linearization (C8): freeze A, B, x_dot at the
            # measured point (ModelControl.cpp:125-135); on the card the
            # linearization kernel at B=1.
            with strict_fp32():
                A, B, xd0 = [a[0] for a in linearize_batch(
                    self.dynamics, x0[None], u0[None])]
            p = p._replace(lin=LinPoint(A, B, xd0, x0, u0))

        fn = self._solve_warm if warm else self._solve_cold
        t0 = time.perf_counter()
        res = fn(p, self._X0, self._U0,
                 self._mu_warm if warm else self._mu_cold)
        # One device-to-host copy of the whole result.
        flat = torch.cat([res.X.reshape(-1), res.U.reshape(-1),
                          torch.stack([res.iters.to(res.X.dtype),
                                       res.status.to(res.X.dtype),
                                       res.kkt, res.feas, res.obj])])
        host = flat.to("cpu", torch.float64).numpy()
        dt = time.perf_counter() - t0
        nX = res.X.numel()
        X = host[:nX].reshape(res.X.shape)
        U = host[nX:nX + res.U.numel()].reshape(res.U.shape)
        iters, status, kkt, feas, obj = host[-5:]
        iters, status = int(iters), int(status)

        ok = (status != DIVERGED and bool(np.isfinite(X).all())
              and bool(np.isfinite(U).all()))
        self.stats.record(dt, iters, ok)
        if not ok:
            # Stale-plan fallback: serves count as stale until a solve
            # succeeds.
            self._stale = True
            return self._plan
        self._stale = False

        self._X0, self._U0 = res.X, res.U     # next warm start, on device
        with self._state_lock:
            self._is_warm = True
        times = t + np.arange(mp.num_shooting_nodes + 1) * mp.step_size
        plan = Plan(times=times, X=X, U=U, iters=iters, status=status,
                    kkt=float(kkt), feas=float(feas), obj=float(obj),
                    solve_time_s=dt)
        self._plan = plan
        if self._native is not None:
            self._native.publish(plan.times, plan.X, plan.U)
        return plan

    # -- the solver thread (C9, ModelControl.cpp:83-112) ---------------------

    def start_calc(self) -> None:
        """Spawn the free-running solver thread: snapshot the latest inputs,
        solve, swap the plan, repeat.  Its kernels go to the thread's own
        current stream."""
        if self._calc_thread is not None and self._calc_thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                with self._state_lock:
                    t, x, u, traj = self._t, self._x, self._u, self._traj
                self.calc_u(t, x, u, traj)

        self._calc_thread = threading.Thread(
            target=loop, daemon=True, name=f"mpc-solver-{self.params.name}")
        self._calc_thread.start()

    def stop_calc(self, timeout: float = 5.0) -> None:
        """Join the solver thread (the reference's destructor spin-waits,
        ``ModelControl.cpp:16-19``)."""
        self._stop.set()
        if self._calc_thread is not None:
            self._calc_thread.join(timeout)
            self._calc_thread = None

    # -- plan access (control thread side) -----------------------------------

    def control_at_time(self, t: float) -> np.ndarray:
        """ZOH control (``ModelControl.cpp:192-197``); safe before the first
        solve, and fallback serves are counted."""
        plan = self._plan
        if plan.status == -1:
            self.stats.served_placeholder += 1
        elif self._stale:
            self.stats.served_stale += 1
        if self._native is not None:
            u = self._native.sample(t)
            if u is not None:
                return u
        return plan.control_at_time(t)

    def control_results(self) -> Plan:
        """The latest plan (``ModelControl.hpp:40``)."""
        return self._plan

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_calc()
        return False
