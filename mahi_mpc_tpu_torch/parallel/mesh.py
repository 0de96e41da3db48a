"""Device-mesh scenario-batch parallelism (port of
``mahi_mpc_tpu/parallel/mesh.py``).

The data-parallel axis is the scenario batch: thousands of independent MPC
instances, split over a ``(batch, time)`` grid of devices.

- ``batch``: scenario instances.  Each shard solves on its own device with
  no collective: every instance's solve is independent.
- ``time``: the horizon axis of ``parallel/time_shard.py``.

A ``Mesh`` is a grid of ``torch.device``s, each owned by one process (its
rank under ``torch.distributed``; 0 without it).  The grid may hold one
device more than once: the CPU tests split a batch into 8 shards on the
one CPU, and one card can hold two shards.  A sharded batch is a list with
one entry a shard this process owns, in batch order (``split_batch``,
``shard_params``); ``gather_batch`` concatenates it back.  A mesh of one
device splits nothing and copies nothing: its one shard is the caller's
tensor.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..params import SolverOptions
from ..solver.batched import solve_batch_lanes
from ..solver.fused import solve_batch_fused
from ..solver.select import resolve_warm_solver
from ..solver.sqp import SolveResult, solve_batch
from ..transcribe.shooting import MPCParams, ShootingProblem, map_params

Tensor = torch.Tensor
AXES = ("batch", "time")


def process_index() -> int:
    """This process's rank under ``torch.distributed``, else 0."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A ``(batch, time)`` grid of ``torch.device``s; ``ranks`` (the same
    shape) names the process that owns each, by default this one."""

    def __init__(self, devices, ranks=None):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(d)
        if grid.ndim != 2:
            raise ValueError(f"a mesh is a (batch, time) grid, got shape "
                             f"{grid.shape}")
        if len({d.type for d in grid.flat}) != 1:
            raise ValueError(f"a mesh holds one type of device, got "
                             f"{sorted({d.type for d in grid.flat})}")
        self.devices = grid
        self.ranks = (np.full(grid.shape, process_index()) if ranks is None
                      else np.asarray(ranks).reshape(grid.shape))
        self.axis_names = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}"
                f", ranks={self.ranks.ravel().tolist()})")


def default_devices() -> List[torch.device]:
    """Every visible CUDA device, or the CPU without one."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_batch: Optional[int] = None, n_time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(batch, time)`` mesh over ``devices`` (default: every visible
    CUDA device, or the CPU), taken in order, ``n_time`` to a row."""
    devices = list(devices if devices is not None else default_devices())
    if n_batch is None:
        n_batch = len(devices) // n_time
    if not 0 < n_batch * n_time <= len(devices):
        raise ValueError(f"mesh {n_batch}x{n_time} needs {n_batch * n_time} "
                         f"of the {len(devices)} devices given")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid[:n_batch * n_time].reshape(n_batch, n_time))


def axis_devices(mesh: Mesh, axis_name: str) -> List[torch.device]:
    """The devices along ``axis_name`` (at index 0 of the other axis)."""
    if axis_name == "batch":
        return list(mesh.devices[:, 0])
    if axis_name == "time":
        return list(mesh.devices[0, :])
    raise ValueError(f"unknown mesh axis {axis_name!r}; axes {AXES}")


def local_shards(mesh: Mesh) -> List[int]:
    """Indices of the batch shards this process owns."""
    me = process_index()
    return [k for k in range(mesh.shape["batch"]) if mesh.ranks[k, 0] == me]


def _pad_to_multiple(a: Tensor, m: int) -> Tensor:
    """Repeat the last instance into the padding, so every padded instance
    is a well-posed problem (a zero box would give no interior start)."""
    pad = (-a.shape[0]) % m
    if pad == 0:
        return a
    return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])


def split_batch(a, mesh: Mesh) -> List[Tensor]:
    """The shards this process owns of ``a`` (leading batch axis, any
    array-like), each on its shard's device.  A batch not divisible by the
    mesh's batch axis is padded by repeating its last instance."""
    a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    nb = mesh.shape["batch"]
    devs = axis_devices(mesh, "batch")
    if nb == 1 and mesh.ranks[0, 0] == process_index():
        return [a.to(devs[0])]
    a = _pad_to_multiple(a, nb)
    n = a.shape[0] // nb
    return [a[k * n:(k + 1) * n].to(devs[k]) for k in local_shards(mesh)]


def batch_spec(mesh: Mesh) -> Callable:
    """How a batch-leading array lies on ``mesh``: the function that splits
    one into its shards (``split_batch`` bound to the mesh), the
    counterpart of the JAX package's ``NamedSharding(mesh, P("batch"))``."""
    return functools.partial(split_batch, mesh=mesh)


def gather_batch(parts: Sequence[Tensor], n: Optional[int] = None,
                 device=None) -> Tensor:
    """Concatenate shards (on ``device``, default the first shard's) and
    keep the first ``n`` instances: the inverse of ``split_batch``.  One
    shard on its own device comes back as it is."""
    device = parts[0].device if device is None else torch.device(device)
    if len(parts) == 1:
        out = parts[0].to(device)
    else:
        out = torch.cat([t.to(device) for t in parts])
    return out if n is None or n == out.shape[0] else out[:n]


def shard_params(p_batch: MPCParams, mesh: Mesh) -> List[MPCParams]:
    """A batched ``MPCParams`` split over the mesh's batch axis: one
    ``MPCParams`` a shard this process owns, padded as ``split_batch``
    pads.  Every process may hold the whole (host-replicated) batch; each
    keeps only its own shards."""
    cols = map_params(lambda a: split_batch(a, mesh), p_batch)
    return [map_params(lambda parts, k=k: parts[k], cols)
            for k in range(len(local_shards(mesh)))]


def _shards(x, mesh: Mesh, count: int) -> list:
    """A warm start as shards: None, a list of shards, or a whole batch."""
    if x is None:
        return [None] * count
    return list(x) if isinstance(x, (list, tuple)) else split_batch(x, mesh)


def _sharded_solver(mesh: Mesh, solve: Callable, opts: SolverOptions,
                    pad_batch: bool, donate_warm_start: bool):
    """``fn(p_batch, X0=None, U0=None, mu0=None, gather=True)``: each batch
    shard solved by ``solve(p, X0, U0, mu0)`` on its device.  ``p_batch``,
    ``X0``, ``U0`` are whole batches or lists of shards; the result is one
    ``SolveResult`` of this process's instances (sliced back to the
    caller's batch), or with ``gather=False`` a list of per-shard results.
    With ``donate_warm_start`` the solver writes X and U into the given
    warm-start tensors (a whole batch's, or each shard's) and returns
    those; under a multi-process launch only shards are donated, since a
    process holds its own instances only."""
    nb = mesh.shape["batch"]

    def run(p_batch, X0=None, U0=None, mu0=None, gather: bool = True):
        whole = isinstance(p_batch, MPCParams)
        b = (X0.shape[0] if torch.is_tensor(X0)
             else p_batch.x0.shape[0] if whole else None)
        if b is not None and b % nb and not pad_batch:
            raise ValueError(f"batch {b} not divisible by the mesh's batch "
                             f"axis {nb}; pad it or pass pad_batch=True")
        if b is not None and b % nb and process_count() > 1:
            raise ValueError(f"a multi-process batch ({b}) must be divisible "
                             f"by the mesh's batch axis ({nb})")
        ps = shard_params(p_batch, mesh) if whole else list(p_batch)
        Xs, Us = _shards(X0, mesh, len(ps)), _shards(U0, mesh, len(ps))
        mu = opts.mu_init if mu0 is None else mu0
        res = [solve(p, X, U, mu) for p, X, U in zip(ps, Xs, Us)]
        if donate_warm_start and not torch.is_tensor(X0):
            res = [_donate(r, X, U) for r, X, U in zip(res, Xs, Us)]
        if not gather:
            return res
        if process_count() > 1:
            b = None          # this process's shards, unpadded
        out = SolveResult(*[gather_batch(parts, b) for parts in zip(*res)])
        if donate_warm_start and torch.is_tensor(X0) and b is not None:
            out = _donate(out, X0, U0)
        return out

    return run


def _donate(res: SolveResult, X: Optional[Tensor], U: Optional[Tensor]
            ) -> SolveResult:
    """Write the plan into the caller's warm-start buffers (where given)."""
    if X is not None and X is not res.X:
        res = res._replace(X=X.copy_(res.X))
    if U is not None and U is not res.U:
        res = res._replace(U=U.copy_(res.U))
    return res


def make_sharded_solver(prob: ShootingProblem, mesh: Mesh,
                        opts: SolverOptions = SolverOptions(),
                        donate_warm_start: bool = True):
    """The batched solve with the scenario batch split over ``mesh``.

    Returns ``fn(p_batch, X0, U0, mu0=None, gather=True) -> SolveResult``
    (see ``_sharded_solver``).  The route follows
    ``SolverOptions.warm_solver`` as the JAX package's does: the fused
    kernel's adaptive mode when it resolves to ``"fused"`` (on a CUDA mesh
    under ``"auto"``), else the lanes SQP for lanes-polymorphic or LTV
    dynamics, else ``solve_batch``.  A batch not divisible by the batch
    axis is padded by repeating its last instance and the results are
    sliced back.  ``donate_warm_start``: the solver may write its X and U
    into the caller's warm-start tensors (on every route)."""
    if resolve_warm_solver(opts, prob, mesh.devices.flat[0]) == "fused":
        return make_fused_sharded_solver(
            prob, mesh, opts, adaptive=True, pad_batch=True,
            donate_warm_start=donate_warm_start)
    batch_solve = (solve_batch_lanes
                   if prob.is_linear or prob.dynamics.supports_lanes
                   else solve_batch)
    return _sharded_solver(
        mesh, lambda p, X, U, mu0: batch_solve(prob, p, X, U, opts, mu0=mu0),
        opts, pad_batch=True, donate_warm_start=donate_warm_start)


def make_fused_sharded_solver(prob: ShootingProblem, mesh: Mesh,
                              opts: SolverOptions = SolverOptions(),
                              n_iter: Optional[int] = None,
                              adaptive: bool = False,
                              pad_batch: bool = False,
                              donate_warm_start: bool = False):
    """Each batch shard runs the fused kernel (``solve_batch_fused``: one
    launch a shard on a CUDA device, its plain version on the CPU).
    ``adaptive=True`` solves to tolerance; otherwise ``n_iter`` (default
    3) fixed iterations.  Without ``pad_batch`` the batch must be divisible
    by the batch axis.  ``donate_warm_start`` as in
    ``make_sharded_solver`` (the JAX package's fused route drops it)."""
    return _sharded_solver(
        mesh, lambda p, X, U, mu0: solve_batch_fused(
            prob, p, X, U, opts, mu0=mu0, n_iter=n_iter, adaptive=adaptive),
        opts, pad_batch=pad_batch, donate_warm_start=donate_warm_start)


def synchronize(devices) -> None:
    """Wait for every CUDA device among ``devices``."""
    for d in sorted({d for d in devices if d.type == "cuda"}, key=str):
        torch.cuda.synchronize(d)


def _collective_device() -> torch.device:
    """Where this process's collectives run: the CPU under gloo, its
    current CUDA device under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allreduce(values: Sequence[float], op) -> List[float]:
    """Reduce a few floats over every process of the process group."""
    if not dist.is_initialized():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64,
                     device=_collective_device())
    dist.all_reduce(t, op=op)
    return t.tolist()


def scaling_report(prob: ShootingProblem, p_batch: MPCParams, mesh: Mesh,
                   opts: SolverOptions = SolverOptions(),
                   iters: int = 3) -> dict:
    """Batched solves/s on this mesh, through whatever
    ``make_sharded_solver`` resolves to, in the bench's warm regime: a
    cold solve from zeros, then re-solves with per-instance x0 noise and a
    phase-shifting sinusoid reference (numpy seed 0), each warm-started
    from the last.  Times ``iters`` warm re-solves after 3 untimed ones:
    CUDA events on every card of the mesh (the latest end), the host clock
    on the CPU, every device synchronized before the clock stops; under a
    multi-process launch the slowest process's time."""
    n = p_batch.x0.shape[0]
    dtype = getattr(torch, opts.dtype)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    ps = shard_params(p_batch, mesh)
    nb = mesh.shape["batch"]
    n_p = n + (-n) % nb                      # the batch as padded
    place = lambda a: split_batch(torch.as_tensor(a, dtype=dtype), mesh)

    rng = np.random.default_rng(0)
    n_sched = max(iters, 3) + 3
    perts = [place(0.01 * rng.standard_normal((n_p, prob.nx)))
             for _ in range(n_sched)]
    tgrid = np.arange(1, prob.N + 1) * prob.dt
    ph = rng.uniform(0, 2 * np.pi, (n_p, 1, 1))
    amp = 0.2 * rng.standard_normal((n_p, 1, prob.nx))
    refs = [place(amp * np.sin(2 * np.pi * (tgrid[None, :, None]
                                            + r * prob.dt) + ph))
            for r in range(n_sched)]
    devs = [ps_k.x0.device for ps_k in ps]
    res = fn(ps, gather=False)                          # cold seed
    mu_warm = max(opts.warm_mu_factor * opts.tol, opts.mu_min)

    def step_i(i, prev):
        pp = [p._replace(x0=p.x0 + dp, x_des=ref) for p, dp, ref in
              zip(ps, perts[i % n_sched], refs[i % n_sched])]
        return fn(pp, [r.X for r in prev], [r.U for r in prev], mu_warm,
                  gather=False)

    for i in range(3):
        res = step_i(i, res)
    synchronize(devs)
    if dist.is_initialized():
        dist.barrier()
    cuda = [d for d in dict.fromkeys(devs) if d.type == "cuda"]
    marks = []
    for d in cuda:
        with torch.cuda.device(d):
            marks.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            marks[-1][0].record()
    t0 = time.perf_counter()
    for i in range(iters):
        res = step_i(i, res)
    for d, (_, end) in zip(cuda, marks):
        with torch.cuda.device(d):
            end.record()
    synchronize(devs)
    dt = time.perf_counter() - t0
    if cuda:
        dt = max(start.elapsed_time(end) for start, end in marks) / 1e3
    dt /= iters
    it = sum(float(r.iters.double().sum()) for r in res)
    conv = sum(float((r.status == 0).double().sum()) for r in res)
    cnt = sum(r.status.numel() for r in res)
    it, conv, cnt = _allreduce([it, conv, cnt], dist.ReduceOp.SUM)
    (dt,) = _allreduce([dt], dist.ReduceOp.MAX)
    kind = (torch.cuda.get_device_name(cuda[0]) if cuda else "cpu")
    return {
        "batch": n,
        "devices": mesh.size,
        "device_kind": kind,
        "wall_s_per_solve_batch": dt,
        "solves_per_s": n / dt,
        "solves_per_s_per_device": n / dt / mesh.size,
        "mean_iters": it / cnt,
        "converged_frac": conv / cnt,
    }
