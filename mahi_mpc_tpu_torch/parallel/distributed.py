"""Multi-process runs over ``torch.distributed`` (port of
``mahi_mpc_tpu/parallel/distributed.py``).

Every process calls ``initialize_distributed()``, builds one global mesh
(``global_batch_mesh``: every rank's devices, in rank order) and runs the
same sharded solve on the shards it owns; ``process_allgather`` brings the
whole result to every rank.  Nothing in the solver changes: the batch axis
just gets longer.  The solve itself has no collective; only the gather,
the set-up and ``scaling_report``'s reductions communicate.

Launch one process a card with ``torchrun --nproc_per_node=<n>`` (it sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``), or start the processes yourself and pass the address,
the world size and the rank.  NCCL serves CUDA meshes and gloo CPU ones;
NCCL refuses two ranks on one card, so two processes sharing a card take
gloo, which gathers through the host.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (Mesh, _collective_device, default_devices, gather_batch,
                   make_mesh, process_count, scaling_report, shard_params,
                   split_batch)

__all__ = ["initialize_distributed", "global_batch_mesh",
           "make_global_array", "shard_params_global", "scaling_table",
           "local_devices", "process_allgather"]

# The devices this process drives, fixed by ``initialize_distributed``
# (None: ``local_devices``' default).
_local_device_ids: Optional[List[int]] = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           backend: Optional[str] = None) -> bool:
    """Join a multi-process job: ``torch.distributed.init_process_group``
    over TCP at ``coordinator_address`` ("host:port").

    Unset arguments come from torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Returns True when the
    process group is (already) initialized, False when nothing is
    configured (one process: callers need no branch).
    ``local_device_ids``: the CUDA devices this process drives (default
    ``LOCAL_RANK``'s card under torchrun, else every visible card).
    ``backend``: "nccl" or "gloo"; default NCCL when a card is visible,
    gloo otherwise.  NCCL without a card raises."""
    global _local_device_ids
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"a multi-process run needs the coordinator address, the number "
            f"of processes and this process's rank; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: choose 'nccl' or 'gloo'")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device; pass "
                           "backend='gloo' to run on the CPU")
    if local_device_ids is not None:
        _local_device_ids = [int(i) for i in local_device_ids]
    if backend == "nccl":
        torch.cuda.set_device(local_devices()[0])
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def local_devices() -> List[torch.device]:
    """The devices this process drives: ``local_device_ids`` of
    ``initialize_distributed``, else under torchrun the card of
    ``LOCAL_RANK``, else every visible card, else the CPU."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if _local_device_ids is not None:
        return [torch.device("cuda", i) for i in _local_device_ids]
    if "LOCAL_RANK" in os.environ:
        n = torch.cuda.device_count()
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]) % n)]
    return default_devices()


def global_batch_mesh(n_time: int = 1, devices=None) -> Mesh:
    """A ``(batch, time)`` mesh over every process's devices (``devices``,
    default ``local_devices()``), in rank order; every process must call
    this."""
    mine = [str(torch.device(d)) for d in (devices if devices is not None
                                           else local_devices())]
    if not dist.is_initialized():
        return make_mesh(n_time=n_time, devices=mine)
    every: list = [None] * process_count()
    dist.all_gather_object(every, mine)
    devs = [d for devs in every for d in devs]
    ranks = [r for r, devs in enumerate(every) for _ in devs]
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(-1, n_time), np.reshape(ranks, (-1, n_time)))


def make_global_array(value, mesh: Mesh) -> List[torch.Tensor]:
    """The shards this process owns of a host-replicated value (every
    process holds all of it)."""
    return split_batch(value, mesh)


def shard_params_global(p_batch, mesh: Mesh):
    """``shard_params`` of a host-replicated batch (its leaves numpy arrays
    or tensors): this process's shards."""
    return shard_params(p_batch, mesh)


def process_allgather(x, device=None):
    """Every process's instances of ``x``, concatenated in rank order, on
    every process: a tensor, a list of this process's shards, or a
    NamedTuple (a ``SolveResult``) of either.  ``device``: where the result
    lands (default the input's).  Each process must hold the same number of
    instances (the batch divisible by the mesh's batch axis)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[process_allgather(f, device) for f in x])
    local = gather_batch(x) if isinstance(x, (list, tuple)) else x
    device = local.device if device is None else torch.device(device)
    if not dist.is_initialized():
        return local.to(device)
    t = local.to(_collective_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).to(device)


def scaling_table(prob, p_batch, opts, n_time: int = 1) -> dict:
    """Solves/s on one device (``one_chip``), on every local device
    (``one_host``, when there is more than one) and, under a multi-process
    launch, on the global mesh (``global``; the only mesh every process
    takes part in), with ``one_host_efficiency`` = one_host / (n x
    one_chip)."""
    local = local_devices()
    out = {"process_count": process_count(), "local_devices": len(local)}
    if process_count() == 1:
        out["global_devices"] = len(local)
        one = make_mesh(n_batch=1, n_time=1, devices=local[:1])
        out["one_chip"] = scaling_report(prob, p_batch, one, opts)
        if len(local) > 1:
            host = make_mesh(n_time=n_time, devices=local)
            out["one_host"] = scaling_report(prob, p_batch, host, opts)
    else:
        mesh = global_batch_mesh(n_time=n_time)
        out["global_devices"] = mesh.size
        out["global"] = scaling_report(prob, p_batch, mesh, opts)
    if "one_host" in out:
        n = out["one_host"]["devices"]
        out["one_host_efficiency"] = (
            out["one_host"]["solves_per_s"]
            / (n * out["one_chip"]["solves_per_s"]))
    return out
