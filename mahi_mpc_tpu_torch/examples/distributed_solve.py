"""One batched solve over every process of a ``torch.distributed`` job:
each rank solves its shards of the batch, and every rank gathers the whole
result.

    torchrun --standalone --nproc_per_node=2 \
        -m mahi_mpc_tpu_torch.examples.distributed_solve \
        --device cpu --backend gloo

or, starting the processes yourself, ``--coordinator localhost:<port>
--num-processes <n> --rank <r>`` in each.  The problem is the JAX package's
multi-process one (``tests/test_distributed.py``): ``double_pendulum``,
N=8, dt=0.02, |u| <= 6, tol 1e-5, at most 25 iterations, states and
references from numpy seed 7, the same in every process.  Rank 0 writes
``U.npy`` and ``status.npy`` (the gathered batch) to ``--out`` and prints
one JSON line; ``--scaling`` adds ``scaling_table``'s rows.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.parallel import (global_batch_mesh,
                                         initialize_distributed,
                                         make_sharded_solver,
                                         process_allgather, scaling_table,
                                         shard_params_global)
from mahi_mpc_tpu_torch.parallel.mesh import process_count, process_index
from mahi_mpc_tpu_torch.solver import solve_batch_fused
from mahi_mpc_tpu_torch.transcribe.shooting import (default_params,
                                                    make_problem, map_params)

N_NODES = 8


def problem(batch: int, device):
    """The problem and its host-replicated batch of parameters."""
    mp = ModelParameters("dist_dp", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=N_NODES, u_min=[-6.0, -6.0],
                         u_max=[6.0, 6.0], dynamics_name="double_pendulum")
    prob = make_problem(mp, make_dynamics("double_pendulum"))
    rng = np.random.default_rng(7)
    p = default_params(mp, device=device)._replace(
        q=torch.tensor([10.0, 1.0, 5.0, 5.0], device=device),
        r=torch.tensor([5.0, 5.0], device=device),
        rm=torch.tensor([0.1, 0.1], device=device))
    p = map_params(lambda a: a.expand((batch,) + a.shape).clone(), p)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    p = p._replace(x0=f32(0.2 * rng.standard_normal((batch, 4))),
                   x_des=f32(0.2 * rng.standard_normal((batch, N_NODES, 4))))
    return prob, p


def run(batch=16, device="cuda", backend=None, coordinator=None,
        num_processes=None, rank=None, local_device_ids=None, scaling=False):
    """Solve the batch over the global mesh; returns (summary, U, status),
    U and status gathered from every rank, on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    initialize_distributed(coordinator, num_processes, rank,
                           local_device_ids, backend)
    devices = None if device.type == "cuda" else [device]
    mesh = global_batch_mesh(devices=devices)
    here = mesh.devices[mesh.ranks == process_index()][0]
    prob, p = problem(batch, here)
    opts = SolverOptions(tol=1e-5, max_iter=25)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    launches = solve_batch_fused.launches
    res = fn(shard_params_global(p, mesh))
    U = process_allgather(res.U, device="cpu")
    status = process_allgather(res.status, device="cpu")
    out = {"rank": process_index(), "processes": process_count(),
           "backend": (torch.distributed.get_backend()
                       if torch.distributed.is_initialized() else None),
           "mesh": [str(d) for d in mesh.devices.flat],
           "batch": batch, "local_batch": int(res.U.shape[0]),
           "fused_launches": solve_batch_fused.launches - launches,
           "converged_frac": float((status == 0).double().mean()),
           "all_finite": bool(torch.isfinite(U).all()),
           "U_sum": float(U.double().sum())}
    if scaling:
        out["scaling"] = scaling_table(prob, p, opts)
    return out, U, status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card of LOCAL_RANK under "
                         "torchrun, else every visible card) or cpu")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl with a card, gloo without")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--local-device-ids", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None,
                    help="directory for rank 0's U.npy and status.npy")
    ap.add_argument("--scaling", action="store_true")
    a = ap.parse_args(argv)
    out, U, status = run(a.batch, a.device, a.backend, a.coordinator,
                         a.num_processes, a.rank, a.local_device_ids,
                         a.scaling)
    if out["rank"] == 0 and a.out:
        os.makedirs(a.out, exist_ok=True)
        np.save(os.path.join(a.out, "U.npy"), U.numpy())
        np.save(os.path.join(a.out, "status.npy"), status.numpy())
    print(json.dumps(out), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
