"""Horizon (sequence-parallel) sharding of the Riccati KKT solve (port of
``mahi_mpc_tpu/parallel/time_shard.py``).

The block-tridiagonal KKT solve is an associative scan over stages
(``solver/pariccati.py``), so it splits over a ``time`` mesh axis.  Each
of the T time shards runs a local scan over its N/T stages on its own
device; the shards exchange one boundary element each (the stack of the T
aggregates, moved to every shard's device: the JAX package's
``all_gather``), a static O(T) fold composes the cross-shard products, and
each shard corrects its local results.  Depth: O(log(N/T)) local + O(T)
boundary.

It exists for very long horizons; at the benchmark's N = 25 one device
wants the plain scan.
"""

from __future__ import annotations

import torch

from ..ops.precision import strict_fp32
from ..solver.pariccati import (Affine, _Element, _mv, affine_combine,
                                combine, eliminate, forward_maps,
                                inclusive_scan, recover_du, stage_leading)
from ..solver.riccati import LQRSolution, register_backend
from ..solver.stage_qp import StageQP
from .mesh import Mesh, axis_devices

_PER_STAGE = 8          # StageQP's fields before Hf, gf


def _exchange(aggs: list, dev: torch.device):
    """The T shards' aggregates stacked on ``dev`` (leading axis T)."""
    return type(aggs[0])(*[torch.stack([a.to(dev) for a in field])
                           for field in zip(*aggs)])


def _at(stack, j: int):
    return type(stack)(*[a[j] for a in stack])


@strict_fp32()
def solve_lqr_time_sharded(qp: StageQP, mesh: Mesh,
                           axis_name: str = "time") -> LQRSolution:
    """LQR solve with the horizon split over ``mesh``'s ``axis_name`` axis:
    shard k's stages are solved on that axis's device k.  The results of
    ``solve_lqr_scan``, for any leading batch, on the QP's device.  The
    horizon N must be divisible by the number of shards."""
    N = qp.Az.shape[-3]
    devs = axis_devices(mesh, axis_name)
    T = len(devs)
    assert N % T == 0, f"horizon N={N} not divisible by time shards T={T}"
    n = N // T
    home = qp.gf.device
    ql = stage_leading(qp)
    shards = [StageQP(*[a[k * n:(k + 1) * n].to(dev) if i < _PER_STAGE
                        else a.to(dev) for i, a in enumerate(ql)])
              for k, dev in enumerate(devs)]

    # Local suffix scans: suffix[k] = e_k ⋆ ... ⋆ e_{n-1} within a shard.
    els = [eliminate(q) for q in shards]
    suffixes = [inclusive_scan(combine, el.elems, reverse=True)
                for el in els]
    aggs = [_at(s, 0) for s in suffixes]                 # whole-shard products

    fwd, aggs_f, cost = [], [], []
    for k, (q, el, suffix) in enumerate(zip(shards, els, suffixes)):
        # R_k = agg_{k+1} ⋆ ... ⋆ agg_{T-1} ⋆ terminal, folded on device k.
        stack = _exchange(aggs, devs[k])
        zero = torch.zeros_like(q.Hf)
        R = _Element(A=zero, B=zero, C=q.Hf, D=zero,
                     e=torch.zeros_like(q.gf), f=q.gf)
        for j in range(T - 1, k, -1):
            R = combine(_at(stack, j), R)
        # The full suffix of each local stage; S_{k+1}, s_{k+1} per stage
        # (the last one is R's own).
        full = combine(suffix, R)
        S_next = torch.cat([full.C[1:], R.C[None]])
        s_next = torch.cat([full.f[1:], R.f[None]])
        m = inclusive_scan(affine_combine, Affine(*forward_maps(el, S_next,
                                                                s_next)))
        fwd.append(m)
        aggs_f.append(_at(m, n - 1))
        cost.append((S_next, s_next))

    dz_next, du, lam_next = [], [], []
    for k, (el, m, (S_next, s_next)) in enumerate(zip(els, fwd, cost)):
        # dz at shard k's first stage: shards 0..k-1 applied to dz_0 = 0.
        stack = _exchange(aggs_f, devs[k])
        start = Affine(torch.eye(m.F.shape[-1], dtype=m.F.dtype,
                                 device=devs[k]), torch.zeros_like(m.g[0]))
        for j in range(k):
            start = affine_combine(start, _at(stack, j))
        z_next = _mv(m.F, start.g) + m.g                  # dz_{k+1}
        z_here = torch.cat([start.g[None], z_next[:-1]])  # dz_k
        l_next = _mv(S_next, z_next) + s_next
        dz_next.append(z_next.to(home))
        du.append(recover_du(el, z_here, l_next).to(home))
        lam_next.append(l_next.to(home))

    dz_next, du, lam_next = (torch.cat(t) for t in (dz_next, du, lam_next))
    zero = torch.zeros_like(dz_next[:1])
    dz = torch.cat([zero, dz_next])
    lam = torch.cat([zero, lam_next])      # lam_0 = 0: node 0 is pinned
    return LQRSolution(dz=dz.movedim(0, -2), du=du.movedim(0, -2),
                       lam=lam.movedim(0, -2))


def enable_time_shard_backend(mesh: Mesh, axis_name: str = "time",
                              name: str = "time_shard") -> str:
    """Register a ``solve_lqr`` backend that closes over ``mesh``, so
    ``SolverOptions(kkt_backend=name)`` sends every KKT solve of ``solve``,
    ``solve_batch``, ``solve_fixed`` and ``solve_batch_lanes`` through
    ``solve_lqr_time_sharded``.  Returns ``name``."""
    register_backend(
        name, lambda qp: solve_lqr_time_sharded(qp, mesh, axis_name))
    return name
