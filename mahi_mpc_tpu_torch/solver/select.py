"""Warm-solver resolution (port of ``mahi_mpc_tpu/solver/select.py``):
which program serves (warm) re-solves.

``SolverOptions.warm_solver`` values:

- ``"auto"``  — the fused kernel on a CUDA device when the problem is
  supported (``fused_supported``), else the JAX package's rule for other
  backends: ``"fixed"`` when ``fixed_warm_iters > 0``, else ``"adaptive"``;
- ``"fused"`` — the fused solve on any device (its plain PyTorch version on
  the CPU, as the JAX package runs Pallas interpret mode there), with the
  same fallback when the problem is not supported;
- ``"fixed"`` / ``"adaptive"`` — the lanes SQP (``solver/batched.py``
  ``solve_batch_lanes``), with its Riccati kernel on a CUDA device.  As in
  the JAX package's batch service, both run the lanes solve to tolerance;
  ``fixed_warm_iters`` has no effect on that route.
"""

from __future__ import annotations

import torch

from ..params import SolverOptions
from ..transcribe.shooting import ShootingProblem
from .fused import fused_supported

VALID = ("auto", "fused", "fixed", "adaptive")


def resolve_warm_solver(opts: SolverOptions, prob: ShootingProblem,
                        device="cpu") -> str:
    """Resolve ``opts.warm_solver`` to one of "fused"/"fixed"/"adaptive"."""
    w = opts.warm_solver
    if w not in VALID:
        raise ValueError(
            f"unknown warm_solver {w!r}; choose one of {VALID}")
    fallback = "fixed" if opts.fixed_warm_iters > 0 else "adaptive"
    if w == "auto":
        on_cuda = torch.device(device).type == "cuda"
        return "fused" if (on_cuda and fused_supported(prob)) else fallback
    if w == "fused":
        return "fused" if fused_supported(prob) else fallback
    return w
