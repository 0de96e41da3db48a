"""mahi_mpc_tpu_torch — the batched MPC engine of ``mahi_mpc_tpu`` in
PyTorch, with its kernels written in CUDA C++ for NVIDIA Hopper.

The module paths mirror the JAX package's, so each piece sits where its
counterpart does: ``models`` (serial arms, pendulum, cart-pole, double
pendulum, acrobot), ``ops`` (small SPD solves, the strict-fp32 scope),
``transcribe`` (multiple shooting), ``solver`` (the fused SQP and the lanes
SQP with its Riccati KKT solve: CUDA kernels + plain PyTorch versions),
``runtime`` (the batched receding-horizon service).  ``csrc/`` holds the
kernel sources, built with nvcc at first use (``_build.py``).  This package
imports neither JAX nor ``mahi_mpc_tpu``.
"""

from .params import ModelParameters, SolverOptions, TrajectoryParameters
from . import models

__version__ = "0.1.0"

__all__ = [
    "ModelParameters",
    "SolverOptions",
    "TrajectoryParameters",
    "models",
]
