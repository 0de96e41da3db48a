"""Strict float32 scope for the solvers (counterpart of
``mahi_mpc_tpu/ops/precision.py``).

The JAX package traces its solver programs under
``jax.default_matmul_precision("highest")`` because the TPU's matrix unit
otherwise rounds inputs to bfloat16.  The card's analogue is TF32: a
float32 matmul or convolution allowed to use it keeps about three decimal
digits, too few for Newton and Riccati directions.  ``strict_fp32()`` turns
TF32 off for matmuls and cuDNN inside the block and restores the caller's
settings after it, so the process-wide policy of user code is untouched.
It is a context manager and, like every ``contextlib.contextmanager``, a
decorator as well.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_fp32():
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    prev_mm = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_mm)
        torch.backends.cudnn.allow_tf32 = prev_cudnn
