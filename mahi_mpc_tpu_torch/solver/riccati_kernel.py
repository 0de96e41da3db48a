"""The Riccati KKT kernel of the lanes SQP (counterpart of
``mahi_mpc_tpu/solver/pallas_riccati.py``).

It solves a batch of ``StageQP``s, a group of threads an instance: the
backward Riccati sweep with an unrolled Cholesky of Quu, then the forward
rollout from dz_0 = 0 — what the Pallas kernel ``_riccati_kernel`` computes
for 128 lanes a grid step.  The continuity multipliers come from the
``_multipliers`` recursion outside the kernel, as in the JAX package.

Three builds of the same function live here:

- the CUDA kernel ``csrc/riccati.cu`` (group body ``csrc/riccati.cuh``),
  built with nvcc at first use (``_build.py``) and launched for CUDA
  tensors; float32, for the stage shapes ``KERNEL_SHAPES``;
- ``_solve_lqr_kernel_plain``, the plain PyTorch version (batch-leading),
  used for CPU tensors — the port's analogue of Pallas interpret mode —
  and as the kernel's reference on the card;
- ``solve_lqr_kernel_cpu_build``, the group body built by g++, for the
  tests only.

The kernel reads the QP batch-leading, as ``build_stage_qp`` returns it,
and writes dz and du batch-leading.  The lanes-layout entry
(``solve_lqr_kernel_lanes``, the counterpart of ``solve_lqr_pallas_lanes``)
permutes its inputs to batch-leading and its outputs back around the same
launch.  There is no fallback from one build to another: on a CUDA tensor
the wrapper launches the kernel or raises.  The kernel keeps the QP in
global memory, so unlike the Pallas kernel it has no VMEM horizon guard.
The JAX option value ``kkt_backend="pallas"`` names this kernel, so one
``SolverOptions`` means the same in both packages.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from ..ops.precision import strict_fp32
from .riccati import LQRSolution, _multipliers, _riccati_sweep
from .stage_qp import StageQP

Tensor = torch.Tensor

# (nz, nu) stage shapes the kernel library is built for (MPC_RICCATI_SHAPES
# in csrc/riccati.cuh): mahi_arm; two_link_arm, double_pendulum; cartpole,
# acrobot; pendulum.
KERNEL_SHAPES = ((12, 4), (6, 2), (5, 1), (3, 1))


def kkt_kernel_supported(nz: int, nu: int) -> bool:
    """Whether the kernel library is built for stage shape (nz, nu)."""
    return (int(nz), int(nu)) in KERNEL_SHAPES


def _chol_div(Q: Tensor) -> Tensor:
    """Lower Cholesky factor of Q (..., n, n) in the order of the Pallas
    kernel's ``_chol_lanes``: off-diagonal entries divide by the pivot
    (``chol_small`` multiplies by its reciprocal); a pivot that is not
    positive gives NaN."""
    n = Q.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = Q[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(Q[..., 0, 0])
    return torch.stack([torch.stack(
        [L[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)], dim=-2)


@strict_fp32()
def _solve_lqr_kernel_plain(qp: StageQP) -> LQRSolution:
    """The kernel's function in plain PyTorch, batch-leading (B, ...)."""
    return _riccati_sweep(qp, _chol_div)


def _check_batch(qp: StageQP) -> Tuple[int, int, int, int]:
    """(B, N, nz, nu) of a batch-leading QP; raises on a malformed one."""
    B, N, nz, nu = (qp.Az.shape[0], qp.Az.shape[1], qp.Az.shape[2],
                    qp.Bz.shape[-1])
    want = [(B, N, nz, nz), (B, N, nz, nu), (B, N, nz), (B, N, nz, nz),
            (B, N, nz, nu), (B, N, nu, nu), (B, N, nz), (B, N, nu),
            (B, nz, nz), (B, nz)]
    dev, dtype = qp.Az.device, qp.Az.dtype
    for name, a, shape in zip(StageQP._fields, qp, want):
        if tuple(a.shape) != shape or a.device != dev or a.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype} on {dev}, "
                             f"got {tuple(a.shape)} {a.dtype} on {a.device}")
    return B, N, nz, nu


def _aligned(a: Tensor) -> Tensor:
    """``a`` contiguous and 16-byte aligned: the kernel copies each stage
    block in 16-byte pieces where its size allows."""
    a = a.contiguous()
    return a.clone() if a.data_ptr() % 16 else a


def _run_library(fn, stream, qp: StageQP) -> Tuple[Tensor, Tensor]:
    """Call a build of the kernel body (``fn``: the CUDA launcher when
    ``stream`` is given, else the CPU test build) on a batch-leading QP;
    returns (dz, du), batch-leading."""
    B, N, nz, nu = _check_batch(qp)
    ins = [_aligned(a) for a in qp]
    new = lambda *shape: torch.empty((B,) + shape, dtype=ins[0].dtype,
                                     device=ins[0].device)
    outs = [new(N + 1, nz), new(N, nu)]
    scratch = [new(N, nu, nz),      # feedback gains K
               new(N, nu)]          # feedforwards kff
    bufs = ins + outs + scratch
    ptrs = (ctypes.c_void_p * len(bufs))(*[t.data_ptr() for t in bufs])
    args = [B, N, nz, nu, ptrs]
    if stream is not None:
        args.append(stream)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"Riccati kernel failed (error code {rc}) at "
                           f"B={B}, N={N}, nz={nz}, nu={nu}")
    return outs[0], outs[1]


def _launch_cuda(qp: StageQP) -> Tuple[Tensor, Tensor]:
    """Launch the CUDA kernel on the current stream of the QP's device;
    (dz, du) batch-leading."""
    nz, nu = qp.Az.shape[-1], qp.Bz.shape[-1]
    if qp.Az.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel is float32 only, got {qp.Az.dtype}")
    if not kkt_kernel_supported(nz, nu):
        raise ValueError(f"the Riccati kernel is not built for (nz, nu) = "
                         f"({nz}, {nu}); built: {KERNEL_SHAPES}")
    from .._build import cuda_build
    fn = cuda_build("riccati")[0].mpc_riccati_launch_f32
    dev = qp.Az.device
    with torch.cuda.device(dev):
        out = _run_library(fn, torch.cuda.current_stream(dev).cuda_stream,
                           qp)
    solve_lqr_kernel_batch.launches += 1
    return out


def _to_lanes(a: Tensor) -> Tensor:
    """(B, ...) -> (..., B), contiguous: the batch innermost."""
    return a.movedim(0, -1).contiguous()


def _from_lanes(a: Tensor) -> Tensor:
    return a.movedim(-1, 0).contiguous()


def _lanes_entry(solve: Callable, ins: tuple) -> Tuple[Tensor, Tensor]:
    """Run ``solve`` (batch-leading QP -> (dz, du)) on a lanes-layout QP:
    the fields permuted to batch-leading, the solution back to lanes.
    Raises on a malformed QP."""
    if len(ins) != len(StageQP._fields):
        raise ValueError(f"expected the {len(StageQP._fields)} StageQP "
                         f"fields, got {len(ins)}")
    qp = StageQP(*[_from_lanes(a) for a in ins])
    _check_batch(qp)
    dz, du = solve(qp)
    return _to_lanes(dz), _to_lanes(du)


def solve_lqr_kernel_lanes(ins: tuple) -> Tuple[Tensor, Tensor]:
    """Lanes-layout entry: ``ins`` is the 10-tuple ``(Az, Bz, r, Hzz, Hzu,
    Huu, gz, gu, Hf, gf)`` with the batch trailing on every array (Az
    ``(N, nz, nz, B)``, ...), any B.  Returns ``(dz, du)`` in lanes layout.
    CUDA tensors launch the kernel (with the permutes around it); CPU
    tensors run the plain version."""
    kind = ins[0].device.type
    if kind == "cuda":
        return _lanes_entry(_launch_cuda, ins)
    if kind != "cpu":
        raise ValueError(f"no Riccati kernel for device type {kind!r}")
    return _lanes_entry(lambda qp: _solve_lqr_kernel_plain(qp)[:2], ins)


def solve_lqr_kernel_batch(qp: StageQP) -> LQRSolution:
    """Solve a batch of StageQPs (every field with a leading batch B) by the
    kernel, which reads the QP where it lies; ``lam`` comes from
    ``_multipliers``.  CUDA tensors launch the kernel (float32) and count
    the launch in ``solve_lqr_kernel_batch.launches``; CPU tensors run the
    plain version.  Any other device raises."""
    kind = qp.gf.device.type
    if kind == "cpu":
        return _solve_lqr_kernel_plain(qp)
    if kind != "cuda":
        raise ValueError(f"no Riccati kernel for device type {kind!r}")
    dz, du = _launch_cuda(qp)
    with strict_fp32():
        lam = _multipliers(qp, dz, du)
    return LQRSolution(dz=dz, du=du, lam=lam)


solve_lqr_kernel_batch.launches = 0


def _run_cpu_build(qp: StageQP) -> Tuple[Tensor, Tensor]:
    """(dz, du) of the g++ build of the group body, batch-leading."""
    from .._build import cpu_library
    lib = cpu_library("riccati")
    fn = (lib.mpc_riccati_cpu_f32 if qp.gf.dtype == torch.float32
          else lib.mpc_riccati_cpu_f64)
    return _run_library(fn, None, qp)


def solve_lqr_kernel_cpu_build(qp: StageQP) -> LQRSolution:
    """The group body built for the CPU by g++ (float32 or float64 CPU
    tensors, batch-leading): how the tests run the kernel's own arithmetic
    without a card."""
    dz, du = _run_cpu_build(qp)
    with strict_fp32():
        lam = _multipliers(qp, dz, du)
    return LQRSolution(dz=dz, du=du, lam=lam)
