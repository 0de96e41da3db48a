"""The LTV path's two per-solve functions, each a kernel on the card.

LTV mode (``params.is_linear``, reference C8) freezes each instance's model
at its measured state and solves the exact affine step of that frozen
model.  The JAX package compiles both functions: the service's
``jax.jit(jax.vmap(dynamics.linearize))``
(``mahi_mpc_tpu/runtime/batch_service.py:117-123``) and ``_ltv_discrete``
inside the jitted fused wrapper (``mahi_mpc_tpu/solver/fused.py:950-953``).
Here each has a hand-written CUDA kernel (``csrc/model_linearize.cuh``,
float32 or float64: a block a tile of instances, a thread a column task of
one instance, the tile staged through shared memory) and its plain PyTorch
version:

- ``linearize_batch(dyn, x0, u0)``: (A, B, x_dot0) = (df/dx, df/du, f) at B
  points, batch-leading as ``LinPoint`` keeps them.  Its kernel lives with
  the model: the serial arms in ``fused_sqp.cu`` (the folded columns of
  ``arm_dynamics.cuh``), the closed forms in ``fused_sqp_models.cu``, a
  user's model in the generated build of its LTV unit
  (``target.model_kernel``).  Plain version ``linearize_batch_plain``: the
  vmapped ``Dynamics.linearize``;
- ``ltv_discrete(prob, p)``: the streamed increment form (Ad - I, Bd, cd)
  of the exact discrete step under ``prob.integrator``, (B, nx, nx),
  (B, nx, nu), (B, nx).  On the card the kernel writes them
  batch-innermost, the layout the fused solve streams, and they are
  returned as batch-leading views of that storage, so the solve copies
  nothing.  Its kernel lives with the ``Ltv`` policy: ``fused_sqp_ltv.cu``
  for ``target.LTV_SHAPES``, the problem's generated LTV unit for any other
  shape (``target.kernel_target``).  Plain version
  ``ltv_discrete_plain``: ``batched._ltv_discrete`` and ``Ad - I``.

The route is decided from the model before anything is built or launched
(``target.model_kernel``): a model with a CUDA form, hand-written or
generated (``fused.fused_supported``'s rule: lanes-polymorphic and lowered
by ``models/codegen.py``), takes the kernel on the card; any other model
(non-lanes dynamics, an ``f`` the generator cannot lower) takes the eager
route, the plain version, counted in ``linearize_batch.eager_calls``.
On CPU tensors each function runs its plain version; on CUDA tensors a
build or launch that fails raises.  Launches are counted in
``linearize_batch.launches`` and ``ltv_discrete.launches``, calls of the
plain versions in ``linearize_batch_plain.calls`` and
``ltv_discrete_plain.calls``.  ``*_cpu_kernel`` run the kernels' own
blocks built by g++ (the tests); ``count_*_ops`` count their operations on
a counting scalar (``csrc/flop_count.cpp``); ``linearize_tile`` and
``ltv_discrete_tile`` report a kernel's tile and occupancy on the card.
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import vmap

from .. import _build
from ..ops.precision import strict_fp32
from ..transcribe.shooting import MPCParams, ShootingProblem
from .batched import _ltv_discrete, check_lin
from .target import (GENERATED_ID, INTEGRATORS, KernelTarget, ModelKernel,
                     kernel_target, model_kernel)

Tensor = torch.Tensor
_REALS = {torch.float32: ("f32", ctypes.c_float),
          torch.float64: ("f64", ctypes.c_double)}


def _model(dyn) -> ModelKernel:
    """``model_kernel(dyn)``; raises for a model on the eager route."""
    kernel = model_kernel(dyn)
    if kernel is None:
        raise ValueError(f"the build holds no linearization of "
                         f"{dyn.name!r} (model {GENERATED_ID})")
    return kernel


def _linearization_build(dyn, name: str):
    """The g++ build of the model's linearization: the hand-written build
    ``name`` (it holds every hand-written model) or the model's generated
    one."""
    library = _model(dyn).library
    return _build.cpu_library(library if library in _build.GENERATED
                              else name)


def _discrete_target(prob: ShootingProblem) -> KernelTarget:
    """The instantiation that holds ``prob``'s Ltv policy."""
    if prob.integrator not in INTEGRATORS:
        raise ValueError(f"no LTV discretization under "
                         f"{prob.integrator!r}")
    return kernel_target(prob)


def _real(t: Tensor):
    if t.dtype not in _REALS:
        raise TypeError(f"the LTV kernels take float32 or float64, got "
                        f"{t.dtype}")
    return _REALS[t.dtype]


def _on_stream(device, call):
    """call(stream) on the current stream of ``device`` under its device
    guard (the CPU: call(None))."""
    if device.type != "cuda":
        return call(None)
    with torch.cuda.device(device):
        return call(torch.cuda.current_stream(device).cuda_stream)


# ---- the linearization -------------------------------------------------------

def _linearize_args(dyn, x0: Tensor, u0: Tensor):
    nx, nu = dyn.nx, dyn.nu
    B = x0.shape[0]
    if tuple(x0.shape) != (B, nx) or tuple(u0.shape) != (B, nu):
        raise ValueError(f"{dyn.name!r}: x0 {tuple(x0.shape)}, u0 "
                         f"{tuple(u0.shape)}; expected ({B}, {nx}), "
                         f"({B}, {nu})")
    if u0.device != x0.device:
        raise ValueError(f"x0 on {x0.device}, u0 on {u0.device}")
    x0 = x0.contiguous()
    u0 = u0.to(x0.dtype).contiguous()
    new = lambda *s: torch.empty(s, dtype=x0.dtype, device=x0.device)
    return x0, u0, (new(B, nx, nx), new(B, nx, nu), new(B, nx))


def _linearize_call(fn, dyn, x0, u0, stream):
    """One call of a linearization build (``fn``: a CUDA launcher when
    ``stream`` is given, else the g++ build)."""
    x0, u0, out = _linearize_args(dyn, x0, u0)
    model, consts, _ = _model(dyn)
    args = [x0.shape[0], model, dyn.nx, dyn.nu,
            (ctypes.c_double * len(consts))(*consts),
            x0.data_ptr(), u0.data_ptr(), *[t.data_ptr() for t in out]]
    rc = fn(*args) if stream is None else fn(*args, stream)
    if rc == -1:
        raise ValueError(f"the build holds no linearization of "
                         f"{dyn.name!r} (model {model})")
    if rc == -5:
        raise ValueError(f"{dyn.name!r}: the kernel's model is not "
                         f"(nx, nu) = ({dyn.nx}, {dyn.nu})")
    if rc != 0:
        raise RuntimeError(f"linearization kernel failed (error code {rc})")
    return out


def linearize_batch(dyn, x0: Tensor, u0: Tensor):
    """(A, B, x_dot0) of ``dyn`` at B points: x0 (B, nx), u0 (B, nu) ->
    A (B, nx, nx), B (B, nx, nu), x_dot0 (B, nx), in x0's dtype.

    On CUDA tensors: the kernel (float32 or float64) on the current stream
    of their device, counted in ``linearize_batch.launches``, where
    ``target.model_kernel`` names it; the eager route runs the plain version
    (``linearize_batch.eager_calls``).  On CPU tensors: the plain
    version.  Any other device raises."""
    kind = x0.device.type
    if kind == "cpu":
        return linearize_batch_plain(dyn, x0, u0)
    if kind != "cuda":
        raise ValueError(f"no linearization for device type {kind!r}")
    kernel = model_kernel(dyn)
    if kernel is None:
        linearize_batch.eager_calls += 1
        return linearize_batch_plain(dyn, x0, u0)
    bits, _ = _real(x0)
    fn = getattr(_build.cuda_build(kernel.library)[0],
                 f"mpc_linearize_launch_{bits}")
    out = _on_stream(x0.device,
                     lambda s: _linearize_call(fn, dyn, x0, u0, s))
    linearize_batch.launches += 1
    return out


linearize_batch.launches = 0
linearize_batch.eager_calls = 0


@strict_fp32()
def linearize_batch_plain(dyn, x0: Tensor, u0: Tensor):
    """The plain version, on any device: the vmapped ``Dynamics.linearize``
    (``torch.func.jacfwd``), cast to x0's dtype (a model written on 0-d
    components gives float64 tangents)."""
    linearize_batch_plain.calls += 1
    return tuple(a.to(x0.dtype)
                 for a in vmap(dyn.linearize)(x0, u0.to(x0.dtype)))


linearize_batch_plain.calls = 0


def linearize_batch_cpu_kernel(dyn, x0: Tensor, u0: Tensor,
                               reverse: bool = False):
    """The kernel's blocks built by g++ (float32 or float64 CPU tensors, a
    model with a CUDA form), each phase's threads one after another (last
    to first with ``reverse``): how the tests run it without a card."""
    bits, _ = _real(x0)
    fn = getattr(_linearization_build(dyn, "fused_sqp"),
                 f"mpc_linearize_cpu_{bits}")
    return _linearize_call(lambda *a: fn(*a, int(reverse)), dyn, x0, u0,
                           None)


# ---- the discretization ------------------------------------------------------

def _discrete_call(fn, prob: ShootingProblem, p: MPCParams, stream):
    """One call of a discretization build: the batch-innermost outputs
    (nx, nx, B), (nx, nu, B), (nx, B) as batch-leading views."""
    lin = check_lin(prob, p)
    nx, nu, B = prob.nx, prob.nu, p.x0.shape[0]
    dtype, device = p.x0.dtype, p.x0.device
    _, real = _real(p.x0)
    ins = [t.to(dtype).contiguous() for t in lin]
    for k, t in zip(lin._fields, ins):
        if t.device != device:
            raise ValueError(f"lin.{k} on {t.device}, x0 on {device}")
    new = lambda *s: torch.empty(s + (B,), dtype=dtype, device=device)
    out = (new(nx, nx), new(nx, nu), new(nx))
    args = [B, nx, nu, INTEGRATORS.index(prob.integrator), real(prob.dt),
            *[t.data_ptr() for t in ins], *[t.data_ptr() for t in out]]
    rc = fn(*args) if stream is None else fn(*args, stream)
    if rc == -1:
        raise ValueError(f"the build holds no Ltv policy at (nx, nu) = "
                         f"({nx}, {nu})")
    if rc != 0:
        raise RuntimeError(f"LTV discretization kernel failed (error code "
                           f"{rc})")
    return tuple(t.movedim(-1, 0) for t in out)


def ltv_discrete(prob: ShootingProblem, p: MPCParams):
    """The exact discrete step of each instance's frozen linearization
    ``p.lin`` under ``prob.integrator``, in the increment form the fused
    solve streams: (Ad - I (B, nx, nx), Bd (B, nx, nu), cd (B, nx)).

    On CUDA tensors: the kernel (float32 or float64) on the current stream
    of their device, counted in ``ltv_discrete.launches``; its outputs are
    batch-leading views of batch-innermost storage.  On CPU tensors: the
    plain version.  Any other device raises."""
    kind = p.x0.device.type
    if kind == "cpu":
        return ltv_discrete_plain(prob, p)
    if kind != "cuda":
        raise ValueError(f"no LTV discretization for device type {kind!r}")
    bits, _ = _real(p.x0)
    fn = getattr(_build.cuda_build(_discrete_target(prob).cuda)[0],
                 f"mpc_ltv_discrete_launch_{bits}")
    out = _on_stream(p.x0.device,
                     lambda s: _discrete_call(fn, prob, p, s))
    ltv_discrete.launches += 1
    return out


ltv_discrete.launches = 0


def ltv_discrete_plain(prob: ShootingProblem, p: MPCParams):
    """The plain version, on any device: ``batched._ltv_discrete`` (a
    vmapped ``jacfwd`` of the step at z = 0) and Ad - I."""
    ltv_discrete_plain.calls += 1
    Ad, Bd, cd = _ltv_discrete(prob, p)
    return (Ad - torch.eye(prob.nx, dtype=Ad.dtype, device=Ad.device), Bd,
            cd)


ltv_discrete_plain.calls = 0


def ltv_discrete_cpu_kernel(prob: ShootingProblem, p: MPCParams,
                            reverse: bool = False):
    """The kernel's blocks built by g++ (float32 or float64 CPU tensors;
    ``reverse`` as ``linearize_batch_cpu_kernel``): the hand-written build
    for ``target.LTV_SHAPES``, the problem's generated one for any other
    shape."""
    bits, _ = _real(p.x0)
    fn = getattr(_build.cpu_library(_discrete_target(prob).generated
                                    or "fused_sqp"),
                 f"mpc_ltv_discrete_cpu_{bits}")
    return _discrete_call(lambda *a: fn(*a, int(reverse)), prob, p, None)


# ---- the kernels' tiles on the card ------------------------------------------

# ``mpc_ltv_path_blocks_per_sm``'s model for the discretization
# (csrc/fused_sqp_launch.cuh kLtvDiscreteQuery)
_DISCRETE_QUERY = -100


def _tile(library: str, model: int, nx: int, nu: int, dtype) -> dict:
    bits, _ = _REALS[dtype]
    out = (ctypes.c_int * 4)()
    n = getattr(_build.cuda_build(library)[0],
                f"mpc_ltv_path_blocks_per_sm_{bits}")(model, nx, nu, out)
    if n < 0:
        raise RuntimeError(f"no LTV kernel at ({nx}, {nu}) in {library} "
                           f"(code {n})")
    return dict(zip(("instances", "threads_per_instance", "threads",
                     "smem_bytes"), out), blocks_per_sm=n)


def linearize_tile(dyn, dtype=torch.float32) -> dict:
    """The linearization kernel of ``dyn`` in ``dtype`` (a model on the
    kernel route): instances a tile, threads an instance, threads and
    shared bytes a block, blocks an SM (needs the card)."""
    kernel = _model(dyn)
    return _tile(kernel.library, kernel.model, dyn.nx, dyn.nu, dtype)


def ltv_discrete_tile(prob: ShootingProblem, dtype=torch.float32) -> dict:
    """The discretization kernel of ``prob``'s shape in ``dtype``, as
    ``linearize_tile`` reports it."""
    return _tile(_discrete_target(prob).cuda, _DISCRETE_QUERY, prob.nx,
                 prob.nu, dtype)


# ---- operation counts (the kernels' roofline bounds) -------------------------

_KINDS = ("add", "mul", "div_sqrt", "transcendental")


def _host64(t: Tensor) -> Tensor:
    return t.detach().to("cpu", torch.float64).contiguous()


def _body_and_minimum(counts: Tensor) -> dict:
    """{"body": the tasks' own tally, "minimum": the function's operations,
    each counted once (the tally less what the tasks repeat)}, each as
    {"add", "mul", "div_sqrt", "transcendental"}."""
    return dict(body=dict(zip(_KINDS, counts[:4].tolist())),
                minimum=dict(zip(_KINDS, (counts[:4] - counts[4:]).tolist())))


def count_linearize_ops(dyn, x0: Tensor, u0: Tensor) -> dict:
    """The linearization kernel's floating-point operations at these points
    (its tasks run by g++ on a counting scalar, float64 copies), summed
    over them, as ``_body_and_minimum`` gives them: the minimum counts the
    value part once (a serial arm's q tasks each form it, and its qd tasks
    run the chain's values again; every other model's one-tangent passes
    each form f), and is the numerator of the kernel's roofline bound."""
    lib = _linearization_build(dyn, "flop_count")
    model, consts, _ = _model(dyn)
    x0, u0 = _host64(x0), _host64(u0)
    counts = torch.zeros(8, dtype=torch.float64)
    rc = lib.mpc_linearize_count_ops(x0.shape[0], model, dyn.nx, dyn.nu,
                                     (ctypes.c_double * len(consts))(*consts),
                                     x0.data_ptr(), u0.data_ptr(),
                                     counts.data_ptr())
    if rc != 0:
        raise ValueError(f"no linearization of {dyn.name!r} to count "
                         f"(code {rc})")
    return _body_and_minimum(counts)


def count_ltv_discrete_ops(prob: ShootingProblem, p: MPCParams) -> dict:
    """The discretization kernel's operations on these frozen points, as
    ``count_linearize_ops`` counts them (each pass forms the step's value:
    the minimum counts it once)."""
    lin = [_host64(t) for t in check_lin(prob, p)]
    counts = torch.zeros(8, dtype=torch.float64)
    rc = _build.cpu_library(_discrete_target(prob).generated
                            or "flop_count").mpc_ltv_discrete_count_ops(
        p.x0.shape[0], prob.nx, prob.nu, INTEGRATORS.index(prob.integrator),
        float(prob.dt), *[t.data_ptr() for t in lin], counts.data_ptr())
    if rc != 0:
        raise ValueError(f"no Ltv policy at ({prob.nx}, {prob.nu}) to "
                         f"count (code {rc})")
    return _body_and_minimum(counts)
