"""The fused route's preparation kernel (``csrc/fused_prepare.cuh``) as
g++ builds it (``mpc_fused_prepare_cpu_*``: the card's blocks one after
another, each phase's threads in order or last to first), against the
PyTorch preparation it replaces on the card, bit for bit: ``sqp._start``
(row 0 of X pinned to x0, ``_strict_interior`` of the rest of X and of U,
``lc.mu_start``) and each input's ``movedim(0, -1).contiguous()``.

Float32 and float64, at (nx, nu, N) = (8, 4, 25), (4, 1, 3) and (12, 6,
7), B = 37 (its last tile short of a tile's instances: word by word) and
64 (whole tiles: 16-byte loads and stores).  Each batch mixes, by column,
finite, one-sided, infinite and narrow (width < 4 delta) boxes, and holds
unbounded instances (mu = mu_min); the warm start holds NaN and +-inf;
mu0, the floor and mu_min are values float32 cannot represent.
Also: the card route's workspace (``fused._workspace``) and the record
the kernel refuses."""

import ctypes
import types

import pytest
import torch

from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
from mahi_mpc_tpu_torch._build import cpu_library
from mahi_mpc_tpu_torch.models import make_dynamics
from mahi_mpc_tpu_torch.solver import fused
from mahi_mpc_tpu_torch.solver import loop_common as lc
from mahi_mpc_tpu_torch.solver.sqp import INTERIOR_DELTA, _start
from mahi_mpc_tpu_torch.transcribe.shooting import (LinPoint, MPCParams,
                                                    make_problem)

SHAPES = [(8, 4, 25), (4, 1, 3), (12, 6, 7)]
# tol 3e-4: the floor max(mu_min, 0.1 tol) = 3e-5, and mu_min 1e-9, and
# mu0 0.1: none is a float32
OPTS = SolverOptions(tol=3e-4)
CASES = {"above_floor": 0.1, "below_floor": 1e-9, "per_instance": None,
         "cold": 0.1}


def _boxes(g, B, n, dtype):
    """(lo, hi) (B, n): each column of each instance a finite, lower-only,
    upper-only, infinite or narrow (width 2e-3 < 4 delta) box; every
    fourth instance unbounded."""
    inf = float("inf")
    centre = torch.randn(B, n, generator=g, dtype=torch.float64)
    half = 0.3 + torch.rand(B, n, generator=g, dtype=torch.float64)
    kind = torch.randint(0, 5, (B, n), generator=g)
    kind[3::4] = 3
    lo = torch.where(kind == 4, centre - 1e-3, centre - half)
    hi = torch.where(kind == 4, centre + 1e-3, centre + half)
    lo = torch.where((kind == 2) | (kind == 3), -inf, lo)
    hi = torch.where((kind == 1) | (kind == 3), inf, hi)
    return lo.to(dtype), hi.to(dtype)


def _spikes(g, t):
    """``t`` with about 4 % of its entries NaN, +inf or -inf."""
    pick = torch.rand(t.shape, generator=g)
    t = torch.where(pick < 0.02, float("nan"), t)
    t = torch.where((pick >= 0.02) & (pick < 0.03), float("inf"), t)
    return torch.where((pick >= 0.03) & (pick < 0.04), -float("inf"), t)


def _inputs(B, nx, nu, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (torch.randn(*s, generator=g, dtype=torch.float64)
                    .to(dtype))
    x_min, x_max = _boxes(g, B, nx, dtype)
    u_min, u_max = _boxes(g, B, nu, dtype)
    p = MPCParams(x_des=r(B, N, nx), q=r(B, nx).abs(), r=r(B, nu).abs(),
                  rm=r(B, nu).abs(), u_prev=r(B, nu), x0=r(B, nx),
                  u_min=u_min, u_max=u_max, x_min=x_min, x_max=x_max,
                  lin=LinPoint(None, None, None, None, None),
                  qf=r(B, nx).abs(), xf_des=r(B, nx))
    X0 = _spikes(g, 3.0 * r(B, N + 1, nx))
    U0 = _spikes(g, 3.0 * r(B, N, nu))
    return p, X0, U0


def _same_bits(a, b):
    """Equal bit for bit, any NaN matching any NaN (PyTorch's own kernels
    give NaNs of either sign)."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a[~nan].view(ints), b[~nan].view(ints))


def _prepare_gxx(nx, nu, N, p, X0, U0, mu0, reverse):
    """The g++ build's preparation: FusedArgs' 14 inputs, batch-innermost."""
    B, dtype = p.x0.shape[0], p.x0.dtype
    bits = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(cpu_library("fused_sqp"), f"mpc_fused_prepare_cpu_{bits}")
    shapes = [(N + 1, nx), (N, nu), (N, nx), (nx,), (nu,), (nu,), (nu,),
              (nu,), (nu,), (nx,), (nx,), (nx,), (nx,), ()]
    outs = [torch.full(s + (B,), 777.0, dtype=dtype) for s in shapes]
    mu_each = mu0 if torch.is_tensor(mu0) else None
    srcs = [X0, U0, p.x_des, p.q, p.r, p.rm, p.u_prev, p.u_min, p.u_max,
            p.x_min, p.x_max, p.qf, p.xf_des, mu_each, p.x0]
    ins = (ctypes.c_void_p * 15)(*[None if t is None else t.data_ptr()
                                   for t in srcs])
    out_p = (ctypes.c_void_p * 14)(*[t.data_ptr() for t in outs])
    scal = (ctypes.c_double * 4)(0.0 if mu_each is not None else mu0,
                                 lc.mu_floor(OPTS), OPTS.mu_min,
                                 INTERIOR_DELTA)
    assert fn(B, N, nx, nu, ins, out_p, scal, int(reverse)) == 0
    return outs


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("B", [37, 64])
@pytest.mark.parametrize("nx, nu, N", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_prepare_kernel_is_the_pytorch_preparation(dtype, nx, nu, N, B,
                                                   case, reverse):
    p, X0, U0 = _inputs(B, nx, nu, N, dtype, seed=nx * 100 + N)
    mu0 = CASES[case]
    if case == "per_instance":
        g = torch.Generator().manual_seed(7)
        mu0 = torch.exp(-20.0 * torch.rand(B, generator=g,
                                           dtype=torch.float64)).to(dtype)
        mu0[5] = float("nan")
    if case == "cold":
        X0 = U0 = None
    prob = types.SimpleNamespace(nx=nx, nu=nu, N=N)
    Xr, Ur, mur = _start(prob, p, X0, U0, OPTS, mu0)
    want = [t.movedim(0, -1).contiguous() for t in (
        Xr, Ur, p.x_des, p.q, p.r, p.rm, p.u_prev, p.u_min, p.u_max,
        p.x_min, p.x_max, p.qf, p.xf_des, mur)]
    got = _prepare_gxx(nx, nu, N, p, X0, U0, mu0, reverse)
    names = ("X0 U0 xdes q r rm uprev umin umax xmin xmax qf xfdes "
             "mu0").split()
    for name, a, b in zip(names, got, want):
        assert _same_bits(a, b), name
    # the batch holds every kind of box, and the clip moved the warm start
    unbounded = ~(torch.isfinite(p.x_min).any(1) | torch.isfinite(p.x_max)
                  .any(1) | torch.isfinite(p.u_min).any(1)
                  | torch.isfinite(p.u_max).any(1))
    assert unbounded.any() and (~unbounded).any()
    assert torch.equal(got[13][unbounded],
                       torch.full_like(got[13][unbounded], OPTS.mu_min))
    if X0 is not None:
        assert torch.isnan(got[0]).any() and torch.isinf(got[0]).any()
        assert not torch.equal(got[1].nan_to_num(),
                               U0.movedim(0, -1).nan_to_num())


def test_prepare_kernel_refuses_a_record_beyond_a_block():
    """One instance's record at N = 2000, (nx, nu) = (12, 6) in float32
    (240 KB) does not fit in a block's shared memory: -6, nothing
    written."""
    fn = cpu_library("fused_sqp").mpc_fused_prepare_cpu_f32
    nothing = (ctypes.c_void_p * 15)()
    scal = (ctypes.c_double * 4)(0.1, 1e-5, 1e-9, INTERIOR_DELTA)
    assert fn(1, 2000, 12, 6, nothing, nothing, scal, 0) == -6


@pytest.mark.parametrize("is_linear", [False, True], ids=["fast", "ltv"])
def test_workspace_views_are_aligned_and_disjoint(is_linear):
    """The card route's one allocation: every array of the kernel at a
    128-byte boundary, at the shape ``FusedArgs`` reads, no two
    overlapping."""
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters("ws", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=5, dynamics_name="mahi_arm",
                         is_linear=is_linear)
    prob = make_problem(mp, dyn)
    ws = fused._workspace(prob, 33, torch.float32, torch.device("cpu"))
    views = ws.ins + ws.outs + ws.scratch
    assert len(ws.ins) == 14 and len(ws.outs) == 3 and len(ws.scratch) == 7
    assert ws.ins[0].shape == (6, 8, 33) and ws.ins[13].shape == (33,)
    assert ws.outs[2].shape == (8, 33)
    assert ws.scratch[5].shape == ((1, 33) if is_linear else (5, 4, 12, 33))
    base = ws.ins[0].data_ptr()
    spans = sorted((t.data_ptr() - base, t.data_ptr() - base + 4 * t.numel())
                   for t in views)
    assert spans[0][0] == 0 and all(a % 128 == 0 for a, _ in spans)
    assert all(b <= a for (_, b), (a, _) in zip(spans, spans[1:]))
    assert all(t.is_contiguous() for t in views)
