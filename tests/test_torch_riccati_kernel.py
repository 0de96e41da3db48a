"""The Riccati KKT kernel on the CPU: its plain PyTorch version against the
JAX package's Pallas kernel in interpret mode, and the kernel's group body
(``csrc/riccati.cuh``, the code nvcc compiles for the card; g++ runs a
group's lanes one after another, phase by phase) against the plain version
at every stage shape the library is built for."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu.solver.pallas_riccati import solve_lqr_pallas_batch
from mahi_mpc_tpu.solver.stage_qp import StageQP as JaxStageQP
from mahi_mpc_tpu_torch.solver.riccati_kernel import (
    KERNEL_SHAPES, _lanes_entry, _run_cpu_build, _solve_lqr_kernel_plain,
    _to_lanes, kkt_kernel_supported, solve_lqr_kernel_batch,
    solve_lqr_kernel_cpu_build, solve_lqr_kernel_lanes)
from mahi_mpc_tpu_torch.solver.stage_qp import StageQP

torch.set_num_threads(1)

# tests/test_pallas_riccati.py:52-57's bands (float32 kernel vs scan).
BANDS = dict(du=(2e-4, 2e-5), dz=(2e-4, 2e-5), lam=(2e-4, 2e-4))
NAN_I = 7


def random_qp_np(B, N, nz, nu, seed=0, indefinite=None):
    """tests/test_pallas_riccati.py:23-44's well-conditioned batch, float64
    numpy; ``indefinite``: an instance whose last-stage Huu is -50 I, so
    its Quu has a negative pivot."""
    rng = np.random.default_rng(seed)

    def spd(n):
        M = rng.standard_normal((B, N, n, n)) * 0.3
        return np.einsum("bnij,bnkj->bnik", M, M) + 2.0 * np.eye(n)

    Az = 0.3 * rng.standard_normal((B, N, nz, nz)) + np.eye(nz)
    Bz = 0.3 * rng.standard_normal((B, N, nz, nu))
    r = 0.1 * rng.standard_normal((B, N, nz))
    Hzz = spd(nz)
    Hzu = 0.1 * rng.standard_normal((B, N, nz, nu))
    Huu = spd(nu)
    gz = rng.standard_normal((B, N, nz))
    gu = rng.standard_normal((B, N, nu))
    HfM = rng.standard_normal((B, nz, nz)) * 0.3
    Hf = np.einsum("bij,bkj->bik", HfM, HfM) + 2.0 * np.eye(nz)
    gf = rng.standard_normal((B, nz))
    if indefinite is not None:
        Huu[indefinite, -1] = -50.0 * np.eye(nu)
    return (Az, Bz, r, Hzz, Hzu, Huu, gz, gu, Hf, gf)


def _torch_qp(a, dtype=torch.float32):
    return StageQP(*[torch.tensor(x, dtype=dtype) for x in a])


def _assert_bands(got, ref, mask=None):
    for name, (rtol, atol) in BANDS.items():
        g, r = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        if mask is not None:
            g, r = g[mask], r[mask]
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


def _finite(sol):
    return np.isfinite(np.asarray(sol.du)).all(axis=(1, 2))


@pytest.fixture(scope="module")
def jax_pair():
    """B=4 and B=130 (N=6, nz=5, nu=2) through the JAX Pallas kernel in
    interpret mode, float32."""
    out = {}
    for B in (4, 130):
        a = random_qp_np(B, 6, 5, 2, seed=1)
        jqp = JaxStageQP(*[jnp.asarray(x, jnp.float32) for x in a])
        out[B] = (a, solve_lqr_pallas_batch(jqp, interpret=True))
    return out


@pytest.mark.parametrize("B", [4, 130])
def test_plain_matches_jax_interpret(jax_pair, B):
    a, ref = jax_pair[B]
    got = _solve_lqr_kernel_plain(_torch_qp(a))
    assert got.dz.shape == (B, 7, 5) and got.du.shape == (B, 6, 2)
    _assert_bands(got, ref)


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_build_matches_plain(shape, dtype):
    """The g++-built kernel body against the plain version, B=130, N=25.

    dz and du, the kernel's outputs: float64 at 1e-10, float32 at the bands
    above.  lam is no kernel output (both sides compute it with the same
    ``_multipliers``), and at N=25 this QP family makes it ill-conditioned:
    the adjoint recursion runs through Az = I + 0.3 randn (spectral radius
    ~2 at nz=12), which amplifies the roundoff of dz by ~1e4 — the float32
    plain version itself lands 0.029 from its float64 answer at (12, 4),
    max|lam| 26.  So lam is held normwise, max|dlam| <= tol * max|lam| with
    tol 1e-10 (float64) or 1e-2 (float32); the elementwise 2e-4 band is
    held on the main path's QP (test below)."""
    nz, nu = shape
    qp = _torch_qp(random_qp_np(130, 25, nz, nu, seed=nz + nu), dtype)
    got, ref = solve_lqr_kernel_cpu_build(qp), _solve_lqr_kernel_plain(qp)
    f64 = dtype == torch.float64
    for name in ("dz", "du"):
        rtol, atol = (0, 1e-10) if f64 else BANDS[name]
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name).numpy(),
                                   rtol=rtol, atol=atol)
    lam_err = float((got.lam - ref.lam).abs().max())
    assert lam_err <= (1e-10 if f64 else 1e-2) * float(ref.lam.abs().max())


def test_cpu_build_matches_plain_on_stage_qp():
    """float32, on the QP the lanes solver builds for the 4-DOF arm (N=25,
    nz=12, nu=4) at a bench-shaped iterate: dz, du and lam all at the
    elementwise bands."""
    from mahi_mpc_tpu_torch import ModelParameters
    from mahi_mpc_tpu_torch.models import make_dynamics
    from mahi_mpc_tpu_torch.solver.batched import _linearize_lanes
    from mahi_mpc_tpu_torch.solver.stage_qp import build_stage_qp
    from mahi_mpc_tpu_torch.transcribe.shooting import (MPCParams,
                                                        default_params,
                                                        make_problem)
    B, N = 130, 25
    mp = ModelParameters("t", num_x=8, num_u=4, step_size=0.002,
                         num_shooting_nodes=N, u_min=[-20.0] * 4,
                         u_max=[20.0] * 4, dynamics_name="mahi_arm")
    prob = make_problem(mp, make_dynamics("mahi_arm"))
    rng = np.random.default_rng(6)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    p = default_params(mp, device="cpu")._replace(
        q=f32([10.0] * 4 + [1.0] * 4), r=f32([0.1] * 4), rm=f32([0.01] * 4))
    p = MPCParams(*[type(f)(*[a.expand((B,) + a.shape) for a in f])
                    if isinstance(f, tuple) else f.expand((B,) + f.shape)
                    for f in p])
    X = f32(0.2 * rng.standard_normal((B, N + 1, 8)))
    U = f32(2.0 * rng.standard_normal((B, N, 4)))
    p = p._replace(x0=X[:, 0], x_des=f32(0.2 * rng.standard_normal((B, N, 8))))
    qp = build_stage_qp(prob, X, U, p, torch.full((B,), 0.1),
                        torch.full((B,), 1e-8),
                        lin=_linearize_lanes(prob, X, U))
    _assert_bands(solve_lqr_kernel_cpu_build(qp), _solve_lqr_kernel_plain(qp))


def test_indefinite_huu_nan_in_that_instance_only():
    """An indefinite Huu: NaN in the same instance from the JAX kernel
    (interpret mode), the plain version and the g++-built body, finite
    everywhere else, where the three agree at the bands."""
    a = random_qp_np(130, 6, 6, 2, seed=5, indefinite=NAN_I)
    jqp = JaxStageQP(*[jnp.asarray(x, jnp.float32) for x in a])
    qp = _torch_qp(a)
    sols = {"jax": solve_lqr_pallas_batch(jqp, interpret=True),
            "plain": _solve_lqr_kernel_plain(qp),
            "cpu_build": solve_lqr_kernel_cpu_build(qp)}
    want = np.ones(130, bool)
    want[NAN_I] = False
    for name, sol in sols.items():
        np.testing.assert_array_equal(_finite(sol), want, err_msg=name)
    _assert_bands(sols["plain"], sols["jax"], mask=want)
    _assert_bands(sols["cpu_build"], sols["plain"], mask=want)


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_indefinite_huu_nan_isolated_in_its_block(shape):
    """float32, B=40, N=8: instance 9 has an indefinite Huu and shares its
    block of groups (128 threads: 8 instances at nz=12, 16 at nz=5 or 6, 32
    at nz=3) and, at nz=12, its warp with finite neighbours; the g++ build
    of the group body reuses one tile from instance to instance.  Only
    instance 9 is NaN, and every other instance matches the plain version
    at the bands."""
    nz, nu = shape
    nan_i = 9
    qp = _torch_qp(random_qp_np(40, 8, nz, nu, seed=nz, indefinite=nan_i))
    got, ref = solve_lqr_kernel_cpu_build(qp), _solve_lqr_kernel_plain(qp)
    want = np.ones(40, bool)
    want[nan_i] = False
    np.testing.assert_array_equal(_finite(got), want)
    np.testing.assert_array_equal(_finite(ref), want)
    assert not np.isfinite(got.dz.numpy()[nan_i]).all()
    _assert_bands(got, ref, mask=want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_build_batch_and_lanes_entries_agree(dtype):
    """The g++ build through the batch-leading entry and through the
    lanes-layout entry's permutes (the code the CUDA lanes entry runs
    around its launch): the same dz and du, bit for bit."""
    qp = _torch_qp(random_qp_np(37, 25, 12, 4, seed=2), dtype)
    sol = solve_lqr_kernel_cpu_build(qp)
    dz, du = _lanes_entry(_run_cpu_build, tuple(_to_lanes(x) for x in qp))
    assert dz.shape == (26, 12, 37) and du.shape == (25, 4, 37)
    np.testing.assert_array_equal(dz.movedim(-1, 0).numpy(), sol.dz.numpy())
    np.testing.assert_array_equal(du.movedim(-1, 0).numpy(), sol.du.numpy())


def test_wrappers_on_cpu_run_the_plain_version():
    """On CPU tensors both entries run the plain version and launch
    nothing; the lanes entry takes and returns the batch trailing."""
    qp = _torch_qp(random_qp_np(9, 5, 6, 2, seed=3))
    before = solve_lqr_kernel_batch.launches
    ref = _solve_lqr_kernel_plain(qp)
    got = solve_lqr_kernel_batch(qp)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    dz, du = solve_lqr_kernel_lanes(tuple(_to_lanes(x) for x in qp))
    assert dz.shape == (6, 6, 9) and du.shape == (5, 2, 9)
    np.testing.assert_array_equal(dz.movedim(-1, 0).numpy(), ref.dz.numpy())
    assert solve_lqr_kernel_batch.launches == before


def test_unsupported_inputs_raise():
    """No silent fallback: another device, a shape the library is not built
    for, or a malformed lanes tuple raise."""
    assert kkt_kernel_supported(12, 4) and not kkt_kernel_supported(5, 2)
    qp = _torch_qp(random_qp_np(3, 4, 5, 2))
    with pytest.raises(ValueError):
        solve_lqr_kernel_batch(StageQP(*[x.to("meta") for x in qp]))
    with pytest.raises(RuntimeError):
        solve_lqr_kernel_cpu_build(qp)            # (5, 2) is not built
    lanes = [_to_lanes(x) for x in qp]
    lanes[3] = lanes[3][..., :2]
    with pytest.raises(ValueError):
        solve_lqr_kernel_lanes(tuple(lanes))
