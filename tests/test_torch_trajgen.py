"""The port's trajectory-library generator against the JAX package's, on
tests/test_trajgen.py's fixture (pendulum, N=30, dt=0.05, |u| <= 10, RK4,
tol 1e-6, at most 80 SQP iterations).

- float64: the same segments as JAX ``TrajectoryGenerator`` from the same
  waypoints: equal statuses, augmented-Lagrangian rounds and SQP iterations
  a round, X and U within 1e-7 (the same algorithm in the same order;
  only roundoff differs);
- float32: the JAX test's own checks on the port (endpoint error < 1e-3,
  the RK4 step's residual along each segment < 1e-4, |u| within the
  bounds, min-effort beats naive);
- the CSV files: the same bytes from the same segments in both packages,
  and ``read_library_csv`` inverts ``write_library_csv``.
"""

import numpy as np
import pytest
import torch

from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu import TrajectoryParameters as JaxTrajectoryParameters
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.trajgen import TrajectoryGenerator as JaxGenerator
from mahi_mpc_tpu.trajgen import TrajectorySegment as JaxSegment
from mahi_mpc_tpu.trajgen import read_library_csv as jax_read_library_csv
from mahi_mpc_tpu.trajgen import write_library_csv as jax_write_library_csv
from mahi_mpc_tpu_torch import SolverOptions, TrajectoryParameters
from mahi_mpc_tpu_torch.models import make_dynamics, make_step
from mahi_mpc_tpu_torch.trajgen import (TrajectoryGenerator,
                                        load_waypoints_csv, read_library_csv,
                                        write_library_csv)

torch.set_num_threads(1)

WAYPOINTS = np.array([[0.0, 0.0], [0.8, 0.0], [-0.5, 0.0]])
SHAPE = dict(num_x=2, num_u=1, step_size=0.05, num_shooting_nodes=30)
LIMITS = dict(u_min=[-10.0], u_max=[10.0])


def _port(dtype, device="cpu"):
    return TrajectoryGenerator(
        TrajectoryParameters("lib", **SHAPE), make_dynamics("pendulum"),
        opts=SolverOptions(tol=1e-6, max_iter=80, dtype=dtype), **LIMITS,
        device=device)


@pytest.fixture(scope="module")
def jax_float64():
    """JAX's segments in float64 and the iterations of each of its
    augmented-Lagrangian rounds (read by wrapping its batched solver)."""
    gen = JaxGenerator(JaxTrajectoryParameters("lib", **SHAPE),
                       jax_make_dynamics("pendulum"),
                       opts=JaxSolverOptions(tol=1e-6, max_iter=80,
                                             dtype="float64"), **LIMITS)
    rounds = []
    solver = gen._solver

    def counted(batch):
        fn = solver(batch)

        def run(*args):
            res = fn(*args)
            rounds.append(np.asarray(res.iters))
            return res
        return run

    gen._solver = counted
    return gen.generate(WAYPOINTS), np.stack(rounds)


@pytest.fixture(scope="module")
def port_float32():
    gen = _port("float32")
    return gen, make_dynamics("pendulum")


def test_float64_segments_match_jax(jax_float64):
    """Equal statuses, rounds and iterations; X, U within 1e-7."""
    jsegs, jiters = jax_float64
    gen = _port("float64")
    segs = gen.generate(WAYPOINTS)
    assert gen.rounds == len(jiters)
    np.testing.assert_array_equal(gen.iters, jiters)
    assert len(segs) == len(jsegs) == 2
    for seg, jseg in zip(segs, jsegs):
        assert seg.status == jseg.status == 0
        np.testing.assert_allclose(seg.X, np.asarray(jseg.X), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(seg.U, np.asarray(jseg.U), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(seg.endpoint_err, jseg.endpoint_err,
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(seg.times, jseg.times)


def test_float32_endpoints_and_dynamics(port_float32):
    """tests/test_trajgen.py:24-38 on the port: start at the waypoint
    (1e-6), endpoint error < 1e-3, the RK4 step's residual < 1e-4 along
    each segment, |u| <= 10 + 1e-6."""
    gen, dyn = port_float32
    segs = gen.generate(WAYPOINTS)
    assert len(segs) == 2
    step = make_step(dyn.f, gen.mp.step_size, gen.mp.integrator)
    for i, seg in enumerate(segs):
        np.testing.assert_allclose(seg.X[0], WAYPOINTS[i], atol=1e-6)
        assert seg.endpoint_err < 1e-3, seg.endpoint_err
        X = torch.as_tensor(seg.X, dtype=torch.float64)
        U = torch.as_tensor(seg.U, dtype=torch.float64)
        xn = step(X[:-1].T, U.T).T
        assert float((xn - X[1:]).abs().max()) < 1e-4
        assert np.all(np.abs(seg.U) <= 10.0 + 1e-6)


def test_float32_min_effort_beats_naive(port_float32):
    """tests/test_trajgen.py:54-61: at rest at the end (|qd| < 1e-3), mean
    |u| below 5."""
    gen, _ = port_float32
    seg = gen.generate(np.array([[0.0, 0.0], [0.4, 0.0]]))[0]
    assert abs(seg.X[-1, 1]) < 1e-3
    assert np.abs(seg.U).mean() < 5.0


def test_csv_bytes_match_jax_and_round_trip(tmp_path, port_float32):
    """``generate_from_csv`` reads a waypoint file with a header; the
    library file it writes has the bytes JAX's ``write_library_csv`` writes
    from the same segments; both packages' readers give the segments back
    (to the printed 9 digits)."""
    gen, _ = port_float32
    wp_csv = tmp_path / "wps.csv"
    wp_csv.write_text("q,qd\n0.0,0.0\n0.6,0.0\n0.1,0.0\n")
    np.testing.assert_array_equal(load_waypoints_csv(wp_csv, 2),
                                  [[0.0, 0.0], [0.6, 0.0], [0.1, 0.0]])
    out = tmp_path / "lib.csv"
    segs = gen.generate_from_csv(wp_csv, out)
    jout = tmp_path / "lib_jax.csv"
    jax_write_library_csv(jout, [JaxSegment(s.times, s.X, s.U, s.endpoint_err,
                                            s.status) for s in segs], gen.mp)
    assert out.read_bytes() == jout.read_bytes()
    assert out.read_text().splitlines()[0] == "segment,t,x0,x1,u0"
    assert out.read_text().splitlines()[31].endswith(",")   # terminal node
    for back in (read_library_csv(out, 2, 1),
                 jax_read_library_csv(out, 2, 1)):
        assert len(back) == len(segs) == 2
        for b, s in zip(back, segs):
            np.testing.assert_allclose(b.times, s.times, rtol=1e-8)
            np.testing.assert_allclose(b.X, s.X, rtol=1e-7, atol=1e-12)
            np.testing.assert_allclose(b.U, s.U, rtol=1e-7, atol=1e-12)
    again = tmp_path / "again.csv"
    write_library_csv(again, read_library_csv(out, 2, 1), gen.mp)
    assert again.read_bytes() == out.read_bytes()


def test_default_device_is_the_card():
    """``device="cuda"`` (the default) raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrajectoryGenerator(TrajectoryParameters("lib", **SHAPE),
                            make_dynamics("pendulum"))


def test_waypoints_are_checked(port_float32):
    """Waypoints of the wrong width, or fewer than two, raise ValueError
    (not an assert, which ``python -O`` drops)."""
    gen, _ = port_float32
    with pytest.raises(ValueError, match="waypoints must be"):
        gen.generate(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="two waypoints"):
        gen.generate(np.zeros((1, 2)))
