"""Multi-process runs of the port over ``torch.distributed`` on the CPU
(``mahi_mpc_tpu_torch/parallel/distributed.py``), the counterpart of
tests/test_distributed.py: two gloo processes, each solving its half of the
batch, gather the whole result, which must equal the JAX package's
single-process ``solve_batch_lanes`` on the same problem.

The children are ``mahi_mpc_tpu_torch.examples.distributed_solve`` run as
subprocesses with torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``); this process never joins a process group.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mahi_mpc_tpu import ModelParameters as JaxModelParameters
from mahi_mpc_tpu import SolverOptions as JaxSolverOptions
from mahi_mpc_tpu.models import make_dynamics as jax_make_dynamics
from mahi_mpc_tpu.solver.batched import solve_batch_lanes as jax_lanes
from mahi_mpc_tpu.transcribe.shooting import default_params as jax_default_params
from mahi_mpc_tpu.transcribe.shooting import make_problem as jax_make_problem
from mahi_mpc_tpu_torch import SolverOptions
from mahi_mpc_tpu_torch.examples.distributed_solve import problem
from mahi_mpc_tpu_torch.parallel import (global_batch_mesh,
                                         initialize_distributed,
                                         process_allgather, scaling_table)

ROOT = Path(__file__).resolve().parents[1]
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_reference(B=16):
    """tests/test_distributed.py:68-87's single-process solve."""
    dyn = jax_make_dynamics("double_pendulum")
    mp = JaxModelParameters("dist_dp", num_x=4, num_u=2, step_size=0.02,
                            num_shooting_nodes=8, u_min=[-6.0, -6.0],
                            u_max=[6.0, 6.0], dynamics_name="double_pendulum")
    prob = jax_make_problem(mp, dyn)
    rng = np.random.default_rng(7)
    p = jax_default_params(mp)._replace(
        q=jnp.array([10.0, 1.0, 5.0, 5.0], jnp.float32),
        r=jnp.array([5.0, 5.0], jnp.float32),
        rm=jnp.array([0.1, 0.1], jnp.float32))
    p_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    p_b = p_b._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, 4)), jnp.float32),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, 8, 4)), jnp.float32))
    return jax_lanes(prob, p_b, opts=JaxSolverOptions(tol=1e-5, max_iter=25))


def test_two_gloo_processes_match_jax(tmp_path):
    """Two ranks over gloo on the CPU, 8 instances each: both see the same
    gathered result, whose U lies within 5e-4 of JAX's single-process
    lanes solve (tests/test_distributed.py's band) and whose converged
    fraction equals JAX's."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mahi_mpc_tpu_torch.examples.distributed_solve",
         "--device", "cpu", "--backend", "gloo", "--out", str(tmp_path)],
        cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    r0, r1 = (json.loads(out.strip().splitlines()[-1]) for out, _ in outs)
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["processes"] == 2 and r0["backend"] == "gloo"
    assert r0["mesh"] == ["cpu", "cpu"] and r0["local_batch"] == 8
    assert r0["all_finite"] and r1["all_finite"]
    assert r0["U_sum"] == r1["U_sum"]

    ref = _jax_reference()
    assert r0["converged_frac"] == pytest.approx(
        float(np.mean(np.asarray(ref.status) == 0)))
    U = np.load(tmp_path / "U.npy")
    np.testing.assert_allclose(U, np.asarray(ref.U), atol=5e-4, rtol=1e-4)
    np.testing.assert_array_equal(np.load(tmp_path / "status.npy"),
                                  np.asarray(ref.status))


def test_nothing_configured_is_one_process(monkeypatch):
    """Without an address or torchrun's environment,
    ``initialize_distributed()`` returns False and joins nothing; the
    global mesh is then this process's devices, and a gather is the local
    value."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = global_batch_mesh(devices=["cpu"])
    assert mesh.shape == {"batch": 1, "time": 1}
    t = torch.arange(6.0)
    assert torch.equal(process_allgather([t[:3], t[3:]]), t)
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed("localhost:1", 2)
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed("localhost:1", 2, 0, backend="mpi")


def test_scaling_table_one_process():
    """One process on the CPU: a ``one_chip`` row and no other."""
    prob, p = problem(8, torch.device("cpu"))
    table = scaling_table(prob, p, SolverOptions(tol=1e-4, max_iter=10))
    assert table["process_count"] == 1 and table["global_devices"] == 1
    assert "one_host" not in table and "global" not in table
    assert table["one_chip"]["batch"] == 8
    assert table["one_chip"]["solves_per_s"] > 0
