"""The port's trajectory-library and batch-scenario examples
(``mahi_mpc_tpu_torch/examples/{trajectory_library,batch_scenarios}.py``,
counterparts of ``examples/trajectory_library.py`` and
``examples/batch_scenarios.py``) run end to end as subprocesses with
``--device cpu`` at a small size; without ``--device`` they ask for the
card and exit non-zero where there is none."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"mahi_mpc_tpu_torch.examples.{module}",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_trajectory_library_demo(tmp_path):
    """The demo waypoints (pendulum, N=20, dt=0.05, |u| <= 10): three
    segments, each printed with its status, and a library CSV of 3 x 21
    rows after the header."""
    out = tmp_path / "lib.csv"
    r = _run("trajectory_library", "--device", "cpu", "--nodes", "20",
             "--u-limit", "10", "--out", str(out))
    assert r.returncode == 0, r.stderr
    assert "demo waypoints" in r.stdout
    assert r.stdout.count("status=") == 3
    assert f"library written to {out}" in r.stdout
    lines = out.read_text().splitlines()
    assert lines[0] == "segment,t,x0,x1,u0" and len(lines) == 1 + 3 * 21


def test_trajectory_library_from_csv(tmp_path):
    """--waypoints: the file's two rest states give one segment that starts
    at the first (1e-6) and ends near the second."""
    wps = tmp_path / "wps.csv"
    wps.write_text("q,qd\n0.0,0.0\n0.3,0.0\n")
    out = tmp_path / "lib.csv"
    r = _run("trajectory_library", "--device", "cpu", "--nodes", "20",
             "--waypoints", str(wps), "--out", str(out))
    assert r.returncode == 0, r.stderr
    rows = np.loadtxt(out, delimiter=",", skiprows=1, usecols=(0, 1, 2, 3))
    assert rows.shape == (21, 4) and set(rows[:, 0]) == {0.0}
    np.testing.assert_allclose(rows[0, 2:], [0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(rows[-1, 2:], [0.3, 0.0], atol=5e-2)


def test_batch_scenarios_small(tmp_path):
    """batch 8, 3 steps of the closed loop on the CPU: the cold step and
    the summary are printed."""
    r = _run("batch_scenarios", "--device", "cpu", "--batch", "8",
             "--steps", "3")
    assert r.returncode == 0, r.stderr
    assert "step 0 (cold)" in r.stdout
    assert "3 steps x 8 instances" in r.stdout
    assert "instances within 0.05 rad of goal" in r.stdout


@pytest.mark.parametrize("module", ["trajectory_library", "batch_scenarios"])
def test_default_device_is_the_card(module, tmp_path):
    """Without --device the examples run on the card: no card, no run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(module, "--out", str(tmp_path / "lib.csv")
             ) if module == "trajectory_library" else _run(module)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
