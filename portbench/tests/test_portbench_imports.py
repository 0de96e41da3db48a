"""Nothing the benchmark runs loads JAX, its libraries or the JAX package,
compared by whole top-level names; the reference loads nothing of the
program."""

import subprocess
import sys

from portbench.core import ROOT, forbidden_modules


def test_whole_name_check():
    assert forbidden_modules(["mahi_mpc_tpu_torch", "mahi_mpc_tpu_torch.x",
                              "jax_free", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla",
                              "flax.linen", "mahi_mpc_tpu.solver"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "mahi_mpc_tpu.solver"]


def fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys, time\n"
        "from portbench.core import Cell, run, forbidden_modules\n"
        "from portbench import run as entry, control\n"
        "from portbench.tests.conftest import SMALL\n"
        "c = Cell('arm_ltv.b64k.fixed3', mix_overrides=dict(SMALL, batch=4,"
        " check_instances=2))\n"
        "run(c, 7, 0.1, True, time.perf_counter(), device='cpu',"
        " solver_overrides={'warm_solver': 'fused'})\n"
        "print(forbidden_modules(list(sys.modules)))\n")
    assert fresh(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.check, portbench.reference.service\n"
            "print(sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0].startswith('mahi')}))\n")
    assert fresh(code) == "[]"
