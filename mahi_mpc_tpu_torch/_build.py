"""Build the hand-written kernels in ``csrc/`` at first use and load them
with ctypes.

``cuda_build(name)`` compiles one CUDA library with nvcc for ``sm_90a``
into ``_build/`` (ignored by git) and returns it loaded; the file name
carries a hash of every source in ``csrc/``, so an edited source is rebuilt
and an unchanged one is loaded as it is.  ``cuda_build_all()`` starts one
nvcc for each library at once.  ``cpu_library(name)`` builds the same
kernel bodies for the CPU with g++: for the tests, and the group body's
operation count (``flop_count``) for the roofline bound that
``chip_smoke.py`` reports.  ``host_build(source)`` builds a standalone C++
source of the runtime (the plan server) with g++ into the same cache,
named by a hash of that source.  Nothing is built or loaded at import.

The libraries:

- ``fused_sqp`` (``csrc/fused_sqp.cu``): the fused SQP solve for the
  serial arms under Euler (the group body, four threads an instance; the
  4-DOF arm at small batch on the block body, a block an instance);
- ``fused_sqp_generic`` (``csrc/fused_sqp_generic.cu``): the same kernel
  for the serial arms under midpoint and RK4 (the generic nx-row path, the
  group body);
- ``fused_sqp_models`` (``csrc/fused_sqp_models.cu``): the same kernel for
  the closed-form models, every integrator (the group body on two lanes
  or one thread an instance, by shape: ``GroupBody``; the double pendulum
  under Euler at small batch on the block body: ``BlockBody``);
- ``fused_sqp_ltv`` (``csrc/fused_sqp_ltv.cu``): the same kernel in LTV
  mode (the group body at (8, 4), and at small batch the block body; one
  thread at (4, 2), (4, 1), (2, 1));
- ``riccati`` (``csrc/riccati.cu``): the lanes SQP's Riccati KKT solve (a
  group of threads an instance, ``csrc/riccati.cuh``).

The fused kernel's instantiations are split into four libraries only so
that nvcc builds them in parallel; all four export the same launcher and
occupancy query (``mpc_fused_blocks_per_sm``).

A problem without a hand-written instantiation (a user's own dynamics, an
LTV shape outside the four) gets a generated one
(``solver/target.py`` ``kernel_target``): ``register_generated(unit)``
names it ``gen-<hash>``, the hash of the unit together with ``csrc/``,
and ``cuda_build`` / ``cpu_library`` then build that name like any other
library, from a source written into ``_build/`` beside the build: for the
card the unit and the launcher (``fused_sqp_launch.cuh``, the same
exports), for g++ the unit with ``fused_sqp_cpu.cpp`` and
``flop_count.cpp`` (the CPU solve of every body, the operation count and
the card-body query); a user model's CUDA library holds the block body
beside the body the rule runs at full occupancy, where its shape splits
over the policy's lanes.  A failed build raises, naming its log; nothing
falls back.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# No --use_fast_math: the kernels rely on IEEE sqrt and division (a negative
# Cholesky pivot must give NaN), and on the exact finiteness of +-inf
# bounds.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC",
             "-Wno-unknown-pragmas"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong

# The fused kernel's C interface: B, N, model, nx, nu, pointers, scalars,
# ints, fan rungs, model constants (and on the card the stream and where it
# writes the body it launched and that body's threads an instance).
_FUSED_ARGS = [_c_ll, _c_int, _c_int, _c_int, _c_int, _c_void_p, _c_void_p,
               _c_void_p, _c_void_p, _c_void_p]
# The preparation of the kernel's inputs (csrc/fused_prepare.cuh): B, N, nx,
# nu, the batch-leading sources, the batch-innermost outputs and the host
# scalars; on the card the stream, on the CPU whether a block's threads run
# last to first.
_PREPARE = [_c_ll, _c_int, _c_int, _c_int, _c_void_p, _c_void_p, _c_void_p]
_FUSED_LAUNCH = {"mpc_fused_launch_f32": _FUSED_ARGS + [_c_void_p,
                                                        _c_void_p],
                 "mpc_fused_prepare_f32": _PREPARE + [_c_void_p],
                 "mpc_fused_block_info": [_c_int] * 6 + [_c_void_p],
                 "mpc_fused_blocks_per_sm": [_c_int] * 5}
# The LTV path's linearization and discretization (csrc/model_linearize.cuh),
# which every fused library exports beside the solve for the models and Ltv
# shapes it holds: the linearization takes B, model, nx, nu, the model's
# constants, x0, u0, A, Bm, xd0; the discretization B, nx, nu, integrator,
# dt, A, Bm, xd0, x0, u0 and the outputs AdI, Bd, cd; on the card both
# also take the stream, on the CPU whether a block's threads run last to
# first.  The occupancy query takes model, nx, nu and where it writes the
# kernel's tile.
_REALS = (("f32", ctypes.c_float), ("f64", ctypes.c_double))
_LINEARIZE = [_c_ll, _c_int, _c_int, _c_int] + [_c_void_p] * 6
_LTV_DISCRETE = lambda real: [_c_ll, _c_int, _c_int, _c_int, real] + \
    [_c_void_p] * 8
for _bits, _real in _REALS:
    _FUSED_LAUNCH.update({
        f"mpc_linearize_launch_{_bits}": _LINEARIZE + [_c_void_p],
        f"mpc_ltv_discrete_launch_{_bits}": _LTV_DISCRETE(_real)
        + [_c_void_p],
        f"mpc_ltv_path_blocks_per_sm_{_bits}": [_c_int] * 3 + [_c_void_p]})
_ARM_EVAL = [_c_ll, _c_int, _c_void_p, _c_void_p]

# name -> (CUDA source, {launcher: argtypes})
CUDA_LIBRARIES = {
    "fused_sqp": ("fused_sqp.cu", _FUSED_LAUNCH),
    "fused_sqp_generic": ("fused_sqp_generic.cu", _FUSED_LAUNCH),
    "fused_sqp_models": ("fused_sqp_models.cu", _FUSED_LAUNCH),
    "fused_sqp_ltv": ("fused_sqp_ltv.cu", _FUSED_LAUNCH),
    "riccati": ("riccati.cu", {
        "mpc_riccati_launch_f32": [_c_ll, _c_int, _c_int, _c_int, _c_void_p,
                                   _c_void_p],
        "mpc_riccati_smem_bytes": [_c_int, _c_int],
        "mpc_riccati_blocks_per_sm": [_c_int, _c_int],
    }),
}

# name -> (CPU source, {function: argtypes})
CPU_LIBRARIES = {
    "fused_sqp": ("fused_sqp_cpu.cpp", {
        "mpc_fused_solve_cpu_f32": _FUSED_ARGS,
        "mpc_fused_solve_cpu_f64": _FUSED_ARGS,
        "mpc_fused_solve_group_cpu_f32": _FUSED_ARGS,
        "mpc_fused_solve_group_cpu_f64": _FUSED_ARGS,
        "mpc_fused_solve_block_cpu_f32": _FUSED_ARGS,
        "mpc_fused_solve_block_cpu_f64": _FUSED_ARGS,
        **{f"mpc_arm_{kind}_cpu_{bits}": _ARM_EVAL + [real] + [_c_void_p] * 3
           for kind in ("eval", "fold", "sweep")
           for bits, real in (("f32", ctypes.c_float),
                              ("f64", ctypes.c_double))},
        **{f"mpc_model_eval_cpu_{bits}": [
            _c_ll, _c_int, _c_int, _c_void_p, _c_void_p, real, _c_void_p,
            _c_void_p, _c_void_p, _c_void_p, _c_void_p]
           for bits, real in (("f32", ctypes.c_float),
                              ("f64", ctypes.c_double))},
        **{f"mpc_model_increment_cpu_{bits}": [
            _c_ll, _c_int, _c_int, _c_void_p, _c_void_p, real, _c_void_p,
            _c_void_p, _c_void_p]
           for bits, real in (("f32", ctypes.c_float),
                              ("f64", ctypes.c_double))},
        **{f"mpc_linearize_cpu_{bits}": _LINEARIZE + [_c_int]
           for bits, _ in _REALS},
        **{f"mpc_ltv_discrete_cpu_{bits}": _LTV_DISCRETE(real) + [_c_int]
           for bits, real in _REALS},
        **{f"mpc_fused_prepare_cpu_{bits}": _PREPARE + [_c_int]
           for bits, _ in _REALS},
    }),
    "riccati": ("riccati_cpu.cpp", {
        "mpc_riccati_cpu_f32": [_c_ll, _c_int, _c_int, _c_int, _c_void_p],
        "mpc_riccati_cpu_f64": [_c_ll, _c_int, _c_int, _c_int, _c_void_p],
    }),
    "flop_count": ("flop_count.cpp", {
        "mpc_fused_count_ops": _FUSED_ARGS + [_c_int, _c_void_p],
        "mpc_fused_count_path": _FUSED_ARGS + [_c_void_p],
        "mpc_fused_card_body": [_c_int] * 5 + [_c_ll, _c_int, _c_void_p],
        "mpc_linearize_count_ops": _LINEARIZE[:7] + [_c_void_p],
        "mpc_ltv_discrete_count_ops": _LTV_DISCRETE(ctypes.c_double)[:10]
        + [_c_void_p],
    }),
}


# The exports of a generated g++ build: the fused solve's CPU bodies, the
# generated model's evaluation, the operation count and the card's body.
_GENERATED_CPU = {
    k: v for k, v in {**CPU_LIBRARIES["fused_sqp"][1],
                      **CPU_LIBRARIES["flop_count"][1]}.items()
    if not k.startswith("mpc_arm_")}

# Generated units by library name (``register_generated``).
GENERATED: dict = {}


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd_prefix, source: Path, stem: str,
             digest: str | None = None) -> tuple[Path, str, float]:
    """Compile ``source`` into ``_build/<stem>-<digest>.so`` unless it
    exists (``digest``: a hash of the sources it reads, by default all of
    ``csrc/``); returns (path, compiler output, seconds spent building)."""
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"{stem}-{digest or _source_hash()}.so"
    log = out.with_suffix(".log")
    # One build per library across processes (test workers): the others
    # wait on the lock and load the result.
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, log.read_text() if log.exists() else "", 0.0
        return _compile_locked(cmd_prefix, source, out, log)


def _compile_locked(cmd_prefix, source: Path, out: Path, log: Path):
    # Build to a private name, then rename: a reader never loads a
    # half-written file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd_prefix + ["-o", tmp, str(source)],
                              capture_output=True, text=True,
                              cwd=source.parent)
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {source.name} failed (log: {log}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr, time.perf_counter() - t0


def _load(path: Path, functions: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fname, argtypes in functions.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = _c_int
    return lib


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def register_generated(unit: str) -> str:
    """The library name of a generated unit (``gen-`` and the hash of the
    unit together with ``csrc/``), which ``cuda_build`` and
    ``cpu_library`` then build."""
    h = hashlib.sha256(unit.encode())
    h.update(_source_hash().encode())
    name = f"gen-{h.hexdigest()[:16]}"
    GENERATED[name] = unit
    return name


def _generated_source(name: str, target: str) -> Path:
    """Write the source of generated library ``name`` for ``target``
    ("cuda" or "cpu") into ``_build/`` (once: the name is its hash)."""
    unit = GENERATED[name]
    if target == "cuda":
        # a user's model, linearized by the build where its policy is LTV
        # (csrc/model_linearize.cuh `model_dispatch`)
        model = "#define MPC_GENERATED_MODEL 1\n" \
            if "namespace gen" in unit else ""
        text = ("// A generated instantiation of the fused kernel "
                f"(_build.py).\n{model}#include \"fused_sqp_launch.cuh\"\n\n"
                f"{unit}\nMPC_FUSED_LIBRARY(mpc::kGenerated)\n")
        suffix = ".cu"
    else:
        model = "#define MPC_GENERATED_MODEL 1\n" \
            if "namespace gen" in unit else ""
        text = ("// A generated instantiation of the fused kernel, built for "
                "the CPU (_build.py).\n#include \"fused_sqp_group.cuh\"\n\n"
                f"{unit}\n#define MPC_GENERATED 1\n{model}"
                "#include \"fused_sqp_cpu.cpp\"\n#include \"flop_count.cpp\"\n")
        suffix = ".cpp"
    BUILD_DIR.mkdir(exist_ok=True)
    path = BUILD_DIR / f"{name}{suffix}"
    if not path.exists() or path.read_text() != text:
        fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def cuda_build(name: str) -> tuple[ctypes.CDLL, str, float]:
    """(library, ptxas report, build seconds) of the CUDA library ``name``
    (one of ``CUDA_LIBRARIES`` or a registered generated one); the seconds
    are 0 when an earlier build of the same sources was loaded.
    ``cuda_build.seconds[name]`` keeps (build seconds, load seconds:
    ``ctypes.CDLL`` and the argument types) of each library this process
    built or loaded."""
    if name in GENERATED:
        path, report, secs = _compile(
            [_nvcc()] + NVCC_FLAGS + ["-I", str(CSRC)],
            _generated_source(name, "cuda"), f"{name}_sm90a",
            name.split("-", 1)[1])
        functions = _FUSED_LAUNCH
    else:
        source, functions = CUDA_LIBRARIES[name]
        path, report, secs = _compile([_nvcc()] + NVCC_FLAGS, CSRC / source,
                                      f"{name}_sm90a")
    t0 = time.perf_counter()
    lib = _load(path, functions)
    cuda_build.seconds[name] = (secs, time.perf_counter() - t0)
    return lib, report, secs


cuda_build.seconds = {}


def cuda_build_all(extra=()) -> dict:
    """Build every CUDA library and the generated ones named in ``extra``,
    one nvcc each, all started together; returns {name: (library, ptxas
    report, build seconds)}."""
    names = list(CUDA_LIBRARIES) + list(extra)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        futures = {name: ex.submit(cuda_build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def _gxx() -> str:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler found for the CPU build")
    return gxx


@functools.lru_cache(maxsize=None)
def cpu_library(name: str = "fused_sqp") -> ctypes.CDLL:
    """A kernel body built for the CPU (the tests; the operation count and
    the card-body query): one of ``CPU_LIBRARIES`` or a registered
    generated library."""
    if name in GENERATED:
        path, _, _ = _compile([_gxx()] + GXX_FLAGS + ["-I", str(CSRC)],
                              _generated_source(name, "cpu"), f"{name}_cpu",
                              name.split("-", 1)[1])
        return _load(path, _GENERATED_CPU)
    source, functions = CPU_LIBRARIES[name]
    path, _, _ = _compile([_gxx()] + GXX_FLAGS, CSRC / source, f"{name}_cpu")
    return _load(path, functions)


def cpu_build_all(names) -> dict:
    """``cpu_library`` of each name, one g++ each, all started together."""
    names = list(dict.fromkeys(names))
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as ex:
        futures = {name: ex.submit(cpu_library, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.lru_cache(maxsize=None)
def host_build(source: Path) -> Path:
    """The shared library g++ builds from one standalone C++ source of the
    runtime; the caller loads it and declares its functions."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    path, _, _ = _compile([_gxx()] + GXX_FLAGS + ["-pthread"], source,
                          source.stem, digest)
    return path
