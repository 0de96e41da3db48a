"""Build the hand-written kernels in ``csrc/`` at first use and load them
with ctypes.

``cuda_build()`` compiles ``csrc/fused_sqp.cu`` with nvcc for ``sm_90a``
into ``_build/`` (ignored by git) and returns the loaded library; the file
name carries a hash of every source in ``csrc/``, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``cpu_library()`` builds
the same kernel body for the CPU with g++ (tests only).  Nothing is built or
loaded at import.
"""

from __future__ import annotations

import ctypes
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

# No --use_fast_math: the kernel relies on IEEE sqrt and division, and on
# the exact finiteness of +-inf bounds.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC",
             "-Wno-unknown-pragmas"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd_prefix, source: Path, stem: str) -> tuple[Path, str, float]:
    """Compile ``source`` into ``_build/<stem>-<hash>.so`` unless it exists;
    returns (path, compiler output, seconds spent building)."""
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"{stem}-{_source_hash()}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else "", 0.0
    # Build to a private name, then rename: concurrent builds (test
    # workers) never load a half-written file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd_prefix + ["-o", tmp, str(source)],
                              capture_output=True, text=True, cwd=CSRC)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {source.name} failed:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr, time.perf_counter() - t0


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
def cuda_build() -> tuple[ctypes.CDLL, str, float]:
    """(library, ptxas report, build seconds) of csrc/fused_sqp.cu; the
    seconds are 0 when an earlier build of the same sources was loaded."""
    path, report, secs = _compile([_nvcc()] + NVCC_FLAGS,
                                  CSRC / "fused_sqp.cu", "fused_sqp_sm90a")
    lib = ctypes.CDLL(str(path))
    fn = lib.mpc_fused_launch_f32
    fn.argtypes = [_c_ll, _c_int, _c_int, _c_void_p, _c_void_p, _c_void_p,
                   _c_void_p, _c_void_p, _c_void_p]
    fn.restype = _c_int
    return lib, report, secs


@functools.lru_cache(maxsize=None)
def cpu_library() -> ctypes.CDLL:
    """The kernel body built for the CPU (tests only)."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler found for the CPU kernel build")
    path, _, _ = _compile([gxx] + GXX_FLAGS, CSRC / "fused_sqp_cpu.cpp",
                          "fused_sqp_cpu")
    lib = ctypes.CDLL(str(path))
    for name in ("mpc_fused_solve_cpu_f32", "mpc_fused_solve_cpu_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_c_ll, _c_int, _c_int, _c_void_p, _c_void_p,
                       _c_void_p, _c_void_p, _c_void_p]
        fn.restype = _c_int
    lib.mpc_arm_eval_cpu_f32.argtypes = [_c_ll, _c_int, _c_void_p, _c_void_p,
                                         ctypes.c_float, _c_void_p,
                                         _c_void_p, _c_void_p]
    lib.mpc_arm_eval_cpu_f64.argtypes = [_c_ll, _c_int, _c_void_p, _c_void_p,
                                         ctypes.c_double, _c_void_p,
                                         _c_void_p, _c_void_p]
    lib.mpc_arm_eval_cpu_f32.restype = _c_int
    lib.mpc_arm_eval_cpu_f64.restype = _c_int
    return lib
