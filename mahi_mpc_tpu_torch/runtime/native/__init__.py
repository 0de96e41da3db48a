"""ctypes bindings for the native real-time plan server (``plan_server.cpp``,
the port's own copy of the JAX package's).

g++ builds it at first use into ``mahi_mpc_tpu_torch/_build/`` through
``_build.host_build`` (hash-named, file-locked: concurrent processes share
one build).  The reference ships its runtime as a compiled C++ library,
and this is where native code matters: a wait-free seqlock plan handoff
and a sub-ms deadline pacer that Python's GIL and timers cannot guarantee.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "plan_server.cpp"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    from ..._build import host_build
    dll = ctypes.CDLL(str(host_build(_SRC)))
    dll.plan_server_create.restype = ctypes.c_void_p
    dll.plan_server_create.argtypes = [ctypes.c_int] * 3
    dll.plan_server_destroy.restype = None
    dll.plan_server_destroy.argtypes = [ctypes.c_void_p]
    dll.plan_server_publish.restype = None
    dll.plan_server_publish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    dll.plan_server_sample.restype = ctypes.c_int
    dll.plan_server_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
    dll.plan_server_published.restype = ctypes.c_uint64
    dll.plan_server_published.argtypes = [ctypes.c_void_p]
    dll.pacer_create.restype = ctypes.c_void_p
    dll.pacer_create.argtypes = [ctypes.c_double]
    dll.pacer_destroy.restype = None
    dll.pacer_destroy.argtypes = [ctypes.c_void_p]
    dll.pacer_wait.restype = ctypes.c_double
    dll.pacer_wait.argtypes = [ctypes.c_void_p]
    dll.pacer_misses.restype = ctypes.c_uint64
    dll.pacer_misses.argtypes = [ctypes.c_void_p]
    dll.pacer_worst_late.restype = ctypes.c_double
    dll.pacer_worst_late.argtypes = [ctypes.c_void_p]
    dll.monotonic_now.restype = ctypes.c_double
    dll.monotonic_now.argtypes = []
    return dll


def native_available() -> bool:
    try:
        load_library()
        return True
    except (RuntimeError, OSError):
        return False


class NativePlanServer:
    """Wait-free plan handoff: solver thread publishes, RT thread samples."""

    def __init__(self, nx: int, nu: int, N: int):
        self._dll = load_library()
        self.nx, self.nu, self.N = nx, nu, N
        self._h = self._dll.plan_server_create(nx, nu, N)
        self._u = np.zeros(nu)

    def publish(self, times: np.ndarray, X: np.ndarray, U: np.ndarray) -> None:
        t = np.ascontiguousarray(times, dtype=np.float64)
        x = np.ascontiguousarray(X, dtype=np.float64)
        u = np.ascontiguousarray(U, dtype=np.float64)
        if (t.shape != (self.N + 1,) or x.shape != (self.N + 1, self.nx)
                or u.shape != (self.N, self.nu)):
            raise ValueError(
                f"plan shapes {t.shape}, {x.shape}, {u.shape}; expected "
                f"({self.N + 1},), ({self.N + 1}, {self.nx}), "
                f"({self.N}, {self.nu})")
        c = ctypes.POINTER(ctypes.c_double)
        self._dll.plan_server_publish(
            self._h, t.ctypes.data_as(c), x.ctypes.data_as(c),
            u.ctypes.data_as(c))

    def sample(self, t: float) -> Optional[np.ndarray]:
        """ZOH control at time t; None before the first publish."""
        c = ctypes.POINTER(ctypes.c_double)
        rc = self._dll.plan_server_sample(
            self._h, float(t), self._u.ctypes.data_as(c))
        return None if rc != 0 else self._u.copy()

    @property
    def published_count(self) -> int:
        return int(self._dll.plan_server_published(self._h))

    def __del__(self):
        try:
            self._dll.plan_server_destroy(self._h)
        except Exception:
            pass


class NativePacer:
    """Monotonic deadline pacer with spin-finish (sub-ms accuracy)."""

    def __init__(self, period_s: float):
        self._dll = load_library()
        self._h = self._dll.pacer_create(float(period_s))

    def wait(self) -> float:
        """Block until the next deadline; returns lateness (0 = on time)."""
        return float(self._dll.pacer_wait(self._h))

    @property
    def misses(self) -> int:
        return int(self._dll.pacer_misses(self._h))

    @property
    def worst_late_s(self) -> float:
        return float(self._dll.pacer_worst_late(self._h))

    def __del__(self):
        try:
            self._dll.pacer_destroy(self._h)
        except Exception:
            pass
