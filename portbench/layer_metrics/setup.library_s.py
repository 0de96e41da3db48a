"""The cell's CUDA libraries in the set-up: the program's counters
(``_build.cuda_build.seconds``) of each library the configuration names,
its nvcc seconds (0 when a build of the same sources was there) and its
load seconds (``ctypes.CDLL`` and the argument types), summed."""

UNIT, LAYER, MOVES = "s", "set-up", "setup_s"


def read(s):
    try:
        from mahi_mpc_tpu_torch._build import cuda_build
    except ImportError:
        return None
    seconds = getattr(cuda_build, "seconds", {})
    libs = s["config"]["cuda_libraries"]
    if not libs or not all(lib in seconds for lib in libs):
        return None
    return sum(sum(seconds[lib]) for lib in libs)
