"""The harness core: one run of one cell.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``,
which names its generator, ``generators/<generator>.py``); its per-layer
metrics are readers (``layer_metrics/<metric>.py``) and its correctness
limits ``limits/<cell>.json``.  Everything is found by name, so a cell, a
mix, a configuration or a metric is added by adding files.

A run: set-up (load the port, build the cell's CUDA libraries, make the
traffic on the device from the seed, the cold seed step and the warm-up
steps), the measured window (closed-loop service steps back to back for
the given seconds), with ``trace`` a further stretch of steps under
``torch.profiler``, then the comparison with the plain reference on a
sample of the window's answers drawn from the seed.  The end-to-end
arithmetic lives here; ``result`` is the contract's line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mahi_mpc_tpu")
DIVERGED = 2


# ---- finding a cell's pieces by name ------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file, whatever characters its name holds."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in path.relative_to(BENCH).as_posix())
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, mix,
    generator, limits and the metrics it reports."""

    def __init__(self, name: str, mix_overrides: dict | None = None):
        bench = load_json(ROOT / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, found[0]
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.workload["config"])
        self.config = load_json(ROOT / conf["file"])
        self.mix = load_json(BENCH / "traffic" /
                             f"{self.workload['traffic']}.json")
        self.mix.update(mix_overrides or {})
        self.generator = load_module(
            BENCH / "generators" / f"{self.mix['generator']}.py")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.peaks = load_json(BENCH / "peaks.json")
        applies = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]
        self.chips = int(self.workload["chips"])

    def reader(self, metric: str):
        return load_module(BENCH / "layer_metrics" / f"{metric}.py")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


# ---- the yardstick's arithmetic -------------------------------------------

def fused_io_bytes(cfg: dict) -> int:
    """Bytes of one instance's fused solve, each input read once and each
    output written once, from the shapes: the warm start X, U, the
    reference, the weights, the previous control, the state, the bounds,
    the terminal terms and the barrier; in LTV the streamed (Ad - I, Bd,
    cd); out X, U and 8 statistics.  The kernel's scratch is not counted."""
    m = cfg["model"]
    nx, nu, N = m["num_x"], m["num_u"], m["num_shooting_nodes"]
    ins = ((N + 1) * nx + N * nu + N * nx + nx + 2 * nu + nu
           + 2 * nu + 2 * nx + 2 * nx + 1)
    if m["is_linear"]:
        ins += nx * nx + nx * nu + nx
    outs = (N + 1) * nx + N * nu + 8
    return 4 * (ins + outs)


def fused_ops(cfg: dict, iters: int) -> float:
    return float(cfg["ops_per_instance"]["fused_per_iteration_fixed"]) * iters


def step_ops(cfg: dict, iters: int) -> float:
    """Operations of one instance's service step: the fused solve and, in
    LTV, the linearization and the discretization."""
    o = cfg["ops_per_instance"]
    return (fused_ops(cfg, iters) + float(o["linearize_per_step"])
            + float(o["discretize_per_step"]))


def roofline_pct(ops: float, nbytes: float, seconds: float,
                 peaks: dict) -> float:
    """The least time the chip could take (operations over the FP32 peak
    or bytes over HBM, the larger), as a share of ``seconds``."""
    bound = max(ops / peaks["fp32_flops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


END_TO_END = {
    "setup_s": lambda s: s["setup_s"],
    "solves_per_s": lambda s: s["batch"] * s["steps"] / s["window_s"],
    "step_ms_p95": lambda s: 1e3 * percentile(s["step_s"], 95),
}


# ---- the profiler's trace ---------------------------------------------------

def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _device_events(events):
    """The device's operations: kernels, copies and sets.  The profiler
    also mirrors each host range (``record_function``) on the device's
    timeline; those are annotations, not device work."""
    from torch.autograd import DeviceType
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in host and e.time_range.end > e.time_range.start]


def device_time(events, kernels: list) -> dict:
    """Busy seconds (the union of the device's operations), seconds and
    launches of each of ``kernels`` (by a part of the name), and the
    operations that took most time."""
    dev = _device_events(events)
    busy_us = sum(b - a for a, b in _union(
        [(e.time_range.start, e.time_range.end) for e in dev]))
    by_name: dict = {}
    for e in dev:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) * 1e-6
        t[1] += 1
    kernel = {k: [sum(v[0] for n, v in by_name.items() if k in n),
                  sum(v[1] for n, v in by_name.items() if k in n)]
              for k in kernels}
    return dict(busy_s=busy_us * 1e-6, kernel_s=kernel,
                device_ops=_top({k[:120]: v[0] for k, v in by_name.items()}))


def idle_gaps(events) -> list:
    """The device's idle gaps between its first and last operation, summed
    by the operation that ends each gap (what the host was preparing)."""
    merged = []
    for e in sorted(_device_events(events), key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b, e.name])
    gaps: dict = {}
    for (_, b, _), (a, _, name) in zip(merged, merged[1:]):
        label = "before " + name[:113]
        gaps[label] = gaps.get(label, 0.0) + (a - b) * 1e-6
    return _top(gaps)


# ---- the run ----------------------------------------------------------------

class Recorder:
    """Per step, on the device: the measured state, the plan, the status
    and the control of the sampled instances ``rows``, for the comparison
    after the window."""

    def __init__(self, rows, nx: int, nu: int, N: int, capacity: int, torch):
        self.torch, self.rows = torch, rows
        self.split = np.cumsum([nx, (N + 1) * nx, N * nu, 1, nu])[:-1]
        self.shapes = dict(nx=nx, nu=nu, N=N)
        width = nx + (N + 1) * nx + N * nu + 1 + nu
        self.buf = torch.empty(capacity, len(rows), width,
                               dtype=torch.float32, device=rows.device)
        self.n = 0

    def reserve(self, extra: int) -> None:
        """Room for ``extra`` more steps (the window's, estimated from the
        warm-up, with room to spare; ``add`` grows it if that falls
        short)."""
        self.buf = self.torch.cat([self.buf[:self.n], self.buf.new_empty(
            (extra,) + tuple(self.buf.shape[1:]))])

    def add(self, x, res, u) -> None:
        torch, r = self.torch, self.rows
        if self.n == self.buf.shape[0]:
            self.reserve(self.n)
        self.buf[self.n] = torch.cat([
            x[r], res.X[r].flatten(1), res.U[r].flatten(1),
            res.status[r, None].to(torch.float32), u[r]], 1)
        self.n += 1

    def host(self) -> dict:
        a = self.buf[:self.n].cpu().numpy()
        x0, X, U, st, u = np.split(a, self.split, axis=2)
        nx, nu, N = (self.shapes[k] for k in ("nx", "nu", "N"))
        K, S = a.shape[:2]
        return dict(x0=x0, X=X.reshape(K, S, N + 1, nx),
                    U=U.reshape(K, S, N, nu), status=st[..., 0], u=u,
                    rows=self.rows)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", solver_overrides: dict | None = None,
        control_dtypes=()) -> dict:
    """One run of ``cell``; returns the summary the metrics read, with the
    comparison's numbers (and, for each of ``control_dtypes``, the same
    numbers with the reference in that dtype put in the program's place)."""
    import torch
    from mahi_mpc_tpu_torch import ModelParameters, SolverOptions
    from mahi_mpc_tpu_torch.runtime import BatchModelControl

    from .check import compare

    cfg, mix = cell.config, cell.mix
    m = cfg["model"]
    nx, nu, N, dt = (m["num_x"], m["num_u"], m["num_shooting_nodes"],
                     float(m["step_size"]))
    B, W = int(mix["batch"]), int(mix["warm_steps"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        import concurrent.futures

        from mahi_mpc_tpu_torch._build import cuda_build
        with concurrent.futures.ThreadPoolExecutor() as ex:
            for f in [ex.submit(cuda_build, lib)
                      for lib in cfg["cuda_libraries"]]:
                f.result()
    mp = ModelParameters(cfg["name"], num_x=nx, num_u=nu, step_size=dt,
                         num_shooting_nodes=N, is_linear=m["is_linear"],
                         u_min=m["u_min"], u_max=m["u_max"],
                         integrator=m["integrator"],
                         dynamics_name=m["dynamics"])
    opts = SolverOptions(**{**cfg["solver"], **(solver_overrides or {}),
                            "fixed_warm_iters": int(mix["fixed_warm_iters"])})
    wts = cfg["weights"]
    svc = BatchModelControl(mp, batch=B, device=device, opts=opts,
                            Q=wts["Q"], R=wts["R"], Rm=wts["Rm"])
    gen = cell.generator.make(mix, nx, N, dt, seed, device)
    rng = np.random.default_rng(seed)
    S = min(int(mix["check_instances"]), B)
    rows = torch.as_tensor(np.sort(rng.choice(B, S, replace=False)),
                           device=device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    failed = torch.zeros((), dtype=torch.int64, device=device)
    iters = torch.zeros((), dtype=torch.float64, device=device)
    st = dict(k=0, x=gen.x0, u=None, ok=None)

    def record(res, u):
        ok = ((res.status != DIVERGED)
              & torch.isfinite(res.X).flatten(1).all(1)
              & torch.isfinite(res.U).flatten(1).all(1))
        rec.add(st["x"], res, u)
        st.update(u=u, ok=ok)
        return ((res.status != 0) | ~torch.isfinite(u).all(1)).sum(), res

    def step():
        """One closed-loop step: the measured state and the reference,
        the service's step, the controls to the host."""
        nonlocal failed, iters
        k = st["k"] = st["k"] + 1
        x = gen.next_state(st["x"], svc.last.X[:, 1], st["ok"])
        st["x"] = x
        svc.set_states(x, u_prev=st["u"])
        svc.set_references(gen.reference(k))
        u = svc.step()
        bad, res = record(svc.last, u)
        failed = failed + bad
        iters = iters + res.iters.sum()
        u.cpu()

    # ---- set-up: the cold seed and the warm-up steps
    rec = Recorder(rows, nx, nu, N, W + 1, torch)
    svc.set_states(gen.x0)
    svc.set_references(gen.reference(0))
    u = svc.step()
    record(svc.last, u)
    u.cpu()
    warm_s = []
    for _ in range(W):
        t0 = time.perf_counter()
        step()
        warm_s.append(time.perf_counter() - t0)
    rec.reserve(int(mix["trace_steps"]) + 16
                + int(3 * seconds / max(min(warm_s, default=1.0), 1e-3)))
    failed.zero_()
    iters.zero_()
    sync()
    setup_s = time.perf_counter() - t_start

    # ---- the window
    first = st["k"] + 1
    step_s, solve_s = [], []
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        step_s.append(t1 - t0)
        solve_s.append(svc.solve_time_s)
        if t1 - w0 >= seconds:
            break
    window_s = t1 - w0
    last = st["k"]
    n = len(step_s)
    summary = dict(cell=cell.name, config=cfg, mix=mix, peaks=cell.peaks,
                   batch=B, steps=n, window_s=window_s, step_s=step_s,
                   solve_s=solve_s, setup_s=setup_s,
                   attempted=B * n, failed=int(failed),
                   mean_iters=float(iters) / (B * n),
                   fused_io_bytes=fused_io_bytes(cfg), trace=None)

    # ---- a traced stretch after the window: the device's operations
    # alone (little cost to the host); the host's on the CPU
    if trace:
        from torch.profiler import ProfilerActivity, profile
        K = int(mix["trace_steps"])
        solve_tr = []
        with profile(activities=[ProfilerActivity.CUDA] if on_card
                     else [ProfilerActivity.CPU]) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(K):
                step()
                solve_tr.append(svc.solve_time_s)
            sync()
            t1 = time.perf_counter()
        ks = cfg["kernels"]
        names = {ks["fused"], *ks["ltv_prep"], *ks["in_solve"]}
        events = list(prof.events())
        tr = device_time(events, sorted(names))
        if on_card and tr["busy_s"] <= 0:
            raise RuntimeError("the profiler saw no device operation")
        tr.update(window_s=t1 - t0, steps=K, solve_s=solve_tr,
                  idle_gaps=idle_gaps(events))
        summary["trace"] = tr

    summary["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if on_card else 0)
    captured = rec.host()
    del svc, rec, st
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    summary["compared"], summary["control"], summary["reference_parts_s"] = \
        compare(cell, gen, captured, first, last, seed, device,
                control_dtypes)
    summary["reference_s"] = time.perf_counter() - t0
    return summary


def result(cell: Cell, summary: dict, trace: bool, device_info: dict) -> dict:
    """The contract's line: with ``trace`` the per-layer metrics, else the
    end-to-end ones; the compared numbers last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": END_TO_END[m["name"]](summary),
                                  "unit": m["unit"]}
    cmp = summary["compared"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in cmp.values())
    dev = dict(device_info, memory_peak_bytes=summary["memory_peak_bytes"])
    out = dict(correct=correct, attempted=summary["attempted"],
               failed=summary["failed"], metrics=metrics, device=dev)
    if trace and summary["trace"] is not None:
        tr = summary["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = dict(device_ops=tr["device_ops"],
                                idle_gaps=tr["idle_gaps"])
    out["compared"] = cmp
    return out
