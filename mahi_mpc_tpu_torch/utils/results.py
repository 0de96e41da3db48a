"""Results export for plotting + solve-time reporting (C15); the port's own
copy of ``mahi_mpc_tpu/utils/results.py``, which imports no JAX either.

The reference dumps executable MATLAB scripts with the sim results
(``examples/model_control_example.cpp:98-152``) and prints average solve time
(``:95``).  Here: CSV (plot-tool-agnostic), NPZ (lossless), and an optional
matplotlib PNG when the library is available; the timing report carries the
full latency distribution instead of one mean.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


class ControlLog:
    """Accumulates closed-loop samples: (t, x, u, x_des, solve diagnostics)."""

    def __init__(self):
        self.t: list[float] = []
        self.x: list[np.ndarray] = []
        self.u: list[np.ndarray] = []
        self.x_des: list[np.ndarray] = []
        self.solve_ms: list[float] = []
        self.iters: list[int] = []

    def append(self, t: float, x, u, x_des=None, solve_ms: float = np.nan,
               iters: int = -1) -> None:
        self.t.append(float(t))
        self.x.append(np.asarray(x, float).copy())
        self.u.append(np.asarray(u, float).copy())
        self.x_des.append(None if x_des is None
                          else np.asarray(x_des, float).copy())
        self.solve_ms.append(float(solve_ms))
        self.iters.append(int(iters))

    def arrays(self):
        t = np.asarray(self.t)
        x = np.stack(self.x)
        u = np.stack(self.u)
        xd = (np.stack([d for d in self.x_des])
              if self.x_des and self.x_des[0] is not None else None)
        return t, x, u, xd

    # -- exports -------------------------------------------------------------

    def to_csv(self, path: str | Path) -> Path:
        t, x, u, xd = self.arrays()
        nx, nu = x.shape[1], u.shape[1]
        cols = (["t"] + [f"x{i}" for i in range(nx)]
                + [f"u{i}" for i in range(nu)]
                + ([f"xdes{i}" for i in range(nx)] if xd is not None else [])
                + ["solve_ms", "iters"])
        path = Path(path)
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for k in range(len(t)):
                row = [f"{t[k]:.9g}"]
                row += [f"{v:.9g}" for v in x[k]]
                row += [f"{v:.9g}" for v in u[k]]
                if xd is not None:
                    row += [f"{v:.9g}" for v in xd[k]]
                row += [f"{self.solve_ms[k]:.6g}", str(self.iters[k])]
                f.write(",".join(row) + "\n")
        return path

    def to_npz(self, path: str | Path) -> Path:
        t, x, u, xd = self.arrays()
        path = Path(path)
        data = {"t": t, "x": x, "u": u,
                "solve_ms": np.asarray(self.solve_ms),
                "iters": np.asarray(self.iters)}
        if xd is not None:
            data["x_des"] = xd
        np.savez(path, **data)
        return path

    def to_png(self, path: str | Path, title: str = "") -> Optional[Path]:
        """State/control/latency plot; returns None when matplotlib is
        unavailable (zero-egress images may lack it)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        t, x, u, xd = self.arrays()
        fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
        for i in range(x.shape[1]):
            axes[0].plot(t, x[:, i], label=f"x{i}")
            if xd is not None:
                axes[0].plot(t, xd[:, i], "--", alpha=0.5)
        axes[0].set_ylabel("state")
        axes[0].legend(loc="upper right", fontsize=7)
        for i in range(u.shape[1]):
            axes[1].step(t, u[:, i], where="post", label=f"u{i}")
        axes[1].set_ylabel("control")
        axes[1].legend(loc="upper right", fontsize=7)
        ms = np.asarray(self.solve_ms)
        axes[2].plot(t, ms)
        axes[2].set_ylabel("solve ms")
        axes[2].set_xlabel("t [s]")
        if title:
            fig.suptitle(title)
        path = Path(path)
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    def timing_report(self) -> dict:
        ms = np.asarray([m for m in self.solve_ms if np.isfinite(m)])
        if ms.size == 0:
            return {"solves": 0}
        return {
            "solves": int(ms.size),
            "mean_ms": float(ms.mean()),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()),
        }

    def save_report(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.timing_report(), indent=2))
        return path
