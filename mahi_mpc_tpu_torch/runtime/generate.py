"""Offline model generation: build -> persist (port of
``mahi_mpc_tpu/runtime/generate.py``).

The reference's ``ModelGenerator`` (``src/Mahi/Mpc/ModelGenerator.cpp:
23-270``) builds a CasADi NLP, compiles its C with gcc into ``<name>.so``
and writes ``<name>.json``; the JAX package writes serialized StableHLO
(``<name>.mpcx``) instead.  A ``.mpcx`` means nothing to PyTorch, so this
package's artifact is:

- ``<name>.json``, the same schema as both (``ModelParameters.save``);
- ``<name>_torch.json``, a manifest of the ``SolverOptions`` the model was
  generated for and of the CUDA libraries its solves launch;
- the build of those libraries, which generation makes on the card (the
  reference compiled its ``.so`` at generation time) into the hash-named
  cache of ``_build.py``, where ``ModelControl`` loads it without
  rebuilding.  For a user's own ``Dynamics`` (no hand-written
  instantiation) that library is generated: its model emitted as C++ from
  the traced ``f`` (``models/codegen.py``) and compiled by nvcc here, as
  the reference's gcc compiled the C that CasADi generated.

``ModelControl`` reads the manifest's options only when it is given none:
the options passed at load time decide the warm solver, so an artifact
generated for other options never switches the warm-solve semantics.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import torch

from ..models.base import Dynamics, make_dynamics
from ..params import ModelParameters, SolverOptions
from ..solver.select import resolve_warm_solver
from ..solver.target import kernel_target, model_kernel
from ..transcribe.shooting import ShootingProblem, make_problem

MANIFEST_SUFFIX = "_torch.json"
MANIFEST_FORMAT = 1


def kernel_libraries(prob: ShootingProblem, opts: SolverOptions,
                     device) -> list:
    """The CUDA libraries that a ``ModelControl`` of this problem launches
    under ``opts`` on ``device``: the fused kernel's instantiation when warm
    solves resolve to it (one of ``_build.CUDA_LIBRARIES``, or the
    problem's generated library, ``gen-<hash>``: ``kernel_target``), in
    LTV the library of the model's linearization kernel
    (``model_kernel``), the Riccati kernel when ``kkt_backend="pallas"``
    asks for it; none off the card."""
    if torch.device(device).type != "cuda":
        return []
    libs = []
    if resolve_warm_solver(opts, prob, device) == "fused":
        libs.append(kernel_target(prob).cuda)
    relin = model_kernel(prob.dynamics) if prob.is_linear else None
    if relin is not None and relin.library not in libs:
        libs.append(relin.library)
    if opts.kkt_backend == "pallas":
        libs.append("riccati")
    return libs


def manifest_path(name: str, directory: str | Path = ".") -> Path:
    return Path(directory) / f"{name}{MANIFEST_SUFFIX}"


def read_manifest(name: str, directory: str | Path = ".") -> Optional[dict]:
    """The manifest ``generate_model`` wrote for ``name``, or None when the
    directory holds none (a directory the JAX package generated)."""
    path = manifest_path(name, directory)
    if not path.is_file():
        return None
    with open(path) as f:
        man = json.load(f)
    if man.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path}: manifest format {man.get('format')!r}, "
                         f"this package reads {MANIFEST_FORMAT}")
    man["solver_options"] = SolverOptions(**man["solver_options"])
    return man


class ModelGenerator:
    """Builds what the solves of one problem configuration need and
    persists it: ``create_model`` -> ``compile_model`` (the kernel build
    and the files), as the reference's ``create_model`` ->
    ``generate_c_code`` + ``compile_model`` (``ModelGenerator.hpp:23-29``).
    Runs on the CUDA card unless ``device`` says otherwise; off the card
    there is nothing to build."""

    def __init__(self, params: ModelParameters,
                 dynamics: Optional[Dynamics] = None,
                 opts: SolverOptions = SolverOptions(), device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelGenerator builds the CUDA kernels on a CUDA device by "
                "default and none is available; pass device=\"cpu\" to "
                "generate for the CPU")
        if dynamics is None:
            if not params.dynamics_name:
                raise ValueError(
                    "either pass a Dynamics or set params.dynamics_name")
            dynamics = make_dynamics(params.dynamics_name,
                                     **params.dynamics_kwargs)
        self.params = params
        self.dynamics = dynamics
        self.opts = opts
        self.device = device
        self.problem: Optional[ShootingProblem] = None

    def create_model(self) -> ShootingProblem:
        """The problem (the reference's NLP, ``ModelGenerator.cpp:23-232``)."""
        self.problem = make_problem(self.params, self.dynamics)
        return self.problem

    def compile_model(self, directory: str | Path = ".") -> Path:
        """Build the CUDA libraries the model's solves launch, then write
        ``<name>.json`` and the manifest; returns the manifest's path."""
        if self.problem is None:
            self.create_model()
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        libs = kernel_libraries(self.problem, self.opts, self.device)
        built = {}
        if libs:
            from .._build import cuda_build
            for name in libs:
                lib = cuda_build(name)[0]
                built[name] = lib._name
        # No .mpcx is written, so no path to one is recorded either.
        self.params = dataclasses.replace(self.params, dll_filepath="")
        self.save_param_file(directory)
        path = manifest_path(self.params.name, directory)
        with open(path, "w") as f:
            json.dump({"format": MANIFEST_FORMAT, "model": self.params.name,
                       "solver_options": dataclasses.asdict(self.opts),
                       "device": self.device.type,
                       "warm_solver": resolve_warm_solver(
                           self.opts, self.problem, self.device),
                       "libraries": built}, f, indent=2)
        return path

    def save_param_file(self, directory: str | Path = ".") -> Path:
        """``<name>.json`` (``ModelGenerator.cpp:261-270``)."""
        return self.params.save(directory)


def generate_model(params: ModelParameters,
                   dynamics: Optional[Dynamics] = None,
                   directory: str | Path = ".",
                   opts: SolverOptions = SolverOptions(),
                   device="cuda") -> Path:
    """One-call generate -> build -> save (the ``model_generate`` example
    flow, ``examples/ex_model_generate.cpp:8-73``); returns the manifest's
    path."""
    gen = ModelGenerator(params, dynamics, opts, device)
    gen.create_model()
    return gen.compile_model(directory)
