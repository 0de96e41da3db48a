"""Carry parameters and service state between the JAX package and this one.

Both packages' ``MPCParams`` (and ``LinPoint``) are NamedTuples with the
same fields in the same order, so conversion goes by position: a JAX
``MPCParams`` whose leaves are numpy arrays (``jax.tree.map(np.asarray,
p)``, or the ``"params"`` entry of the JAX ``BatchModelControl.state_dict``)
becomes tensors here, and ``params_to_numpy`` goes back the other way.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .transcribe.shooting import LinPoint, MPCParams, check_device


def params_from_numpy(mp, device="cuda", dtype=torch.float32) -> MPCParams:
    """Any MPCParams-shaped tuple of array-likes -> this package's
    ``MPCParams`` of tensors on ``device`` in ``dtype`` (the card unless
    the caller asks for another device; raises when there is none)."""
    check_device(device, "params_from_numpy")
    if len(mp) != len(MPCParams._fields):
        raise ValueError(f"expected {len(MPCParams._fields)} MPCParams "
                         f"fields, got {len(mp)}")
    conv = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    fields = list(mp)
    lin_i = MPCParams._fields.index("lin")
    fields[lin_i] = LinPoint(*[conv(a) for a in fields[lin_i]])
    return MPCParams(*[f if i == lin_i else conv(f)
                       for i, f in enumerate(fields)])


def params_to_numpy(p: MPCParams) -> MPCParams:
    """``MPCParams`` of tensors -> the same NamedTuple of numpy arrays."""
    conv = lambda t: t.detach().cpu().numpy()
    return MPCParams(*[LinPoint(*[conv(a) for a in f])
                       if isinstance(f, LinPoint) else conv(f) for f in p])
