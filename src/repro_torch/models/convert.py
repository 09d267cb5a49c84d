"""Carry the JAX package's parameters over to the port.

:func:`from_jax_params` takes the tree that ``repro.models.init_params``
returns, with every leaf already a NumPy array (the caller maps
``np.asarray`` over it; nothing here imports JAX), and returns the
port's parameter tree: the period axis of each block leaf unstacked
into per-layer dictionaries, the expert order kept, each weight in
``dtype`` (the compute type by default) and the router and norm scales
in float32, on ``device`` (the card unless the caller asks for the CPU,
as ``init_params`` does).
"""
from __future__ import annotations

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig
from .model import (empty_params, keeps_float32, param_spec, period_pattern,
                    place)


def from_jax_params(cfg: ModelConfig, tree, device="cuda",
                    dtype: torch.dtype | None = None):
    dtype = dtype or L.compute_dtype(cfg)
    params = empty_params(cfg)
    n_pos = len(period_pattern(cfg))
    for path, lf in L.spec_items(param_spec(cfg)):
        arr = tree
        for key in path:
            arr = arr[key]
        arr = np.asarray(arr)
        if arr.shape != lf["shape"]:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the "
                             f"spec says {lf['shape']}")
        dt = torch.float32 if keeps_float32(path) else dtype
        stacked = path[0] == "blocks"
        for i in range(arr.shape[0] if stacked else 1):
            w = torch.from_numpy(np.array(arr[i] if stacked else arr,
                                          np.float32))
            place(params, path, w.to(device=device, dtype=dt), n_pos, i)
    return params
