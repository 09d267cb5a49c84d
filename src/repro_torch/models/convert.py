"""Carry parameters between the JAX package's layout and the port's.

The JAX package stacks each block leaf over the periods under
``blocks/pos<j>/…`` (shape (periods, …)); the port keeps one dictionary
per layer (``layers[i]``, layer i = period · period length + j).

- :func:`from_jax_params` takes the tree that ``repro.models.init_params``
  returns, with every leaf already a NumPy array (the caller maps
  ``np.asarray`` over it; nothing here imports JAX), and returns the
  port's parameter tree: each weight in ``dtype`` (the compute type by
  default) and the router and norm scales in float32, on ``device``
  (the card unless the caller asks for the CPU, as ``init_params``
  does).
- :func:`to_jax_layout` and :func:`from_jax_layout` map a tree of
  tensors from the port's layout to the reference's and back, values
  and types untouched: the checkpoint layer and the optimizer-state
  tests use them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig
from .model import (keeps_float32, num_periods, param_spec, period_pattern,
                    unstack)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def from_jax_params(cfg: ModelConfig, tree, device="cuda",
                    dtype: torch.dtype | None = None):
    dtype = dtype or L.compute_dtype(cfg)

    def convert(path, arr, _):
        dt = torch.float32 if keeps_float32(path) else dtype
        w = torch.from_numpy(np.array(arr, np.float32))
        return w.to(device=device, dtype=dt)

    return unstack(cfg, lambda path: np.asarray(_get(tree, path)), convert)


def _to(t, device):
    return t if device is None else t.to(device)


def to_jax_layout(cfg: ModelConfig, params, device=None):
    """The reference's tree of the port's ``params``: each block leaf
    stacked over the periods (moved to ``device`` first, if named)."""
    n_pos, n_per = len(period_pattern(cfg)), num_periods(cfg)
    out: dict = {}
    for path, _ in L.spec_items(param_spec(cfg)):
        if path[0] == "blocks":
            j = int(path[1][3:])
            value = torch.stack([
                _to(_get(params["layers"][p * n_pos + j], path[2:]), device)
                for p in range(n_per)])
        else:
            value = _to(_get(params, path), device)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def from_jax_layout(cfg: ModelConfig, tree):
    """The inverse of :func:`to_jax_layout`: the port's tree, each layer's
    leaf a view of its period's slice."""
    return unstack(cfg, lambda path: _get(tree, path),
                   lambda path, value, layer: value)
