"""Checkpointing on PyTorch, in the JAX package's layout.

Layout: ``<dir>/step_<NNNNNNNN>/{arrays.npz, manifest.json, COMMITTED}``,
the COMMITTED marker written last, so a half-written directory is never
restored.  Leaves are stored under ``params<keystr>`` and ``opt<keystr>``
where ``<keystr>`` is what ``jax.tree_util.keystr`` prints for the
reference's tree (``params['blocks']['pos0']['attn']['wq']``,
``opt['count']``): a model tree in the port's per-layer layout is
stacked over the periods first (``models.convert.to_jax_layout``), so a
checkpoint written by either package restores into the other.  The
manifest records step, config name, the writing mesh's axes and sizes
(``[[name, size], …]``, as the reference writes them; none without a
mesh), ``extra`` and the sorted keys.

``restore`` takes templates — meta tensors (``models.abstract_params``,
``train.abstract_opt_state``) or any tensors of the target shapes and
types — and returns tensors on the device the caller names, the card by
default, each leaf its own storage.  A model tree needs its ``cfg`` to
find the periods.

Sharded trees: ``save`` takes DTensor leaves and writes the whole
tensors (each gathered on every rank, a collective all ranks join; rank
0 writes), so a checkpoint does not depend on the mesh that wrote it.
Elastic restore: ``restore`` takes the *target* shardings
(``distributed.sharding.param_shardings``, ``train.opt_state_shardings``)
and places each leaf on its mesh, every rank keeping its own piece — a
checkpoint written on one device restores onto a 2×2 mesh, or any
other; no collective is needed.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import tree as T
from ..distributed.sharding import shard_params, whole
from ..launch.mesh import mesh_shape
from ..models.convert import to_jax_layout
from ..models.model import unstack


def _is_model(node) -> bool:
    return isinstance(node, dict) and isinstance(node.get("layers"), list)


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 has no NumPy type; "
                            "store float32 masters")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _reference_tree(node, cfg):
    """``node`` with every model tree in the reference's layout, each
    stacked leaf put together on the host."""
    if _is_model(node):
        if cfg is None:
            raise ValueError("checkpoint: a model tree needs its cfg")
        return to_jax_layout(cfg, node, device="cpu")
    if isinstance(node, dict):
        return {k: _reference_tree(v, cfg) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_reference_tree(v, cfg) for v in node)
    return node


def save(directory: str, step: int, *, params, opt_state=None, extra=None,
         mesh=None, config_name: str = "", cfg=None) -> str:
    out = os.path.join(directory, f"step_{step:08d}")
    arrays = {}
    for prefix, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        tree = _reference_tree(T.map(whole, tree), cfg)
        for path, leaf in T.items(tree):
            arrays[f"{prefix}{T.keystr(path)}"] = _numpy(leaf)
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        return out
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "arrays.npz"), **arrays)
    manifest = {
        "step": step, "config": config_name,
        "mesh": (list(map(list, mesh_shape(mesh).items())) if mesh
                 else None),
        "extra": extra or {},
        "keys": sorted(arrays.keys()),
    }
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # atomic publish marker (restart-safe: half-written dirs are ignored)
    open(os.path.join(out, "COMMITTED"), "w").close()
    return out


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")
             and os.path.exists(os.path.join(directory, d, "COMMITTED"))]
    return max(steps) if steps else None


def restore(directory: str, step: int, *, abstract_params,
            abstract_opt=None, param_shardings=None, opt_shardings=None,
            cfg=None, device="cuda"):
    """Returns (params, opt_state, manifest) on ``device``; a tree with
    its shardings given comes back as DTensors on their meshes."""
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(src, "arrays.npz"))

    def tensor(arr, like, where):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{where}: shape {arr.shape}, the template "
                             f"has {tuple(like.shape)}")
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=device, dtype=like.dtype, copy=True)

    def load(prefix, node, path=()):
        if _is_model(node):
            if cfg is None:
                raise ValueError("checkpoint: a model tree needs its cfg")
            key = prefix + T.keystr(path)
            return unstack(
                cfg, lambda p: data[key + T.keystr(p)],
                lambda p, arr, layer: tensor(
                    arr, _leaf(node, p, layer), key + T.keystr(p)))
        if isinstance(node, dict):
            return {k: load(prefix, v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(load(prefix, v, path + (i,))
                              for i, v in enumerate(node))
        key = prefix + T.keystr(path)
        return tensor(data[key], node, key)

    params = load("params", abstract_params)
    if param_shardings is not None:
        params = shard_params(params, param_shardings, copy=True)
    opt = load("opt", abstract_opt) if abstract_opt is not None else None
    if opt is not None and opt_shardings is not None:
        opt = shard_params(opt, opt_shardings, copy=True)
    return params, opt, manifest


def _leaf(model, path, layer):
    """The port's leaf of a spec ``path`` (of ``layer`` for a block
    leaf) in a model tree."""
    node = model if layer is None else model["layers"][layer]
    for key in (path if layer is None else path[2:]):
        node = node[key]
    return node
