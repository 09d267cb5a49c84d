"""Logical-axis → mesh-axis sharding rules, on DTensor.

The JAX package's ``distributed/sharding.py``.  Weights carry logical
axis names in their param spec (``models.layers.P``); activations are
annotated through the ``constraint`` callback threaded through every
layer.  One rules table maps both onto the mesh, so changing the
parallelism layout is a table edit, not a model edit.

Default layout (single-pod 16×16 / multi-pod 2×16×16):
  batch                →  ("pod", "data")     (DP across pods and data axis)
  heads / ff / expert  →  "model"             (TP / EP)
  vocab                →  "model"             (sharded embedding + lm head)
  layers / head_dim    →  replicated
Optimizer state can additionally shard its vocab/ff dims over "data"
(ZeRO-1) — see train/optimizer.py.

A partition spec is a tuple with one entry per dimension — None, a mesh
axis name, or a tuple of names (the twin of ``PartitionSpec``), and
:class:`NamedSharding` pairs it with a mesh.  :func:`placements` turns a
spec into DTensor placements: ``Shard(i)`` on every mesh axis that
dimension i maps to, ``Replicate()`` on the others.  The meshes here are
``torch.distributed`` ``DeviceMesh``es; every function that only reads
axis names and sizes also takes a stand-in (``launch.mesh.mesh_shape``).

The port's parameter tree is per layer (``params["layers"][i]``), where
the reference's spec stacks each block leaf over the periods under
``blocks/pos<j>`` with a leading ``layers`` dimension.  The sharding
trees built here have the port's structure: a block leaf's sharding is
the stacked leaf's spec without its leading entry.  The logical rules
never shard that entry (``layers`` maps to no mesh axis and the
fallbacks skip it); the ZeRO rules may give it "data", which a
per-layer tensor cannot hold, so that leaf stays whole over "data".
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..launch.mesh import axis_names, mesh_shape
from ..models import layers as L
from ..models.model import param_spec, period_pattern, place

# logical → mesh axes (None = replicate).  Entries may be tuples.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "expert": "model",
    "heads": "heads_or_model",   # resolved to "model"
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "embed": None,
    "head_dim": None,
    "layers": None,
    None: None,
}


def resolve_rules(mesh, rules: dict | None = None) -> dict:
    rules = dict(rules or DEFAULT_RULES)
    rules["heads"] = "model"
    names = axis_names(mesh)

    # drop axes the mesh does not have (e.g. "pod" on a single pod)
    def fix(v):
        if v is None:
            return None
        axes = v if isinstance(v, tuple) else (v,)
        keep = tuple(a for a in axes if a in names)
        return keep if len(keep) > 1 else (keep[0] if keep else None)
    return {k: fix(v) for k, v in rules.items()}


def _divisible(dim: int, mesh, axes) -> bool:
    if axes is None:
        return False
    names = axes if isinstance(axes, tuple) else (axes,)
    shape = mesh_shape(mesh)
    size = math.prod(shape[a] for a in names)
    return dim % size == 0 and dim >= size


def _logical_spec(shape, logical_axes, mesh, rules) -> list:
    """Each dimension's mesh axes by ``rules``, dropping axes that do not
    divide it and never mapping one mesh axis twice."""
    used: set = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        target = rules.get(logical)
        names = (target if isinstance(target, tuple)
                 else ((target,) if target else ()))
        names = tuple(n for n in names if n not in used)
        if names and _divisible(dim, mesh, names):
            used.update(names)
            out.append(names if len(names) > 1 else names[0])
        else:
            out.append(None)
    return out


def spec_to_pspec(leaf_spec, mesh, rules: dict) -> tuple:
    """Partition spec for one weight leaf, dropping non-divisible axes
    and never mapping one mesh axis twice.

    Fallback: when the preferred logical axis is not divisible by the
    "model" axis (e.g. starcoder2's 36 heads or qwen's 60 experts on a
    16-way TP axis), the largest divisible remaining dim is TP-sharded
    instead — big weights never end up replicated."""
    out = _logical_spec(leaf_spec["shape"], leaf_spec["axes"], mesh, rules)
    used = {a for entry in out if entry is not None
            for a in (entry if isinstance(entry, tuple) else (entry,))}
    if "model" not in used and len(leaf_spec["shape"]) >= 2:
        # skip the stacked-layers leading dim (axes[0] == "layers")
        cand = [(dim, i) for i, (dim, lg) in enumerate(
                    zip(leaf_spec["shape"], leaf_spec["axes"]))
                if out[i] is None and lg != "layers"
                and _divisible(dim, mesh, "model")]
        if cand:
            _, i = max(cand)
            out[i] = "model"
    return tuple(out)


def placements(pspec, mesh) -> tuple:
    """DTensor placements of a partition spec: for each mesh axis, in
    the mesh's order, ``Shard(i)`` if dimension i maps to it, else
    ``Replicate()``.  A dimension mapped to several axes is split by
    each of them in mesh-axis order, the major axis first, as a
    ``PartitionSpec`` entry ``("pod", "data")`` is."""
    from torch.distributed.tensor import Replicate, Shard
    out = {}
    for i, entry in enumerate(pspec):
        for axis in (entry if isinstance(entry, tuple)
                     else (() if entry is None else (entry,))):
            if axis in out:
                raise ValueError(f"{pspec}: mesh axis {axis!r} used twice")
            out[axis] = Shard(i)
    names = axis_names(mesh)
    unknown = set(out) - set(names)
    if unknown:
        raise ValueError(f"{pspec}: mesh has no axis {sorted(unknown)}")
    return tuple(out.get(a, Replicate()) for a in names)


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``).
    ``stacked`` is, for one layer's leaf of a block, the periods the
    reference stacks that leaf over (0 for any other tensor): the ZeRO
    rules choose their dimension on the stacked shape, as the reference
    does, so that the port's per-layer specs are the reference's
    without the leading entry."""
    mesh: object
    spec: tuple = ()
    stacked: int = 0

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _port_tree(cfg, one):
    """The port's parameter-tree structure holding ``one(path, lf)`` for
    every spec leaf: a block leaf's value (computed on the stacked leaf)
    without its leading ``layers`` entry, at each of its layers.  Where
    a ZeRO rule gave that entry the "data" axis (the reference stacks a
    small leaf over more periods than its other dims are long), the
    port's per-layer tensors stay whole over "data"."""
    out = {"layers": [{} for _ in range(cfg.num_layers)]}
    n_pos = len(period_pattern(cfg))
    for path, lf in L.spec_items(param_spec(cfg)):
        sh = one(path, lf)
        if path[0] != "blocks":
            place(out, path, sh)
            continue
        per_layer = NamedSharding(sh.mesh, sh.spec[1:], lf["shape"][0])
        for i in range(lf["shape"][0]):
            place(out, path, per_layer, n_pos, i)
    return out


def stacked_param_shardings(cfg, mesh, rules: dict | None = None,
                            zero3: bool = False) -> dict:
    """spec path → NamedSharding of the reference's stacked leaves
    (``param_shardings`` of the JAX package, flattened)."""
    rules = resolve_rules(mesh, rules)
    shape = mesh_shape(mesh)

    def one(lf):
        ps = spec_to_pspec(lf, mesh, rules)
        if zero3 and "data" in shape:
            spec = list(ps) + [None] * (len(lf["shape"]) - len(ps))
            dsize = shape["data"]
            cand = [(dim, i) for i, (dim, sp) in
                    enumerate(zip(lf["shape"], spec))
                    if sp is None and dim % dsize == 0 and dim >= dsize]
            if cand:
                _, i = max(cand)
                spec[i] = "data"
                ps = tuple(spec)
        return NamedSharding(mesh, ps)

    return {path: one(lf) for path, lf in L.spec_items(param_spec(cfg))}


def param_shardings(cfg, mesh, rules: dict | None = None,
                    zero3: bool = False):
    """NamedSharding tree matching the port's parameter tree
    (``models.abstract_params(cfg)``).

    zero3=True additionally shards each master weight's largest
    still-replicated dim over "data" (ZeRO-3 for the fp32 masters): the
    per-device param/grad footprint drops by the DP degree and the
    optimizer update runs fully sharded."""
    flat = stacked_param_shardings(cfg, mesh, rules, zero3)
    return _port_tree(cfg, lambda path, lf: flat[path])


DP_RULES = {
    # pure data parallelism, weights REPLICATED (the right layout when
    # the model is small relative to the device count: grad all-reduce
    # ≪ TP activation collectives)
    "batch": ("pod", "data", "model"),
    "expert": None, "heads": None, "kv_heads": None, "ff": None,
    "vocab": None, "embed": None, "head_dim": None, "layers": None,
    None: None,
}


def param_shardings_replicated(cfg, mesh):
    return _port_tree(cfg, lambda path, lf: NamedSharding(mesh, ()))


FSDP_RULES = {
    # pure data parallelism over the whole device grid; weights fully
    # sharded (gathered in bf16 per use).  Right layout when activation
    # volume ≫ weight volume (small models, big batches).
    "batch": ("pod", "data", "model"),
    "expert": None, "heads": None, "kv_heads": None, "ff": None,
    "vocab": None, "embed": None, "head_dim": None, "layers": None,
    None: None,
}


def _fsdp_one(lf, mesh) -> NamedSharding:
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("data", "model") if a in shape)
    size = math.prod(shape[a] for a in axes)
    spec = [None] * len(lf["shape"])
    cand = [(dim, i) for i, (dim, lg) in
            enumerate(zip(lf["shape"], lf["axes"])) if lg != "layers"]
    # prefer a dim divisible by the full axis product, else by "data"
    for need, ax in ((size, axes), (shape.get("data", 1), ("data",))):
        ok = [(d, i) for d, i in cand if d % need == 0 and d >= need]
        if ok:
            _, i = max(ok)
            spec[i] = ax if len(ax) > 1 else ax[0]
            return NamedSharding(mesh, tuple(spec))
    return NamedSharding(mesh, ())


def param_shardings_fsdp(cfg, mesh):
    """Every weight's largest divisible dim sharded over all mesh axes."""
    return _port_tree(cfg, lambda path, lf: _fsdp_one(lf, mesh))


def make_constraint(mesh, rules: dict | None = None):
    """Activation-annotation callback: constraint(x, logical_axes).  A
    DTensor is redistributed to the rules' placements (the twin of
    ``with_sharding_constraint``); a plain tensor is returned
    unchanged."""
    from torch.distributed.tensor import DTensor
    rules = resolve_rules(mesh, rules)

    def constraint(x, logical_axes):
        if not isinstance(x, DTensor):
            return x
        want = placements(_logical_spec(x.shape, logical_axes, mesh, rules),
                          mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(mesh, want)

    return constraint


def batch_sharding(mesh, ndim: int, rules: dict | None = None):
    """Sharding for input batches: dim0 = batch over (pod, data)."""
    rules = resolve_rules(mesh, rules)
    return NamedSharding(mesh, (rules["batch"],) + (None,) * (ndim - 1))


def replicated(mesh):
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------

def local_shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` under ``sharding``: a
    view, split by ``torch.chunk`` per mesh axis in mesh-axis order, as
    DTensor splits."""
    from torch.distributed.tensor import Shard
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    for axis, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(axis), dim=pl.dim)[coord[axis]]
    return t


def shard_tensor(t: torch.Tensor, sharding: NamedSharding, *,
                 copy: bool = False):
    """``t`` (the whole tensor, on every rank) as a DTensor with
    ``sharding``: each rank keeps its piece (:func:`local_shard`), no
    collective.  The piece is a view of ``t`` unless ``copy``, which
    gives it storage of its own (so that ``t`` can be freed)."""
    from torch.distributed.tensor import DTensor
    local = local_shard(t, sharding)
    return DTensor.from_local(local.clone() if copy else local,
                              sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def whole(t):
    """A DTensor's whole tensor on every rank (a collective all ranks
    join); anything else as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def map_placed(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree and its sharding tree; entries
    without a sharding are kept."""
    if isinstance(tree, dict):
        return {k: map_placed(fn, v, shardings[k]) if k in shardings else v
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_placed(fn, v, s)
                          for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def shard_params(params, shardings, *, copy: bool = False):
    """A port parameter tree (``init_params``, ``from_jax_params``,
    ``checkpoint.restore``) placed on a mesh: each leaf the DTensor of
    its sharding (:func:`shard_tensor`).  Other trees of tensors go the
    same way with a sharding tree of their structure — an optimizer
    state (``train.opt_state_shardings``), a cache
    (``serve.engine.cache_shardings``; entries without a sharding, the
    cache's offset, are kept as they are).  ``copy`` as in
    :func:`shard_tensor`."""
    return map_placed(lambda t, sh: shard_tensor(t, sh, copy=copy), params,
                      shardings)
