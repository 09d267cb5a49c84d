"""AdamW on PyTorch — the JAX package's ``train/optimizer.py`` on trees
of float32 tensors (the port's per-layer parameter dictionaries).

The optimizer state mirrors the parameter tree: {m, v, count}, ``count``
a 0-d int32 tensor.  One update: a global gradient norm in float32,
clipping to ``grad_clip``, warm-up then cosine decay of the rate, bias
correction, and weight decay decoupled from the gradient on every leaf,
as the reference applies it.  ``adamw_update`` works in place under
``torch.no_grad()``: the parameters and the m and v buffers given are
updated and returned (the reference's launcher donates them the same
way).  With a mesh, :func:`opt_state_shardings` gives m and v the
parameters' shardings and, ZeRO-1, additionally shards each one's
largest replicated dimension over the "data" axis — the distributed-
optimizer trick that cuts optimizer memory per device by the DP degree.
The update is elementwise on DTensors: DTensor moves each gradient to
its buffer's placement (a reduce-scatter where the gradient is still a
partial sum) and the step back to the parameter's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import tree as T
from ..distributed.sharding import NamedSharding
from ..launch.mesh import mesh_shape


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_opt_state(params):
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = T.leaves(params)[0].device
    return {"m": T.map(zeros, params), "v": T.map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_opt_state(abstract_params):
    def meta(p):
        return torch.empty(p.shape, dtype=p.dtype, device="meta")
    return {"m": T.map(meta, abstract_params),
            "v": T.map(meta, abstract_params),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def _schedule(cfg: AdamWConfig, count):
    """The rate at step ``count`` (a float32 tensor)."""
    warm = torch.clamp(count / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((count - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step: returns (params, state, {grad_norm, lr}) with the
    parameters and the m and v buffers updated in place."""
    count = state["count"] + 1
    leaves = T.leaves(grads)
    gnorm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in leaves]))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step_no = count.float()
    lr = _schedule(cfg, step_no)
    bc1 = 1 - cfg.b1 ** step_no
    bc2 = 1 - cfg.b2 ** step_no
    for p, g, m, v in zip(T.leaves(params), leaves, T.leaves(state["m"]),
                          T.leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        step = (m / bc1) / ((v / bc2).sqrt() + cfg.eps) \
            + cfg.weight_decay * p
        p.sub_((lr * step).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "count": count}, {
        "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 shardings: shard m/v's largest replicated dim over "data".
# ---------------------------------------------------------------------------

def opt_state_shardings(abstract_params, param_shardings_tree, mesh, *,
                        zero1: bool = True):
    """{m, v, count} shardings for the optimizer state of parameters
    ``abstract_params`` placed by ``param_shardings_tree``
    (``distributed.sharding.param_shardings``).  The dimension is chosen
    on the reference's stacked shape of a block leaf (a sharding's
    ``stacked``); where that is the stacked periods axis, which a
    per-layer tensor does not have, the leaf keeps its parameter's
    sharding."""
    shape = mesh_shape(mesh)
    data_axis = "data" if "data" in shape else None
    dsize = shape.get("data", 1)

    def zero_shard(aval, ns: NamedSharding):
        if not zero1 or data_axis is None:
            return ns
        lead = (ns.stacked,) if ns.stacked else ()
        dims = lead + tuple(aval.shape)
        spec = ([None] * len(lead) + list(ns.spec)
                + [None] * (len(aval.shape) - len(ns.spec)))
        # shard the largest still-replicated, divisible dim over "data"
        cand = [(dims[i], i) for i, s in enumerate(spec)
                if s is None and dims[i] % dsize == 0 and dims[i] >= dsize]
        if not cand:
            return ns
        _, i = max(cand)
        if i < len(lead):
            return ns
        spec[i] = data_axis
        return NamedSharding(mesh, tuple(spec[len(lead):]), ns.stacked)

    mv = T.map(zero_shard, abstract_params, param_shardings_tree)
    return {"m": mv, "v": mv, "count": NamedSharding(mesh, ())}
