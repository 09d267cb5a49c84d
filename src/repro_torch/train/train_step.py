"""Train step on PyTorch: loss → gradient → AdamW, with activation
checkpointing (a remat policy per block) and optional microbatch
gradient accumulation — the JAX package's ``train/train_step.py``.

The gradient is ``torch.autograd.grad`` of the loss with respect to the
float32 masters (the twin of ``jax.value_and_grad``); the optimizer step
runs under ``torch.no_grad()`` and updates the masters in place.  With
microbatches the gradients are summed over ``microbatches`` slices of
the batch and divided, with the loss, by their number; expert counts
are summed, as the reference's ``lax.scan`` sums them.  Microbatch i
is the reference's block i, rows [i·B/m, (i+1)·B/m) of the batch (m
microbatches): the split matters, since an MoE's load-balancing loss is
a product of two means over the microbatch's rows.  A sharded run
passes ``constraint`` (``distributed.sharding.make_constraint``) and
DTensor trees; a DTensor batch is gathered whole once a step and each
block placed as the batch was (:func:`microbatches_of`), so that block i
is split over the data ranks like the batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.parallel import loss_parallel

from .. import tree as T
from ..models import model as MODEL
from ..models.config import ModelConfig
from ..models.model import REMAT_POLICIES
from .optimizer import AdamWConfig, adamw_update

__all__ = ["REMAT_POLICIES", "make_loss_fn", "make_grad_fn",
           "make_train_step", "make_eval_step", "microbatches_of"]


def microbatches_of(batch: dict, m: int) -> list[dict]:
    """The reference's split of ``batch`` into ``m`` microbatches:
    block i holds rows [i·B/m, (i+1)·B/m) of every entry.  A DTensor
    entry is gathered whole (its rows are a few int32 tokens a row) and
    each block redistributed to the entry's placements, which splits it
    over the data ranks as the batch was split."""
    def blocks(v):
        n = v.shape[0] // m
        if not isinstance(v, DTensor):
            return [v[i * n:(i + 1) * n] for i in range(m)]
        mesh, placements = v.device_mesh, v.placements
        full = v.redistribute(mesh, (Replicate(),) * mesh.ndim)
        return [full[i * n:(i + 1) * n].redistribute(mesh, placements)
                for i in range(m)]

    split = {k: blocks(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(m)]


def make_loss_fn(cfg: ModelConfig, remat: str = "dots_no_batch",
                 constraint=None):
    """remat is applied to each block inside the model (the placement
    that actually bounds per-layer residual memory)."""
    def loss(params, batch, placement=None):
        return MODEL.loss_fn(params, cfg, batch, placement=placement,
                             constraint=constraint, remat=remat)

    return loss


def make_grad_fn(cfg: ModelConfig, remat: str = "dots_no_batch",
                 constraint=None):
    """Returns grad_fn(params, batch[, placement]) → ((loss, aux), grads),
    ``grads`` a tree of ``params``' structure: the twin of
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  The parameters
    require grad only inside the call."""
    loss_fn = make_loss_fn(cfg, remat, constraint)

    def grad_fn(params, batch, placement=None):
        leaves = T.leaves(params)
        sharded = isinstance(leaves[0], DTensor)
        with torch.enable_grad(), (loss_parallel() if sharded
                                   else contextlib.nullcontext()):
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss, aux = loss_fn(params, batch, placement)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        aux = {k: v.detach() for k, v in aux.items()}
        return (loss.detach(), aux), T.unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "dots_no_batch", microbatches: int = 1,
                    constraint=None):
    """Returns train_step(params, opt_state, batch[, placement]) →
    (params, opt_state, metrics).  ``params`` and ``opt_state`` are
    updated in place, as the reference's launcher donates both trees to
    its jitted step: a caller that reads them again passes copies."""
    grad_fn = make_grad_fn(cfg, remat, constraint)

    def step(params, opt_state, batch, placement=None):
        if microbatches == 1:
            (loss, aux), grads = grad_fn(params, batch, placement)
        else:
            n_exp = cfg.moe.num_experts if cfg.moe else 1
            grads = None
            loss = torch.zeros((), device=T.leaves(params)[0].device)
            counts = torch.zeros((n_exp,), device=loss.device)
            for mb in microbatches_of(batch, microbatches):
                (l_i, aux_i), g = grad_fn(params, mb, placement)
                grads = g if grads is None else T.map(torch.add, grads, g)
                loss = loss + l_i
                counts = counts + aux_i["expert_counts"]
            grads = T.map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            aux = {"expert_counts": counts}
        new_params, new_opt, om = adamw_update(opt_cfg, params, grads,
                                               opt_state)
        metrics = {"loss": loss, **om,
                   "expert_counts": aux.get(
                       "expert_counts",
                       torch.zeros((1,), device=loss.device))}
        return new_params, new_opt, metrics

    return step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch, placement=None):
        loss, _ = MODEL.loss_fn(params, cfg, batch, placement=placement)
        return {"loss": loss}
    return eval_step
