"""Train step on PyTorch: loss → gradient → AdamW, with activation
checkpointing (a remat policy per block) and optional microbatch
gradient accumulation — the JAX package's ``train/train_step.py``.

The gradient is ``torch.autograd.grad`` of the loss with respect to the
float32 masters (the twin of ``jax.value_and_grad``); the optimizer step
runs under ``torch.no_grad()`` and updates the masters in place.  With
microbatches the gradients are summed over ``microbatches`` slices of
the batch and divided, with the loss, by their number; expert counts
are summed, as the reference's ``lax.scan`` sums them.  Microbatch i
holds rows i, i + m, i + 2m, … of the batch (m microbatches) where the
reference takes m consecutive blocks: a data shard's rows then stay on
it, and the sums are the same (each row's loss and dispatch are its
own).  A sharded run passes ``constraint``
(``distributed.sharding.make_constraint``) and DTensor trees.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.parallel import loss_parallel

from .. import tree as T
from ..models import model as MODEL
from ..models.config import ModelConfig
from ..models.model import REMAT_POLICIES
from .optimizer import AdamWConfig, adamw_update

__all__ = ["REMAT_POLICIES", "make_loss_fn", "make_grad_fn",
           "make_train_step", "make_eval_step"]


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
            for i in range(microbatches):
                mb = {k: v.reshape(v.shape[0] // microbatches, microbatches,
                                   *v.shape[1:])[:, i]
                      for k, v in batch.items()}
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
