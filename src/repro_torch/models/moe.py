"""Mixture-of-Experts layer with SWARM-driven expert placement.

The JAX package's ``models/moe.py`` in PyTorch.  Dispatch is sort-based
*within each batch row*: a row's top-k slots are sorted by expert id
(stably), packed into a capacity-bounded buffer, run through the expert
FFNs as one batched product per weight, and scattered back
gate-weighted; slots over capacity are dropped, the reference's drop
rule ``pos >= capacity`` included.  The buffer is laid out (E, B, C, D)
rather than the reference's (B, E, C, D), so that each expert's rows are
one contiguous (B·C, D) block for ``torch.bmm``; the values are the same.

``placement`` is an (E,) permutation, logical expert → physical slot
(SWARM-EP).  The expert-assignment histogram — SWARM's N′ collector,
feeding ``distributed/moe_placement.py`` — runs on kernel K5
(``kernels/moe_histogram``): its CUDA kernel for CUDA tensors, its plain
PyTorch version for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.moe_histogram import moe_histogram
from .config import ModelConfig, MoEConfig
from .layers import P, leaf, no_constraint


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    spec = {
        "router": leaf((d, e), (P.EMBED, P.EXPERT)),
        "w_gate": leaf((e, d, f), (P.EXPERT, P.EMBED, P.FF)),
        "w_up": leaf((e, d, f), (P.EXPERT, P.EMBED, P.FF)),
        "w_down": leaf((e, f, d), (P.EXPERT, P.FF, P.EMBED)),
    }
    if m.num_shared:
        fs = m.shared_ff
        spec["shared"] = {
            "w_gate": leaf((d, m.num_shared * fs), (P.EMBED, P.FF)),
            "w_up": leaf((d, m.num_shared * fs), (P.EMBED, P.FF)),
            "w_down": leaf((m.num_shared * fs, d), (P.FF, P.EMBED)),
        }
    return spec


def _capacity(m: MoEConfig, seq: int) -> int:
    cap = int(seq * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, min(cap, seq * m.top_k))


def _dispatch(flat_e, num_experts: int, capacity: int):
    """flat_e (B, S·K) expert id per slot → (row (B, S·K) of the slot in
    the (E·B·C) buffer with the reference's ``min(pos, C − 1)`` clamp,
    keep (B, S·K): the slot's position within its expert is under C)."""
    b, n = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)   # stable by expert
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(num_experts, device=flat_e.device)
    starts = torch.searchsorted(sorted_e,
                                experts.expand(b, -1).contiguous())
    ranks = torch.arange(n, device=flat_e.device).expand(b, -1)
    pos_sorted = ranks - torch.gather(starts, 1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < capacity
    batch = torch.arange(b, device=flat_e.device)[:, None]
    row = (flat_e * b + batch) * capacity + pos.clamp_max(capacity - 1)
    return row, keep


def _slots(x, flat_e, num_experts: int, capacity: int):
    """The expert buffer of ``x`` (B, S, D)'s top-k slots (``flat_e`` (B,
    S·K) expert ids): (expert_in (E, B·C, D), row, keep) — each slot's
    row in the (E·B·C) buffer and whether it was kept (:func:`_dispatch`).
    A dropped slot's row is a spare one, discarded: every dropped slot
    writes it (in an order of no account), nothing reads it, so the
    backward pass gives the dropped slots a zero gradient, as the
    reference's masked add does; each kept slot owns its row, so the
    store is a permutation and its backward a gather."""
    b, s, d = x.shape
    k = flat_e.shape[1] // s
    row, keep = _dispatch(flat_e, num_experts, capacity)
    spare = num_experts * b * capacity
    x_slots = x.repeat_interleave(k, dim=1)                 # (B, S·K, D)
    buf = x.new_zeros(spare + 1, d)
    buf[torch.where(keep, row, spare).reshape(-1)] = x_slots.reshape(-1, d)
    return buf[:spare].view(num_experts, b * capacity, d), row, keep


def _combine(expert_out, row, keep, gate):
    """(B, S, D): each token's kept slots' expert outputs, gate-weighted
    and summed; ``gate`` (B, S, K)."""
    b, s, k = gate.shape
    d = expert_out.shape[-1]
    slot_out = expert_out.reshape(-1, d)[row.reshape(-1)].view(b, s * k, d)
    slot_out = slot_out.masked_fill(~keep[..., None], 0)
    slot_out = slot_out * gate.to(slot_out.dtype).reshape(b, s * k, 1)
    return slot_out.view(b, s, k, d).sum(2)


def _by_rows(x):
    """The placements of a DTensor ``x`` that split its rows (dim 0) and
    nothing else: ``Shard(0)`` on the mesh axes that split the rows,
    when together they split them evenly; ``Replicate()`` elsewhere."""
    mesh = x.device_mesh
    axes = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    split = x.shape[0] % math.prod(mesh.size(i) for i in axes) == 0
    return tuple(Shard(0) if split and i in axes else Replicate()
                 for i in range(mesh.ndim))


def _on_rows(rows, fn, in_dims, out_dims, *args):
    """``fn(*args)`` on each rank's batch rows: each DTensor argument is
    split like ``rows`` (:func:`_by_rows`) along its batch dim,
    ``in_dims`` (dim 1 for the expert buffer, whose rows are (B·C)), and
    ``fn`` runs on the local shards — the MoE's dispatch is per batch
    row, and its sort and search have no DTensor rules.  ``out_dims``
    gives each output's batch dim."""
    def placed(dim):
        return tuple(Shard(dim) if p == Shard(0) else p for p in rows)
    return local_map(fn, out_placements=tuple(map(placed, out_dims)),
                     in_placements=tuple(map(placed, in_dims)),
                     redistribute_inputs=True)(*args)


def moe_ffn(p, x, cfg: ModelConfig, placement=None, constraint=None):
    """x (B, S, D) → (out (B, S, D), aux) — aux carries the router
    histogram (SWARM collector input, from K5) and the load-balancing
    loss.  On DTensors (a sharded run) the dispatch and the combine run
    on each rank's batch rows, and the expert products on the experts'
    shards."""
    cons = constraint or no_constraint
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    dtype = x.dtype
    logits = x.float() @ p["router"].float()              # (B, S, E)
    probs = torch.softmax(logits, -1)
    gate, idx = torch.topk(probs, k, dim=-1)              # (B, S, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    if placement is not None:  # logical → physical expert slots (SWARM-EP)
        idx = torch.as_tensor(placement, device=idx.device).long()[idx]

    capacity = _capacity(m, s)
    flat_e = idx.reshape(b, s * k)
    if isinstance(x, DTensor):
        rows = _by_rows(x)
        expert_in, row, keep = _on_rows(
            rows, functools.partial(_slots, num_experts=e, capacity=capacity),
            (0, 0), (1, 0, 0), x, flat_e)
    else:
        expert_in, row, keep = _slots(x, flat_e, e, capacity)
    expert_in = cons(expert_in, ("expert", "batch", None))
    g = torch.bmm(expert_in, p["w_gate"].to(dtype))
    u = torch.bmm(expert_in, p["w_up"].to(dtype))
    expert_out = torch.bmm(F.silu(g) * u, p["w_down"].to(dtype))
    expert_out = cons(expert_out, ("expert", "batch", None))
    if isinstance(x, DTensor):
        out = _on_rows(rows, _combine, (1, 0, 0, 0), (0,), expert_out, row,
                       keep, gate)
    else:
        out = _combine(expert_out, row, keep, gate)
    if m.num_shared:
        sp = p["shared"]
        gs = x @ sp["w_gate"].to(dtype)
        us = x @ sp["w_up"].to(dtype)
        out = out + (F.silu(gs) * us) @ sp["w_down"].to(dtype)
    # the reference's constraint on the routed output, placed after the
    # shared experts' product so that its partial sum is completed too
    out = cons(out, ("batch", None, "embed"))

    # SWARM collector (router histogram, K5) + Switch-style aux loss.  K5
    # carries no gradient and needs none: the reference's counts come
    # from a one-hot, whose gradient is zero; so its gates go in detached,
    # and its gate-weighted load, which nothing differentiable may read,
    # is dropped here
    counts, _ = moe_histogram(idx.reshape(-1, k).int(),
                              gate.detach().reshape(-1, k).contiguous(),
                              num_experts=e)
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    frac_probs = probs.mean((0, 1))
    aux_loss = e * torch.sum(frac_tokens * frac_probs)
    return out, {"expert_counts": counts, "aux_loss": aux_loss}
