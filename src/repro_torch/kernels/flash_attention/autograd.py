"""K6 under autograd: the hand-written forward, the reference's gradient.

:class:`FlashAttentionFn` is what :func:`ops.flash_attention` returns
through when autograd records (grad enabled and any of q, k, v
requiring grad).  Its forward is the op ``repro_torch::flash_attention``
— the CUDA kernel on the card (an unbuilt head dim zero-padded), the
plain version on the CPU — exactly as the grad-free call runs it, and
it saves q, k and v alone — never a score matrix.  Its backward
recomputes attention through the model's twin of the reference's XLA
attention, ``models.layers._sdpa_direct`` / ``_sdpa_chunked``
(:func:`models.layers.sdpa_grad`), and differentiates that: the JAX
package has no backward kernel and trains through XLA's gradient of
the same functions.  ``ref.attention_ref`` is not the recompute; it
stays the plain version the CPU and the tests use.  On DTensors (a
sharded run) the backward runs on each rank's shards (``local_map``),
split as the forward op's sharding rules split them.

The forward and the backward therefore come from different code: the
gradient is that of the recompute, which agrees with the kernel's
output within K6's stated tolerance (float32 2e-5; bfloat16 3e-2 and
two bf16 steps per element), not bit for bit.
"""
import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, q_offset, forward)``: q (B, H,
    S, D), k and v (B, Hkv, Skv, D) → (B, H, S, D).  ``forward`` computes
    the output from (q, k, v) and the three options by keyword: the
    kernel path on the card; a test may inject the plain version to run
    the backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, forward):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)
        return forward(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        grads = functools.partial(_grads, **ctx.opts)
        if isinstance(q, DTensor):
            grads = _local_grads(grads, q, k)
        return (*grads(q, k, v, grad), None, None, None, None)


def _grads(q, k, v, grad, **opts):
    """(dq, dk, dv) in K6's (B, H, S, D) layout by ``sdpa_grad``."""
    from ...models.layers import sdpa_grad   # models import K6
    dq, dk, dv = sdpa_grad(*(t.transpose(1, 2) for t in (q, k, v, grad)),
                           **opts)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _local_grads(grads, q, k):
    """``grads`` on each rank's shards of DTensor inputs, placed by the
    forward op's rules: on each mesh axis the batch split where q is
    split by batch, the head split where q is split by heads and the
    axis divides Hkv, else whole."""
    mesh, hkv = q.device_mesh, k.shape[1]
    pl = tuple(p if p in (Shard(0), Shard(1)) and (
                   p == Shard(0) or hkv % mesh.size(i) == 0)
               else Replicate() for i, p in enumerate(q.placements))
    return local_map(grads, out_placements=(pl, pl, pl),
                     in_placements=(pl, pl, pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)
