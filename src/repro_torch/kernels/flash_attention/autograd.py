"""K6 under autograd: the hand-written forward, the reference's gradient.

:class:`FlashAttentionFn` is what :func:`ops.flash_attention` returns
through on a CUDA tensor when autograd records (grad enabled and any of
q, k, v requiring grad).  Its forward is the CUDA kernel, exactly as
the grad-free call launches it (an unbuilt head dim zero-padded), and
it saves q, k and v alone — never a score matrix.  Its backward
recomputes attention through the model's twin of the reference's XLA
attention, ``models.layers._sdpa_direct`` / ``_sdpa_chunked``
(:func:`models.layers.sdpa_grad`), and differentiates that: the JAX
package has no backward kernel and trains through XLA's gradient of
the same functions.  ``ref.attention_ref`` is not the recompute; it
stays the plain version the CPU and the tests use.

The forward and the backward therefore come from different code: the
gradient is that of the recompute, which agrees with the kernel's
output within K6's stated tolerance (float32 2e-5; bfloat16 3e-2 and
two bf16 steps per element), not bit for bit.
"""
import torch


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
        from ...models.layers import sdpa_grad   # models import K6
        q, k, v = ctx.saved_tensors
        dq, dk, dv = sdpa_grad(*(t.transpose(1, 2) for t in (q, k, v, grad)),
                               **ctx.opts)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None)
