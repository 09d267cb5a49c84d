"""Plain PyTorch version of blocked forward attention.

Mirrors the JAX package's ``kernels/flash_attention/ref.py``: softmax
attention with GQA (query head h reads kv head h // (H / Hkv)), causal
and sliding-window masks and a decode offset, computed in float32 and
returned in q's type; a row with no key gets 0.  The scale is
1/sqrt(D) as a Python float, as the Pallas kernel and the model take
it.  Query rows are taken in chunks, so that the (B, H, chunk, Skv)
score block stays near 2**28 elements on the card at full size.
"""
import math

import torch

CHUNK_ELEMS = 1 << 28


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0):
    """q (B, H, S, D); k, v (B, Hkv, Skv, D) → (B, H, S, D) in q's type.
    Row i sits at absolute position i + q_offset."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    kf = k.float()[:, :, None]                      # (B, Hkv, 1, Skv, D)
    vf = v.float()[:, :, None]
    cols = torch.arange(skv, device=q.device)
    step = max(1, CHUNK_ELEMS // max(1, b * h * skv))
    out = []
    for lo in range(0, sq, step):
        qc = q[:, :, lo:lo + step].float() * scale
        n = qc.shape[2]
        qc = qc.reshape(b, hkv, group, n, d)
        s = qc @ kf.transpose(-1, -2)               # (B, Hkv, G, n, Skv)
        rows = torch.arange(lo, lo + n, device=q.device)[:, None] + q_offset
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= cols[None, :] <= rows
        if window is not None:
            mask &= cols[None, :] > rows - window
        s = s.masked_fill(~mask, -math.inf)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p.masked_fill(~mask, 0.0)
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        out.append((p @ vf).reshape(b, h, n, d))
    if not out:
        return torch.empty_like(q)
    return torch.cat(out, 2).to(q.dtype)
