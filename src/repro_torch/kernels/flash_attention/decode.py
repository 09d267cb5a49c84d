"""K6's decode split and merge, written out in plain PyTorch.

``flash_attention.cu``'s decode kernel (``flash_decode``, S <= 4) cuts
the keys [lo, hi) that the S rows see together into ``chunks`` chunks
of len = ⌈(hi − lo)/chunks⌉ keys (:func:`decode_keys`; the last chunks
may be short or empty).  Chunk c leaves, per query row, its running
max m_c of the scaled scores (−1e30 where the row sees no key of the
chunk), its sum l_c = Σ exp(s − m_c) and its accumulator
acc_c = Σ exp(s − m_c)·v, in float32.  ``flash_merge`` then takes
M = max_c m_c and adds, chunk by chunk in ascending order,
L = Σ_c l_c·exp(m_c − M) and out = Σ_c acc_c·exp(m_c − M), and writes
out / max(L, 1e-30): a row with no key gets 0.  With one chunk the
decode kernel writes that quotient itself.

:func:`attention_by_chunks` performs that sequence, so the tests can hold
the merge rule to the JAX package's reference at any chunk count.
"""
import math

import torch

NEG_INF = -1e30    # kNegInf: the running max's start


def decode_keys(s: int, skv: int, causal: bool, window, q_offset: int
                ) -> tuple[int, int]:
    """The keys [lo, hi) that rows q_offset … q_offset + s − 1 see
    together (``flash_attention.cu``'s ``decode_keys``)."""
    hi = max(0, min(skv, q_offset + s)) if causal else skv
    lo = min(hi, max(0, q_offset - window + 1) if window else 0)
    return lo, hi


def chunk_partials(q, k, v, chunks: int, *, causal: bool = True,
                   window=None, q_offset: int = 0):
    """Per chunk the float32 (m, l, acc) of every query row: m and l
    (B, H, S, chunks), acc (B, H, S, chunks, D)."""
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    lo, hi = decode_keys(s, skv, causal, window, q_offset)
    step = -(-(hi - lo) // chunks)
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(b, hkv, group, s, d)
    rows = torch.arange(s, device=q.device)[:, None] + q_offset
    ms, ls, accs = [], [], []
    for c in range(chunks):
        c_lo = min(hi, lo + c * step)
        c_hi = min(hi, c_lo + step)
        cols = torch.arange(c_lo, c_hi, device=q.device)[None, :]
        kf = k[:, :, c_lo:c_hi].float()[:, :, None]
        vf = v[:, :, c_lo:c_hi].float()[:, :, None]
        sc = qf @ kf.transpose(-1, -2)             # (B, Hkv, G, S, n)
        mask = torch.ones((s, c_hi - c_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= cols <= rows
        if window:
            mask &= cols > rows - window
        sc = sc.masked_fill(~mask, -math.inf)
        m = torch.cat([sc, sc.new_full(sc.shape[:-1] + (1,), NEG_INF)],
                      -1).amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m[..., 0].reshape(b, h, s))
        ls.append(p.sum(-1).reshape(b, h, s))
        accs.append((p @ vf).reshape(b, h, s, d))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def merge_partials(m, l, acc):
    """The chunks' partials merged in ascending chunk order → float32
    (B, H, S, D)."""
    top = m.amax(-1, keepdim=True)
    w = torch.exp(m - top)
    total, out = torch.zeros_like(m[..., 0]), torch.zeros_like(acc[..., 0, :])
    for c in range(m.shape[-1]):
        total = total + l[..., c] * w[..., c]
        out = out + acc[..., c, :] * w[..., c, None]
    return out / total.clamp_min(1e-30)[..., None]


def attention_by_chunks(q, k, v, chunks: int, *, causal: bool = True,
                        window=None, q_offset: int = 0):
    """Attention of a decode step computed as ``chunks`` chunks merged in
    order → (B, H, S, D) in q's type."""
    parts = chunk_partials(q, k, v, chunks, causal=causal, window=window,
                           q_offset=q_offset)
    return merge_partials(*parts).to(q.dtype)
