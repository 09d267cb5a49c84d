"""Shared transformer layers: norms, RoPE, GQA attention, gated MLPs.

The JAX package's ``models/layers.py`` in PyTorch.  Parameters are plain
dictionaries of tensors; every layer has ``<layer>_spec`` (shapes and
logical axis names, the single source of truth for init and parameter
counts) and ``<layer>`` (apply).  The arithmetic follows the reference
op for op: norms and RoPE in float32, products in the compute type.
Attention runs on kernel K6 (``kernels/flash_attention``): its CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors.
The reference's XLA attention, ``_sdpa_direct`` and the query-chunked
``_sdpa_chunked``, has its twins here: they are not on the forward
path, but K6's backward pass recomputes attention through them
(:func:`sdpa_grad`), as the reference's gradient does.
``segmented_scan`` is ``lax.scan`` with chunked rematerialization as a
Python loop over the time axis; the recurrent mixers (``mamba.py``,
``xlstm.py``) reach that loop through their scan ops (``scan_ops.py``),
which are held to it bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from ..kernels.flash_attention import flash_attention
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Param-spec helpers.  A spec leaf is (shape, logical_axes).
# ---------------------------------------------------------------------------


class P:  # logical axis names
    VOCAB = "vocab"
    EMBED = "embed"
    HEADS = "heads"
    KV_HEADS = "kv_heads"
    HEAD_DIM = "head_dim"
    FF = "ff"
    EXPERT = "expert"
    LAYERS = "layers"
    NONE = None


def leaf(shape, axes):
    assert len(shape) == len(axes), (shape, axes)
    return {"shape": tuple(int(s) for s in shape), "axes": tuple(axes)}


def is_leaf(x):
    return isinstance(x, dict) and "shape" in x and "axes" in x


def spec_items(spec, path=()):
    """(path, leaf) pairs of a nested spec, in insertion order."""
    if is_leaf(spec):
        yield path, spec
        return
    for key, sub in spec.items():
        yield from spec_items(sub, path + (key,))


def spec_leaves(spec):
    return [lf for _, lf in spec_items(spec)]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def no_constraint(x, logical_axes):
    """The ``constraint`` of an unsharded run: ``x`` as it is.  A sharded
    run passes ``distributed.sharding.make_constraint(mesh)``, which
    places a DTensor activation by its logical axes."""
    return x


# ---------------------------------------------------------------------------
# Segmented recurrence scan (memory-bounded backward for SSM/LSTM layers)
# ---------------------------------------------------------------------------

RECURRENCE_SEGMENT = 256


def _slices(xs):
    """The per-step inputs of ``xs`` (a tuple or dict of tensors, each
    with the time axis first): a list over the steps."""
    if isinstance(xs, dict):
        return [dict(zip(xs, row))
                for row in zip(*(x.unbind(0) for x in xs.values()))]
    return list(zip(*(x.unbind(0) for x in xs)))


def _scan(step, carry, xs):
    """``lax.scan(step, carry, xs)`` as a Python loop: ``step(carry,
    x_t) → (carry, y_t)`` with y_t a tensor, stacked along a new first
    axis."""
    ys = []
    for x_t in _slices(xs):
        carry, y = step(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys)


def segmented_scan(step, carry, xs, seg_len: int = RECURRENCE_SEGMENT):
    """``lax.scan(step, carry, xs)`` with chunked rematerialization, as
    the reference's.  A loop over the time axis (:func:`_scan`).  When
    autograd records (grad mode on and an input that requires grad) and
    the length is a multiple of ``seg_len`` past one segment, each
    segment runs under ``torch.utils.checkpoint``: the backward keeps
    the segment-boundary carries alone (the reference's
    ``nothing_saveable``) and recomputes inside each segment."""
    length = T.leaves(xs)[0].shape[0]
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in T.leaves((carry, xs)))
    if not records or length % seg_len != 0 or length <= seg_len:
        return _scan(step, carry, xs)
    ys = []
    for lo in range(0, length, seg_len):
        seg = T.map(lambda x: x[lo:lo + seg_len], xs)
        carry, y = checkpoint(_scan, step, carry, seg, use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d):
    return {"scale": leaf((d,), (P.EMBED,))}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gathered(p["scale"]).float())).to(x.dtype)


def gathered(w):
    """A weight whole on every rank: a DTensor one gathered (for the
    norm scales, which the sharding rules split over "model" along the
    embedding dim that the activations keep whole — a few KB, where
    following the scale's split would shard the activation and leave
    the next product a partial sum), any other as it is."""
    if isinstance(w, DTensor):
        mesh = w.device_mesh
        return w.redistribute(mesh, [Replicate()] * mesh.ndim)
    return w


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, positions):
    """positions: (...,) int → (cos, sin) each (..., head_dim/2) f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=positions.device), exps)
    angles = positions[..., None].float() * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, S, H, Dh); cos/sin: (S, Dh/2) or (B, S, Dh/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:   # (S, half) → broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_spec(cfg: ModelConfig):
    d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    return {
        "wq": leaf((d, h, dh), (P.EMBED, P.HEADS, P.HEAD_DIM)),
        "wk": leaf((d, hkv, dh), (P.EMBED, P.KV_HEADS, P.HEAD_DIM)),
        "wv": leaf((d, hkv, dh), (P.EMBED, P.KV_HEADS, P.HEAD_DIM)),
        "wo": leaf((h, dh, d), (P.HEADS, P.HEAD_DIM, P.EMBED)),
    }


SDPA_CHUNK = 512           # query-block size for the chunked path
SDPA_DIRECT_MAX = 1024     # use the direct path when s_q <= this


def _mask(sq, skv, q_base, q_offset, causal, window, device=None):
    rows = torch.arange(sq, device=device)[:, None] + q_base + q_offset
    cols = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= cols <= rows
    if window is not None:
        m &= cols > rows - window
    return m


def _sdpa_direct(q, k, v, *, causal, window, q_offset, q_base=0):
    """The reference's XLA attention: q (B, S, H, Dh), k and v (B, Skv,
    Hkv, Dh) → (B, S, H, Dh).  Scores in float32, masked scores set to
    -1e30 before the softmax, the probabilities cast to v's type for the
    PV product."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * scale, k.float())
    m = _mask(sq, skv, q_base, q_offset, causal, window, q.device)
    s = s.masked_fill(~m, -1e30)
    p = torch.softmax(s, -1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, dh)


def _sdpa_chunked(q, k, v, *, causal, window, q_offset):
    """Query-chunked attention: SDPA_CHUNK query rows at a time, each
    chunk under ``torch.utils.checkpoint`` (the reference's
    ``nothing_saveable``), so the residuals are q, k and v alone and the
    (S, S) scores never exist whole.  S must be a multiple of
    SDPA_CHUNK."""
    sq = q.shape[1]
    outs = [checkpoint(_sdpa_direct, q[:, lo:lo + SDPA_CHUNK], k, v,
                       causal=causal, window=window, q_offset=q_offset,
                       q_base=lo, use_reentrant=False)
            for lo in range(0, sq, SDPA_CHUNK)]
    return torch.cat(outs, 1)


def sdpa_grad(q, k, v, grad, *, causal, window, q_offset):
    """The gradient of the reference's attention at q (B, S, H, Dh), k
    and v (B, Skv, Hkv, Dh) against ``grad`` (B, S, H, Dh): (dq, dk,
    dv) in the inputs' types.  Up to SDPA_DIRECT_MAX rows (or S off a
    multiple of SDPA_CHUNK) it differentiates ``_sdpa_direct`` whole, as
    the reference's ``_sdpa`` dispatches; past it, ``_sdpa_chunked``'s
    chunks one at a time — each chunk recomputed once and differentiated
    at once, so one chunk's scores exist at a time — with dk and dv
    summed over the chunks in float32.  GQA's sum of each kv head's
    query group is autograd's own."""
    sq = q.shape[1]
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with torch.enable_grad():
        if sq <= SDPA_DIRECT_MAX or sq % SDPA_CHUNK:
            return torch.autograd.grad(_sdpa_direct(q, k, v, **kw),
                                       (q, k, v), grad)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for lo in range(0, sq, SDPA_CHUNK):
            qi = q[:, lo:lo + SDPA_CHUNK].detach().requires_grad_(True)
            o = _sdpa_direct(qi, k, v, q_base=lo, **kw)
            gq, gk, gv = torch.autograd.grad(
                o, (qi, k, v), grad[:, lo:lo + SDPA_CHUNK])
            dq[:, lo:lo + SDPA_CHUNK] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _sdpa(q, k, v, *, causal, window, q_offset):
    """q (B, S, H, Dh); k, v (B, Hkv, Skv, Dh) → (B, S, H, Dh) on K6.
    The query is handed over as a (B, H, S, Dh) view and the output comes
    back in the same strides, so neither side is copied.  A DTensor query
    is made dense first: DTensor plans the output's views on q's global
    strides, which a redistribution of q does not keep on each rank."""
    qt = q.transpose(1, 2)
    if isinstance(qt, DTensor):
        qt = qt.contiguous()
    o = flash_attention(qt, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    return o.transpose(1, 2)


def _proj(x, w, dtype):
    """x (B, S, D) @ w (D, ...) → (B, S, ...)."""
    out = x @ w.to(dtype).reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def attention(p, x, cfg: ModelConfig, *, positions, kv_cache=None,
              cache_offset=None, constraint=None):
    """Returns (out, new_kv).  Without a cache new_kv is the (k, v) of x
    as (B, Hkv, S, Dh) views; with ``kv_cache = (k_cache, v_cache)``, each
    (B, Hkv, max_seq, Dh), x's keys and values are written into the cache
    in place at ``cache_offset`` and the queries attend over the whole
    cache (the causal mask hides the rows not yet written, and K6 never
    reads them)."""
    cons = constraint or no_constraint
    dtype = x.dtype
    q = _proj(x, p["wq"], dtype)                 # (B, S, H, Dh)
    k = _proj(x, p["wk"], dtype)                 # (B, S, Hkv, Dh)
    v = _proj(x, p["wv"], dtype)
    q = cons(q, ("batch", None, "heads", None))
    k = cons(k, ("batch", None, "kv_heads", None))
    if not cfg.encoder_only:
        cos, sin = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                    positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # (B, Hkv, S, Dh)
    if kv_cache is not None:
        kc, vc = kv_cache
        s = k.shape[2]
        kc[:, :, cache_offset:cache_offset + s] = k
        vc[:, :, cache_offset:cache_offset + s] = v
        k_all, v_all, new_kv, q_offset = kc, vc, (kc, vc), cache_offset
    else:
        k_all, v_all, new_kv, q_offset = k, v, (k, v), 0
    o = _sdpa(q, k_all, v_all, causal=not cfg.encoder_only,
              window=cfg.sliding_window, q_offset=q_offset)
    o = cons(o, ("batch", None, "heads", None))
    wo = p["wo"].to(dtype)
    out = o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    return cons(out, ("batch", None, "embed")), new_kv


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("silu", "gelu_glu"):
        return {
            "w_gate": leaf((d, f), (P.EMBED, P.FF)),
            "w_up": leaf((d, f), (P.EMBED, P.FF)),
            "w_down": leaf((f, d), (P.FF, P.EMBED)),
        }
    return {  # plain 2-layer MLP (starcoder2)
        "w_up": leaf((d, f), (P.EMBED, P.FF)),
        "w_down": leaf((f, d), (P.FF, P.EMBED)),
    }


def sigmoid(x):
    """``jax.nn.sigmoid``'s formula, 1 / (1 + exp(−x)), each operation
    rounded to x's type as XLA rounds it: in bfloat16 it differs from
    ``torch.sigmoid`` (one rounding of the float32 value) by a step on
    about a third of the inputs."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x · :func:`sigmoid` (x)."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, cfg: ModelConfig, constraint=None):
    cons = constraint or no_constraint
    dtype = x.dtype
    if "w_gate" in p:
        g = x @ p["w_gate"].to(dtype)
        u = x @ p["w_up"].to(dtype)
        act = F.silu if cfg.act == "silu" else gelu
        h = act(g) * u
    else:
        h = gelu(x @ p["w_up"].to(dtype))
    h = cons(h, ("batch", None, "ff"))
    return cons(h @ p["w_down"].to(dtype), ("batch", None, "embed"))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_spec(cfg: ModelConfig):
    spec = {"tok": leaf((cfg.vocab_size, cfg.d_model), (P.VOCAB, P.EMBED))}
    if cfg.frontend is not None:
        # modality frontend STUB: linear projection of precomputed
        # patch/frame embeddings into the backbone width
        spec["frontend_proj"] = leaf((cfg.d_model, cfg.d_model),
                                     (P.EMBED, P.EMBED))
    return spec


def embed_tokens(p, token_ids, cfg: ModelConfig):
    """The rows of the token ids, by ``F.embedding``: a gather, which
    DTensor splits over a vocab-sharded table (index and ``index_put``
    have no rule for it in every PyTorch release).  On a sharded table
    each rank's rows are a masked partial sum; they are completed here,
    and their gradient taken whole (DTensor cannot turn a partial sum
    back into the masked one)."""
    x = F.embedding(token_ids.long(), p["tok"]).to(compute_dtype(cfg))
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    whole = [Replicate() if isinstance(pl, Partial) else pl
             for pl in x.placements]
    local = x.redistribute(mesh, whole).to_local(grad_placements=whole)
    return DTensor.from_local(local, mesh, whole, run_check=False,
                              shape=x.shape, stride=x.stride())


def embed_frontend(p, feats, cfg: ModelConfig):
    dt = compute_dtype(cfg)
    return feats.to(dt) @ p["frontend_proj"].to(dt)


def lm_head_spec(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": leaf((cfg.d_model, cfg.vocab_size), (P.EMBED, P.VOCAB))}


def lm_head(params, x, cfg: ModelConfig):
    w = (params["embed"]["tok"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return x @ w.to(x.dtype)
