"""Model assembly: the JAX package's ``models/model.py`` in PyTorch, for
the families whose mixer is attention — ``dense``, ``moe``, ``vlm``
(patch-embedding frontend stub) and ``audio`` (encoder-only, frame
frontend stub).  ``hybrid`` and ``ssm`` raise ``NotImplementedError``:
their Mamba and xLSTM mixers are not ported yet (ROADMAP Queue 1 item 9).

Entry points, as in the reference:
  forward(...)      — full-sequence logits (+ MoE aux)
  prefill(...)      — forward + cache construction — serving prefill
  decode_step(...)  — one-token incremental step over the cache
  loss_fn(...)      — training loss: ``forward_hidden`` and a
                      cross-entropy chunked over the sequence

``param_spec`` is the reference's spec, period axis and all (it fixes
the init scales and the parameter count).  The parameters themselves are
per-layer dictionaries (``params["layers"][i]``) rather than arrays
stacked over periods: PyTorch runs a Python loop over layers, and a
stacked float32 copy of the experts would double the weights' memory.
Weights are stored once in the compute type, except the router and the
norm scales, which stay float32 — the values the reference's per-use
casts give.  The KV cache is (layers, B, Hkv, max_seq, Dh) per tensor,
the layout kernel K6 reads; ``decode_step`` writes it in place and its
offset is a Python int.  Training keeps float32 master weights (the
reference's "params are fp32 masters"): ``init_params(...,
dtype=torch.float32)``; every product casts its weight to the compute
type at use.  ``remat`` names the reference's checkpoint policies and
maps each onto ``torch.utils.checkpoint`` around every block.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import moe as MOE
from .config import ModelConfig

PORTED_FAMILIES = ("dense", "moe", "vlm", "audio")

# ---------------------------------------------------------------------------
# Period patterns
# ---------------------------------------------------------------------------


def period_pattern(cfg: ModelConfig):
    """List of (mixer, ffn) per position in one period."""
    if cfg.family == "hybrid":
        pat = []
        for pos in range(cfg.attn_layer_period):
            mixer = "attn" if pos == 0 else "mamba"
            ffn = ("moe" if (cfg.moe and pos % cfg.moe.layer_period == 1)
                   else "mlp")
            pat.append((mixer, ffn))
        return pat
    if cfg.family == "ssm":
        period = cfg.xlstm.slstm_period
        return [("slstm" if pos == 0 else "mlstm", None)
                for pos in range(period)]
    ffn = "moe" if cfg.moe is not None else "mlp"
    return [("attn", ffn)]


def num_periods(cfg: ModelConfig) -> int:
    plen = len(period_pattern(cfg))
    assert cfg.num_layers % plen == 0, (cfg.name, cfg.num_layers, plen)
    return cfg.num_layers // plen


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's Mamba/xLSTM mixers are "
            "not ported to PyTorch yet (ROADMAP Queue 1 item 9)")


# ---------------------------------------------------------------------------
# Param spec / init
# ---------------------------------------------------------------------------

def _block_spec(cfg: ModelConfig, ffn: str):
    d = cfg.d_model
    return {"norm1": L.rmsnorm_spec(d), "attn": L.attention_spec(cfg),
            "norm2": L.rmsnorm_spec(d),
            "ffn": MOE.moe_spec(cfg) if ffn == "moe" else L.mlp_spec(cfg)}


def param_spec(cfg: ModelConfig):
    """The reference's spec: block leaves stacked over the periods."""
    _require_ported(cfg)
    period = {f"pos{i}": _block_spec(cfg, ffn)
              for i, (_, ffn) in enumerate(period_pattern(cfg))}
    n_per = num_periods(cfg)

    def stack(spec):
        if L.is_leaf(spec):
            return L.leaf((n_per, *spec["shape"]), (L.P.LAYERS,
                                                    *spec["axes"]))
        return {k: stack(v) for k, v in spec.items()}

    spec = {
        "embed": L.embedding_spec(cfg),
        "blocks": stack(period),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    spec.update({"lm_head": L.lm_head_spec(cfg)}
                if not cfg.tie_embeddings else {})
    return spec


def keeps_float32(path) -> bool:
    """The router and the norm scales are used in float32."""
    return path[-1] == "router" or (path[-1] == "scale"
                                    and "norm" in "/".join(path))


def _set(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def empty_params(cfg: ModelConfig):
    """The port's parameter tree with every layer's dictionary in place:
    ``{"embed", "layers": [ {norm1, attn, norm2, ffn} ] * L, "final_norm",
    "lm_head"?}``."""
    return {"layers": [{} for _ in range(cfg.num_layers)]}


def place(tree: dict, path, value, n_pos: int = 1, period: int = 0):
    """Store ``value`` at the port's place for the spec ``path``: a
    block leaf ``("blocks", "pos{j}", ...)`` of period ``period`` goes to
    layer ``period · n_pos + j``."""
    if path[0] == "blocks":
        layer = period * n_pos + int(path[1][3:])
        _set(tree["layers"][layer], path[2:], value)
    else:
        _set(tree, path, value)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype: torch.dtype | None = None):
    """Random parameters by the reference's rule: norm scales 0 (used as
    1 + scale), embeddings N(0, 0.02²), every other leaf N(0, 1/fan_in)
    with fan_in the product of all but the last dimension of the
    *stacked* leaf, period axis included.  Drawn in float32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, one layer at a
    time, and stored in ``dtype`` (the compute type by default; the
    router and norm scales stay float32).  The numbers differ from the
    JAX package's for the same seed; :func:`convert.from_jax_params`
    carries those over instead."""
    dtype = dtype or L.compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = empty_params(cfg)
    n_pos = len(period_pattern(cfg))
    for path, lf in L.spec_items(param_spec(cfg)):
        shape = lf["shape"]
        dt = torch.float32 if keeps_float32(path) else dtype
        stacked = path[0] == "blocks"
        if path[-1] == "scale" and "norm" in "/".join(path):
            scale = 0.0
        else:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            scale = (0.02 if "embed" in path
                     else 1.0 / math.sqrt(max(fan_in, 1)))
        for i in range(shape[0] if stacked else 1):
            one = shape[1:] if stacked else shape
            w = (torch.zeros(one, dtype=dt, device=device) if scale == 0.0
                 else (torch.randn(one, generator=gen, device=device)
                       * scale).to(dt))
            place(params, path, w, n_pos, i)
    return params


def unstack(cfg: ModelConfig, fetch, convert):
    """The port's tree from the reference's layout, leaf by leaf over
    the spec: ``fetch(path)`` gives the reference's leaf at a spec path
    (stacked over the periods for a block leaf), checked against the
    spec's shape, and ``convert(path, value, layer)`` the port's leaf
    from it — for a block leaf once per layer with the layer's slice,
    else once with ``layer`` None."""
    params = empty_params(cfg)
    n_pos = len(period_pattern(cfg))
    for path, lf in L.spec_items(param_spec(cfg)):
        arr = fetch(path)
        if tuple(arr.shape) != lf["shape"]:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)}, "
                             f"the spec says {lf['shape']}")
        if path[0] != "blocks":
            place(params, path, convert(path, arr, None))
            continue
        for i in range(arr.shape[0]):
            layer = i * n_pos + int(path[1][3:])
            place(params, path, convert(path, arr[i], layer), n_pos, i)
    return params


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    """The port's parameter tree on the ``meta`` device — shapes and
    types without storage, every leaf in ``dtype`` (the reference's
    ``abstract_params``): the template ``checkpoint.restore`` fills."""
    spec = dict(L.spec_items(param_spec(cfg)))
    return unstack(cfg, lambda path: torch.empty(
        spec[path]["shape"], dtype=dtype, device="meta"),
        lambda path, leaf, layer: leaf)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """Shapes and types of the incremental-decode cache: one K and one V
    tensor (attention layers, B, Hkv, max_seq, Dh) and the offset."""
    _require_ported(cfg)
    dt = L.compute_dtype(cfg)
    kv = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq,
          cfg.resolved_head_dim)
    return {"offset": ((), torch.int32), "kv_k": (kv, dt), "kv_v": (kv, dt)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    out = {"offset": 0}
    for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items():
        if k != "offset":
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def _embed(params, cfg, token_ids=None, embeds=None):
    if embeds is not None:
        return L.embed_frontend(params["embed"], embeds, cfg)
    return L.embed_tokens(params["embed"], token_ids, cfg)


# the reference's checkpoint policies (train/train_step.py REMAT_POLICIES)
# as the products whose outputs a block keeps: "none" and "everything"
# keep all (no checkpoint), "nothing" keeps none (the whole block is
# recomputed), "dots_no_batch" the products without batch dimensions
# (``aten.mm``/``addmm``: projections and MLPs), "dots" the batched
# expert products (``aten.bmm``) as well
_SAVED_PRODUCTS = {
    "dots_no_batch": ("mm", "addmm"),
    "dots": ("mm", "addmm", "bmm"),
}
REMAT_POLICIES = ("none", "dots", "dots_no_batch", "nothing", "everything")


def _remat_context(remat):
    """The ``context_fn`` of the selective checkpoint for ``remat``."""
    ops = [getattr(torch.ops.aten, name).default
           for name in _SAVED_PRODUCTS[remat]]
    return functools.partial(create_selective_checkpoint_contexts, ops)


def _block(lp, x, cfg, positions, kv, offset, placement):
    """One block: (x, expert counts, aux loss)."""
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    o, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                       kv_cache=kv, cache_offset=offset)
    x = x + o
    h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if cfg.moe is None:
        return x + L.mlp(lp["ffn"], h2, cfg), None, None
    o2, moe_aux = MOE.moe_ffn(lp["ffn"], h2, cfg, placement=placement)
    return x + o2, moe_aux["expert_counts"], moe_aux["aux_loss"]


def _layers(params, x, cfg, *, positions, cache=None, offset=0,
            placement=None, remat=None):
    """Every block in order; with a cache, each attention layer writes
    its keys and values into its slice of it.  ``remat`` (a name of
    :data:`REMAT_POLICIES`; None is "none") checkpoints each block:
    the placement that bounds per-layer residual memory, as the
    reference's scan body.  Returns (x, aux)."""
    _require_ported(cfg)
    if remat not in (None, *REMAT_POLICIES):
        raise ValueError(f"remat={remat!r}: one of {REMAT_POLICIES}")
    n_exp = cfg.moe.num_experts if cfg.moe else 1
    counts = torch.zeros((n_exp,), dtype=torch.float32, device=x.device)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _block
    if remat == "nothing":
        block = functools.partial(checkpoint, _block, use_reentrant=False)
    elif remat in _SAVED_PRODUCTS:
        block = functools.partial(checkpoint, _block, use_reentrant=False,
                                  context_fn=_remat_context(remat))
    for i, lp in enumerate(params["layers"]):
        kv = None if cache is None else (cache["kv_k"][i], cache["kv_v"][i])
        x, c, a = block(lp, x, cfg, positions, kv, offset, placement)
        if c is not None:
            counts = counts + c
            aux_loss = aux_loss + a
    return x, {"expert_counts": counts, "aux_loss": aux_loss}


def forward(params, cfg: ModelConfig, *, token_ids=None, embeds=None,
            placement=None):
    """Full-sequence logits (B, S, V) + aux.  For frontend archs pass
    ``embeds`` (precomputed patch/frame features)."""
    x = _embed(params, cfg, token_ids, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions,
                     placement=placement)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params, x, cfg), aux


def prefill(params, cfg: ModelConfig, *, token_ids=None, embeds=None,
            max_seq: int | None = None, placement=None):
    """Forward + cache construction for serving: (logits of the last
    position (B, 1, V), cache, aux)."""
    x = _embed(params, cfg, token_ids, embeds)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max_seq or s, device=x.device)
    positions = torch.arange(s, device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions, cache=cache,
                     offset=0, placement=placement)
    cache["offset"] = s
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.lm_head(params, x, cfg), cache, aux


def decode_step(params, cfg: ModelConfig, cache, token_ids,
                placement=None):
    """One incremental token: token_ids (B, 1) → (logits (B, 1, V),
    cache, aux).  The cache tensors are updated in place; the returned
    cache shares them, with the offset advanced by one."""
    x = _embed(params, cfg, token_ids=token_ids)
    offset = int(cache["offset"])
    positions = torch.full((x.shape[0], 1), offset, device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions, cache=cache,
                     offset=offset, placement=placement)
    new_cache = dict(cache, offset=offset + 1)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params, x, cfg), new_cache, aux


def forward_hidden(params, cfg: ModelConfig, *, token_ids=None, embeds=None,
                   placement=None, remat=None):
    """Final-norm hidden states (B, S, D) + aux — the lm_head is applied
    downstream (chunked in the loss so full float32 logits never
    exist)."""
    x = _embed(params, cfg, token_ids, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions,
                     placement=placement, remat=remat)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


CE_CHUNK = 512


def _chunk_ce(params, cfg, x_c, y_c, m_c):
    """(−Σ log p(y) over the chunk's kept positions, their count); the
    chunk's logits in float32."""
    logits = L.lm_head(params, x_c, cfg).float()
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    return -((picked - lse) * m_c).sum(), m_c.sum()


def _chunked_ce(params, cfg, x, labels, mask):
    """Cross-entropy over sequence chunks of CE_CHUNK positions: each
    chunk's logits are computed, reduced and recomputed in the backward
    pass (``torch.utils.checkpoint``, the reference's
    ``nothing_saveable``), so the (B, S, V) float32 logits never exist.
    A sequence that is not a multiple of CE_CHUNK is one chunk, as in
    the reference."""
    s = x.shape[1]
    size = CE_CHUNK if s % CE_CHUNK == 0 else s
    num = den = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, size):
        dn, dd = checkpoint(_chunk_ce, params, cfg, x[:, lo:lo + size],
                            labels[:, lo:lo + size], mask[:, lo:lo + size],
                            use_reentrant=False)
        num, den = num + dn, den + dd
    return num / den.clamp_min(1.0)


def loss_fn(params, cfg: ModelConfig, batch, placement=None, remat=None):
    """Next-token (causal) or per-frame (encoder) cross-entropy, with the
    vocab projection chunked over the sequence; the MoE aux loss added
    at ``router_aux_weight``.  Returns (loss, aux)."""
    x, aux = forward_hidden(params, cfg, token_ids=batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            placement=placement, remat=remat)
    labels = batch["labels"]
    if cfg.encoder_only:
        mask = (labels >= 0).float()
        tgt = labels.clamp_min(0)
    else:  # next-token: predict labels[t+1] from x[t]; last position void
        tgt = torch.cat([labels[:, 1:], labels[:, :1]], 1).clamp_min(0)
        mask = torch.cat([(labels[:, 1:] >= 0).float(),
                          torch.zeros_like(labels[:, :1], dtype=torch.float32)],
                         1)
    loss = _chunked_ce(params, cfg, x, tgt, mask)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["aux_loss"]
    return loss, aux
