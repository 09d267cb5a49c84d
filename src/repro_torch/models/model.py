"""Model assembly: the JAX package's ``models/model.py`` in PyTorch, for
all ten architectures — the attention families ``dense``, ``moe``,
``vlm`` (patch-embedding frontend stub) and ``audio`` (encoder-only,
frame frontend stub), ``hybrid`` (jamba: attention and Mamba mixers,
MLP and MoE feed-forwards) and ``ssm`` (xlstm: sLSTM and mLSTM mixers,
no feed-forward).

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
Weights are stored once in the compute type, except the router, the
norm scales and the recurrences' ``a_log``, ``d_skip``, ``dt_proj_b``
and ``r_*``, which stay float32 — the values the reference's per-use
casts give.  The cache keeps one tensor per state kind, its leading
axis the index among the layers of that mixer (:func:`cache_spec`);
K and V are (attention layers, B, Hkv, max_seq, Dh), the layout kernel
K6 reads.  ``decode_step`` writes every state in place and its offset
is a Python int.  Training keeps float32 master weights (the
reference's "params are fp32 masters"): ``init_params(...,
dtype=torch.float32)``; every product casts its weight to the compute
type at use.  ``remat`` names the reference's checkpoint policies and
maps each onto ``torch.utils.checkpoint`` around every block.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import mamba as MB
from . import moe as MOE
from . import xlstm as X
from .config import ModelConfig

PORTED_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")

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


def layer_kinds(cfg: ModelConfig):
    """Per layer, (mixer, ffn, index among the model's layers of that
    mixer): the index a layer's state has in its kind's cache tensor."""
    pat, seen, out = period_pattern(cfg), {}, []
    for i in range(cfg.num_layers):
        mixer, ffn = pat[i % len(pat)]
        out.append((mixer, ffn, seen.get(mixer, 0)))
        seen[mixer] = seen.get(mixer, 0) + 1
    return out


# ---------------------------------------------------------------------------
# Param spec / init
# ---------------------------------------------------------------------------

_MIXER_SPECS = {"attn": L.attention_spec, "mamba": MB.mamba_spec,
                "mlstm": X.mlstm_spec, "slstm": X.slstm_spec}


def _block_spec(cfg: ModelConfig, mixer: str, ffn: str | None):
    d = cfg.d_model
    spec = {"norm1": L.rmsnorm_spec(d), mixer: _MIXER_SPECS[mixer](cfg)}
    if ffn is not None:
        spec["norm2"] = L.rmsnorm_spec(d)
        spec["ffn"] = MOE.moe_spec(cfg) if ffn == "moe" else L.mlp_spec(cfg)
    return spec


def param_spec(cfg: ModelConfig):
    """The reference's spec: block leaves stacked over the periods."""
    period = {f"pos{i}": _block_spec(cfg, mixer, ffn)
              for i, (mixer, ffn) in enumerate(period_pattern(cfg))}
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


# leaves the reference casts to float32 at every use
_FLOAT32_LEAVES = ("router", "a_log", "d_skip", "dt_proj_b", "r_z", "r_i",
                   "r_f", "r_o")


def keeps_float32(path) -> bool:
    """The router, the norm scales and the recurrences' ``a_log``,
    ``d_skip``, ``dt_proj_b`` and ``r_*`` are used in float32."""
    return path[-1] in _FLOAT32_LEAVES or (path[-1] == "scale"
                                           and "norm" in "/".join(path))


def _constant_init(path, shape):
    """The reference's fixed initial values, as a float32 tensor of one
    layer's ``shape`` (None for a random leaf): norm scales, conv and
    dt biases and the sLSTM's z, i, o biases 0, the forget bias 1,
    ``a_log`` = log(1 … d_state) along its last axis, ``d_skip`` 1."""
    name = path[-1]
    if (name == "scale" and "norm" in "/".join(path)) or name in (
            "conv_b", "dt_proj_b", "b_z", "b_i", "b_o"):
        return torch.zeros(shape)
    if name in ("b_f", "d_skip"):
        return torch.ones(shape)
    if name == "a_log":
        base = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32))
        return base.expand(shape).clone()
    return None


def _set(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def empty_params(cfg: ModelConfig):
    """The port's parameter tree with every layer's dictionary in place:
    ``{"embed", "layers": [ {norm1, <mixer>, norm2?, ffn?} ] * L,
    "final_norm", "lm_head"?}``."""
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
    """Random parameters by the reference's rule: the fixed values of
    :func:`_constant_init` (norm scales 0, used as 1 + scale; the
    recurrences' biases, ``a_log`` and ``d_skip``), embeddings
    N(0, 0.02²), every other leaf N(0, 1/fan_in) with fan_in the product
    of all but the last dimension of the *stacked* leaf, period axis
    included.  Drawn in float32 from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, one layer at a time, and stored in ``dtype``
    (the compute type by default; the leaves of :func:`keeps_float32`
    stay float32).  The numbers differ from the JAX package's for the
    same seed; :func:`convert.from_jax_params` carries those over
    instead."""
    dtype = dtype or L.compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = empty_params(cfg)
    n_pos = len(period_pattern(cfg))
    for path, lf in L.spec_items(param_spec(cfg)):
        shape = lf["shape"]
        dt = torch.float32 if keeps_float32(path) else dtype
        stacked = path[0] == "blocks"
        one = shape[1:] if stacked else shape
        const = _constant_init(path, one)
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        scale = 0.02 if "embed" in path else 1.0 / math.sqrt(max(fan_in, 1))
        for i in range(shape[0] if stacked else 1):
            w = (const.to(device=device, dtype=dt, copy=True)
                 if const is not None
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

# the cache tensors of each mixer's state, in the order its block takes
# and returns them
STATE_NAMES = {"attn": ("kv_k", "kv_v"), "mamba": ("mamba_h", "mamba_conv"),
               "mlstm": ("mlstm_c", "mlstm_n", "mlstm_m"),
               "slstm": ("slstm_c", "slstm_n", "slstm_h", "slstm_m")}
_CACHE_FILL = {"mlstm_m": -1e30, "slstm_m": -1e30}   # the stabilisers' start


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """Shapes and types of the incremental-decode cache: the offset and,
    for each mixer the model has, its state tensors (:data:`STATE_NAMES`),
    each with a leading axis that is the index among the model's layers
    of that mixer (:func:`layer_kinds`): K and V (attention layers, B,
    Hkv, max_seq, Dh) in the compute type; ``mamba_h`` (Mamba layers, B,
    d_inner, d_state) float32 and ``mamba_conv`` (…, B, d_conv − 1,
    d_inner) in the compute type; ``mlstm_{c,n,m}`` and
    ``slstm_{c,n,h,m}`` float32.

    The reference stacks each state as (periods, n, …) with n the layers
    of that mixer in a period, and K and V as (periods, n, B, max_seq,
    Hkv, Dh): the port's row p·n + j is the reference's [p, j], so a
    state converts by a reshape of its first two axes, K and V with
    their sequence and head axes swapped too."""
    dt = L.compute_dtype(cfg)
    n = {}
    for mixer, _, _ in layer_kinds(cfg):
        n[mixer] = n.get(mixer, 0) + 1
    spec: dict = {"offset": ((), torch.int32)}
    if "attn" in n:
        kv = (n["attn"], batch, cfg.num_kv_heads, max_seq,
              cfg.resolved_head_dim)
        spec["kv_k"] = (kv, dt)
        spec["kv_v"] = (kv, dt)
    if "mamba" in n:
        hs, cs = MB.mamba_state_spec(cfg, batch)
        spec["mamba_h"] = ((n["mamba"], *hs), torch.float32)
        spec["mamba_conv"] = ((n["mamba"], *cs), dt)
    for mixer, shapes in (("mlstm", X.mlstm_state_spec),
                          ("slstm", X.slstm_state_spec)):
        if mixer in n:
            for name, shape in zip(STATE_NAMES[mixer], shapes(cfg, batch)):
                spec[name] = ((n[mixer], *shape), torch.float32)
    return spec


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    """The cache on the ``meta`` device — shapes and types without
    storage (the reference's ``abstract_cache``); the offset a Python
    int, 0, as :func:`init_cache` gives it."""
    out = {"offset": 0}
    for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items():
        if k != "offset":
            out[k] = torch.empty(shape, dtype=dt, device="meta")
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    out = {"offset": 0}
    for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items():
        if k != "offset":
            out[k] = torch.full(shape, _CACHE_FILL.get(k, 0.0), dtype=dt,
                                device=device)
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


_RECURRENT = {"mamba": MB.mamba_block, "mlstm": X.mlstm_block,
              "slstm": X.slstm_block}


def _block(lp, x, cfg, mixer, ffn, positions, state, offset, placement,
           constraint):
    """One block: (x, expert counts, aux loss).  ``state`` is the
    mixer's cache views (:data:`STATE_NAMES`) or None; the block writes
    its new state into them in place."""
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        o, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                           kv_cache=state, cache_offset=offset,
                           constraint=constraint)
    else:
        o, new = _RECURRENT[mixer](lp[mixer], h, cfg, state=state,
                                   constraint=constraint)
        for dst, src in zip(state or (), new):
            dst.copy_(src)
    x = x + o
    if ffn is None:
        return x, None, None
    h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if ffn == "mlp":
        return x + L.mlp(lp["ffn"], h2, cfg, constraint), None, None
    o2, moe_aux = MOE.moe_ffn(lp["ffn"], h2, cfg, placement=placement,
                              constraint=constraint)
    return x + o2, moe_aux["expert_counts"], moe_aux["aux_loss"]


def _layers(params, x, cfg, *, positions, cache=None, offset=0,
            placement=None, constraint=None, remat=None):
    """Every block in order; with a cache, each layer reads and writes
    its state in its kind's cache tensors (an attention layer its keys
    and values, a recurrent layer its state).  ``remat`` (a name of
    :data:`REMAT_POLICIES`; None is "none") checkpoints each block:
    the placement that bounds per-layer residual memory, as the
    reference's scan body.  Returns (x, aux)."""
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
    for lp, (mixer, ffn, j) in zip(params["layers"], layer_kinds(cfg)):
        state = (None if cache is None
                 else tuple(cache[name][j] for name in STATE_NAMES[mixer]))
        x, c, a = block(lp, x, cfg, mixer, ffn, positions, state, offset,
                        placement, constraint)
        if c is not None:
            counts = counts + c
            aux_loss = aux_loss + a
    return x, {"expert_counts": counts, "aux_loss": aux_loss}


def forward(params, cfg: ModelConfig, *, token_ids=None, embeds=None,
            placement=None, constraint=None):
    """Full-sequence logits (B, S, V) + aux.  For frontend archs pass
    ``embeds`` (precomputed patch/frame features)."""
    cons = constraint or L.no_constraint
    x = cons(_embed(params, cfg, token_ids, embeds), ("batch", None, "embed"))
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions,
                     placement=placement, constraint=constraint)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return cons(L.lm_head(params, x, cfg), ("batch", None, "vocab")), aux


def prefill(params, cfg: ModelConfig, *, token_ids=None, embeds=None,
            max_seq: int | None = None, placement=None, constraint=None,
            cache=None):
    """Forward + cache construction for serving: (logits of the last
    position (B, 1, V), cache, aux).  ``cache`` is the cache to fill
    (``init_cache``'s, or a sharded run's placed by
    ``serve.engine.cache_shardings``); a new one by default."""
    cons = constraint or L.no_constraint
    x = cons(_embed(params, cfg, token_ids, embeds), ("batch", None, "embed"))
    b, s = x.shape[0], x.shape[1]
    if cache is None:
        cache = init_cache(cfg, b, max_seq or s, device=x.device)
    positions = torch.arange(s, device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions, cache=cache,
                     offset=0, placement=placement, constraint=constraint)
    cache["offset"] = s
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.lm_head(params, x, cfg), cache, aux


def decode_step(params, cfg: ModelConfig, cache, token_ids,
                placement=None, constraint=None):
    """One incremental token: token_ids (B, 1) → (logits (B, 1, V),
    cache, aux).  The cache tensors are updated in place; the returned
    cache shares them, with the offset advanced by one."""
    cons = constraint or L.no_constraint
    x = cons(_embed(params, cfg, token_ids=token_ids),
             ("batch", None, "embed"))
    offset = int(cache["offset"])
    positions = torch.full((x.shape[0], 1), offset, device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions, cache=cache,
                     offset=offset, placement=placement,
                     constraint=constraint)
    new_cache = dict(cache, offset=offset + 1)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (cons(L.lm_head(params, x, cfg), ("batch", None, "vocab")),
            new_cache, aux)


def forward_hidden(params, cfg: ModelConfig, *, token_ids=None, embeds=None,
                   placement=None, constraint=None, remat=None):
    """Final-norm hidden states (B, S, D) + aux — the lm_head is applied
    downstream (chunked in the loss so full float32 logits never
    exist)."""
    cons = constraint or L.no_constraint
    x = cons(_embed(params, cfg, token_ids, embeds), ("batch", None, "embed"))
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(params, x, cfg, positions=positions,
                     placement=placement, constraint=constraint, remat=remat)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


CE_CHUNK = 512


def _chunk_ce(params, cfg, x_c, y_c, m_c, constraint=None):
    """(−Σ log p(y) over the chunk's kept positions, their count); the
    chunk's logits in float32."""
    cons = constraint or L.no_constraint
    logits = cons(L.lm_head(params, x_c, cfg),
                  ("batch", None, "vocab")).float()
    if isinstance(logits, DTensor) and Shard(2) in logits.placements:
        nll = _vocab_parallel_nll(logits, y_c)
        return (nll * m_c).sum(), m_c.sum()
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    return -((picked - lse) * m_c).sum(), m_c.sum()


def _vocab_parallel_nll(logits, labels):
    """−log p(label) of vocab-sharded DTensor logits (B, S, V), a (B, S)
    DTensor: each rank's rows go through ``F.cross_entropy`` on the
    one-axis mesh that splits the vocab, where DTensor's
    ``loss_parallel`` rules (the train step enters them) reduce over the
    vocab shards in place of gathering the logits."""
    mesh = logits.device_mesh
    axis = list(logits.placements).index(Shard(2))
    rows = [Replicate() if i == axis else p
            for i, p in enumerate(logits.placements)]
    local = logits.to_local()
    b, s, _ = local.shape
    n, v = b * s, logits.shape[2]
    vocab = DTensor.from_local(local.reshape(n, -1),
                               mesh[mesh.mesh_dim_names[axis]], [Shard(1)],
                               run_check=False, shape=(n, v), stride=(v, 1))
    target = labels.redistribute(mesh, rows).to_local().reshape(-1)
    target = DTensor.from_local(target.long(), vocab.device_mesh,
                                [Replicate()], run_check=False)
    nll = F.cross_entropy(vocab, target, reduction="none").to_local()
    return DTensor.from_local(nll.reshape(b, s), mesh, rows,
                              run_check=False, shape=labels.shape,
                              stride=labels.stride())


def _chunked_ce(params, cfg, x, labels, mask, constraint=None):
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
                            constraint, use_reentrant=False)
        num, den = num + dn, den + dd
    return num / den.clamp_min(1.0)


def loss_fn(params, cfg: ModelConfig, batch, placement=None, constraint=None,
            remat=None):
    """Next-token (causal) or per-frame (encoder) cross-entropy, with the
    vocab projection chunked over the sequence; the MoE aux loss added
    at ``router_aux_weight``.  Returns (loss, aux)."""
    x, aux = forward_hidden(params, cfg, token_ids=batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            placement=placement, constraint=constraint,
                            remat=remat)
    labels = batch["labels"]
    if cfg.encoder_only:
        mask = (labels >= 0).float()
        tgt = labels.clamp_min(0)
    else:  # next-token: predict labels[t+1] from x[t]; last position void
        tgt = torch.cat([labels[:, 1:], labels[:, :1]], 1).clamp_min(0)
        mask = torch.cat([(labels[:, 1:] >= 0).float(),
                          torch.zeros_like(labels[:, :1], dtype=torch.float32)],
                         1)
    loss = _chunked_ce(params, cfg, x, tgt, mask, constraint)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["aux_loss"]
    return loss, aux
