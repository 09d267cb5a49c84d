"""Serving engine: prefill/decode step builders, the decode cache's mesh
shardings, and a batched greedy generation loop — the JAX package's
``serve/engine.py`` on PyTorch.

Steps run eagerly on the device of the parameters.  A sharded run
passes the step builders ``distributed.sharding.make_constraint(mesh)``,
its parameters placed by ``param_shardings`` and its cache by
:func:`cache_shardings` (``distributed.sharding.shard_params``).
"""
from __future__ import annotations

import torch

from ..distributed import sharding as SH
from ..launch.mesh import axis_names, data_parallel_size, mesh_shape
from ..models import model as MODEL
from ..models.config import ModelConfig


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                    *, seq_shard_long: bool = True):
    """Shardings for the decode cache (``models.cache_spec``'s keys; the
    offset, a Python int, has none).  Batch shards over (pod, data);
    when the batch does not split over them (long-context, batch 1) the
    KV sequence dim shards over "data" instead (flash-decoding style),
    and recurrent states shard their channel dim.

    The reference's rules on the port's layout: each state is (layers of
    its mixer, B, …) where the reference's is (periods, n, B, …), and K
    and V are (layers, B, Hkv, S, Dh) where the reference's are
    (periods, n, B, S, Hkv, Dh)."""
    rules = SH.resolve_rules(mesh)
    shape, names = mesh_shape(mesh), axis_names(mesh)
    batch_axes = rules["batch"]
    dp = data_parallel_size(mesh)
    batch_ok = batch % dp == 0 and batch >= dp
    seq_axis = "data" if ("data" in names and not batch_ok
                          and seq_shard_long) else None
    model = shape["model"]
    out = {}
    for k, (dims, _dt) in MODEL.cache_spec(cfg, batch, max_seq).items():
        if k == "offset":
            continue
        spec = [None] * len(dims)
        # layout: (layers, batch, ...)
        if batch_ok:
            spec[1] = batch_axes
        if k in ("kv_k", "kv_v"):
            # (L, B, Hkv, S, Dh): heads over model when divisible;
            # otherwise shard the SEQUENCE over "model" (flash-decoding
            # layout — K6 has no rule for it, so DTensor gathers the
            # shards before attention)
            if dims[2] % model == 0:
                spec[2] = "model"
            elif dims[3] % model == 0:
                spec[3] = "model"
            if seq_axis and spec[3] is None and \
                    dims[3] % shape[seq_axis] == 0:
                spec[3] = seq_axis
        elif k in ("mamba_h", "mamba_conv"):
            # channel dim (d_inner) over model
            ch_dim = 2 if k == "mamba_h" else 3
            if dims[ch_dim] % model == 0:
                spec[ch_dim] = "model"
        elif k.startswith("mlstm"):
            if len(dims) >= 3 and dims[2] % model == 0:
                spec[2] = "model"   # heads over model
        elif k.startswith("slstm"):
            if dims[-1] % model == 0:
                spec[-1] = "model"
        out[k] = SH.NamedSharding(mesh, tuple(spec))
    return out


def make_serve_step(cfg: ModelConfig, constraint=None):
    """decode_step as ``serve_step(params, cache, token_ids) → (logits,
    cache)``."""

    def serve_step(params, cache, token_ids):
        logits, new_cache, _ = MODEL.decode_step(params, cfg, cache,
                                                 token_ids,
                                                 constraint=constraint)
        return logits, new_cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int | None = None,
                      constraint=None):
    """prefill as ``prefill_step(params, **inputs) → (logits, cache)``;
    ``inputs`` may hold the ``cache`` to fill (a sharded run's)."""

    def prefill_step(params, **inputs):
        logits, cache, _ = MODEL.prefill(params, cfg, max_seq=max_seq,
                                         constraint=constraint, **inputs)
        return logits, cache

    return prefill_step


def greedy_generate(cfg: ModelConfig, params, prompt_tokens, steps: int,
                    max_seq: int | None = None):
    """Simple batched greedy decoding: prompt_tokens (B, S) → (B, steps)
    int32 generated tokens."""
    max_seq = max_seq or (prompt_tokens.shape[1] + steps)
    logits, cache, _ = MODEL.prefill(params, cfg, token_ids=prompt_tokens,
                                     max_seq=max_seq)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        logits, cache, _ = MODEL.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, 1)
