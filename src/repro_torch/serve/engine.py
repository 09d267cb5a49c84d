"""Serving engine: prefill/decode step builders and a batched greedy
generation loop — the JAX package's ``serve/engine.py`` on PyTorch.

The builders take no mesh: the port runs on one card, and the
reference's mesh-only ``cache_shardings`` waits for
``distributed/sharding.py`` (ROADMAP Queue 1 item 9e).  Steps run eagerly
on the device of the parameters.
"""
from __future__ import annotations

import torch

from ..models import model as MODEL
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """decode_step as ``serve_step(params, cache, token_ids) → (logits,
    cache)``."""

    def serve_step(params, cache, token_ids):
        logits, new_cache, _ = MODEL.decode_step(params, cfg, cache,
                                                 token_ids)
        return logits, new_cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int | None = None):
    """prefill as ``prefill_step(params, **inputs) → (logits, cache)``."""

    def prefill_step(params, **inputs):
        logits, cache, _ = MODEL.prefill(params, cfg, max_seq=max_seq,
                                         **inputs)
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
