"""Assigned-architecture configs (one module per arch) + registry.

Every config is the exact published setting from the assignment table;
``smoke()`` returns the reduced same-family variant used by the CPU
smoke tests; full configs are exercised only via the dry-run.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import MambaConfig, ModelConfig, MoEConfig, XLSTMConfig

ARCH_IDS = [
    "internlm2_1_8b", "gemma_7b", "starcoder2_7b", "h2o_danube_1_8b",
    "jamba_v0_1_52b", "qwen2_moe_a2_7b", "deepseek_moe_16b", "pixtral_12b",
    "hubert_xlarge", "xlstm_1_3b",
]

SHAPES = {
    # name: (kind, seq_len, global_batch)
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f".{arch_id}", __package__)
    return mod.config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f".{arch_id}", __package__)
    return mod.smoke()


def shape_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Skip rules from the assignment (recorded in DESIGN.md)."""
    kind = SHAPES[shape][0]
    if kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch skips long_500k (quadratic)"
    return True, ""


def _shrink(cfg: ModelConfig, **over) -> ModelConfig:
    return dataclasses.replace(cfg, **over)
