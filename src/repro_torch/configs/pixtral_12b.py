"""pixtral-12b — pixtral-ViT frontend (STUB: precomputed patch embeds)
over a mistral-nemo decoder backbone [hf:mistralai/Pixtral-12B-2409]."""
import dataclasses

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", num_layers=40, d_model=5120,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=131072, act="silu", rope_theta=1e6, frontend="patch")


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=2, d_model=64,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               d_ff=128, vocab_size=128)
