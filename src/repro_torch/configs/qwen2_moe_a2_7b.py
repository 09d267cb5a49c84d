"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
import dataclasses

from ..models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
        act="silu",
        moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                      num_shared=4, d_ff_shared=1408))


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=96, num_shared=2,
                      d_ff_shared=96))
