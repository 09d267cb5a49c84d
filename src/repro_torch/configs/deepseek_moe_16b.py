"""deepseek-moe-16b — fine-grained 64 routed top-6 + 2 shared
[arXiv:2401.06066; hf]."""
import dataclasses

from ..models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=102400,
        act="silu",
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared=2, d_ff_shared=1408))


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=6, d_ff_expert=96, num_shared=2,
                      d_ff_shared=96))
