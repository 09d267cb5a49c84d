"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887; hf]."""
import dataclasses

from ..models.config import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
        act="silu", attn_layer_period=8,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                      layer_period=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2))


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, attn_layer_period=8,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, layer_period=2),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2))
