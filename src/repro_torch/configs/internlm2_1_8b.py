"""internlm2-1.8b — dense GQA decoder [arXiv:2403.17297; hf]."""
import dataclasses

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92544,
        act="silu", rope_theta=1e6)


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=2, d_model=64,
                               num_heads=4, num_kv_heads=2, d_ff=128,
                               vocab_size=128)
