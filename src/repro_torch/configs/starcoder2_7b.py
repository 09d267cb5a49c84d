"""starcoder2-7b — dense GQA, plain-GELU FFN, RoPE [arXiv:2402.19173; hf]."""
import dataclasses

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense", num_layers=32, d_model=4608,
        num_heads=36, num_kv_heads=4, d_ff=18432, vocab_size=49152,
        act="gelu", rope_theta=1e5)


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=2, d_model=72,
                               num_heads=6, num_kv_heads=2, d_ff=128,
                               vocab_size=128)
