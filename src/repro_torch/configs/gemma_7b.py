"""gemma-7b — dense, GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
import dataclasses

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense", num_layers=28, d_model=3072,
        num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
        vocab_size=256000, act="gelu_glu", tie_embeddings=True)


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=2, d_model=64,
                               num_heads=4, num_kv_heads=4, head_dim=16,
                               d_ff=128, vocab_size=128)
