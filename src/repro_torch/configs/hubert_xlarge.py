"""hubert-xlarge — encoder-only audio backbone (frame-embedding frontend
STUB) [arXiv:2106.07447].  No decode step (encoder-only)."""
import dataclasses

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
        num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
        act="gelu", encoder_only=True, frontend="frame")


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=2, d_model=64,
                               num_heads=4, num_kv_heads=4, d_ff=128,
                               vocab_size=64)
