"""h2o-danube-1.8b — llama/mistral mix with sliding-window attention
[arXiv:2401.16818; hf].  SWA makes it long_500k-eligible."""
import dataclasses

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense", num_layers=24, d_model=2560,
        num_heads=32, num_kv_heads=8, d_ff=6912, vocab_size=32000,
        act="silu", sliding_window=4096)


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=2, d_model=64,
                               num_heads=4, num_kv_heads=2, d_ff=128,
                               vocab_size=128, sliding_window=16)
