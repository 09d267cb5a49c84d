"""xlstm-1.3b — sLSTM + mLSTM blocks (1:7), no separate FFN (d_ff=0)
[arXiv:2405.04517]."""
import dataclasses

from ..models.config import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
        xlstm=XLSTMConfig(slstm_period=8))


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), num_layers=8, d_model=64,
                               num_heads=4, num_kv_heads=4, vocab_size=128,
                               xlstm=XLSTMConfig(slstm_period=8))
