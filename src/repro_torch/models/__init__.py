"""Model zoo on PyTorch: the attention families of the JAX package's
``models`` (dense, moe, vlm, audio), with attention on kernel K6 and the
MoE expert histogram on kernel K5."""
from .config import MambaConfig, ModelConfig, MoEConfig, XLSTMConfig
from .convert import from_jax_params
from .model import (cache_spec, decode_step, forward, init_cache,
                    init_params, param_spec, prefill)

__all__ = [
    "ModelConfig", "MoEConfig", "MambaConfig", "XLSTMConfig",
    "param_spec", "init_params", "forward", "prefill", "decode_step",
    "cache_spec", "init_cache", "from_jax_params",
]
