"""Model zoo on PyTorch: every family of the JAX package's ``models``
(dense, moe, vlm, audio, the Mamba hybrid and the xLSTM ssm), with
attention on kernel K6 and the MoE expert histogram on kernel K5; the
recurrences are ``torch.library`` ops whose implementation is a loop of
torch ops (``scan_ops``)."""
from .config import MambaConfig, ModelConfig, MoEConfig, XLSTMConfig
from .convert import from_jax_layout, from_jax_params, to_jax_layout
from .model import (abstract_cache, abstract_params, cache_spec,
                    decode_step, forward, forward_hidden, init_cache,
                    init_params, loss_fn, param_spec, prefill)

__all__ = [
    "ModelConfig", "MoEConfig", "MambaConfig", "XLSTMConfig",
    "param_spec", "abstract_params", "init_params", "forward", "prefill",
    "decode_step", "forward_hidden", "loss_fn", "cache_spec", "init_cache",
    "abstract_cache",
    "from_jax_params", "to_jax_layout", "from_jax_layout",
]
