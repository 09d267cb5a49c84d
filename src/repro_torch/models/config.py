"""Model configuration schema covering all ten assigned architectures
(the JAX package's ``models/config.py``; only ``param_count`` differs:
it walks the port's spec with NumPy instead of ``jax.tree``)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0          # per shared expert; 0 → d_ff_expert
    layer_period: int = 1         # MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @property
    def shared_ff(self) -> int:
        return self.d_ff_shared or self.d_ff_expert


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand · d_model
    dt_rank: int = 0              # 0 → ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_period: int = 8         # one sLSTM block per this many layers
    conv_kernel: int = 4
    qk_dim_factor: float = 0.5
    proj_factor: float = 2.0      # mLSTM up-projection


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                     # dense-FFN width (0 for pure-SSM archs)
    vocab_size: int
    head_dim: int = 0             # 0 → d_model // num_heads
    act: str = "silu"             # silu (SwiGLU) | gelu_glu (GeGLU) | gelu (plain)
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    moe: MoEConfig | None = None
    attn_layer_period: int = 1    # jamba: 8 → one attention layer per period
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    encoder_only: bool = False
    frontend: str | None = None   # "patch" (vlm) | "frame" (audio) stubs
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"       # compute dtype; params are fp32 masters

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid/sliding-window archs)."""
        return (self.family in ("hybrid", "ssm")
                or self.sliding_window is not None)

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def param_count(self) -> int:
        """Exact parameter count (for roofline MODEL_FLOPS), from the
        port's own parameter spec."""
        import numpy as np
        from . import layers as _l
        from . import model as _m
        return int(sum(np.prod(lf["shape"]) for lf in
                       _l.spec_leaves(_m.param_spec(self))))
