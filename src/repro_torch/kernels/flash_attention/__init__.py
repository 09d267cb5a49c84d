from . import ops
from .autograd import FlashAttentionFn
from .ops import HEAD_DIMS, flash_attention
from .ref import attention_ref

__all__ = ["ops", "flash_attention", "attention_ref", "FlashAttentionFn",
           "HEAD_DIMS"]
