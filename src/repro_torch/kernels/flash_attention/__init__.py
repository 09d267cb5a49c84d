from . import ops
from .ops import HEAD_DIMS, flash_attention
from .ref import attention_ref

__all__ = ["ops", "flash_attention", "attention_ref", "HEAD_DIMS"]
