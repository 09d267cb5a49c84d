from . import ops
from .ops import MAX_EXPERTS, moe_histogram
from .ref import moe_histogram_ref

__all__ = ["ops", "moe_histogram", "moe_histogram_ref", "MAX_EXPERTS"]
