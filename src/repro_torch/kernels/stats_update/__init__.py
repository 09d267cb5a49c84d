from . import ops
from .ops import IN_CH, OUT_CH, close_round_inputs
from .ref import close_round_inputs_ref, close_round_ref

__all__ = ["ops", "close_round_inputs", "close_round_inputs_ref",
           "close_round_ref", "IN_CH", "OUT_CH"]
