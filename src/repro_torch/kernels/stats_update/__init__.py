from . import ops
from .ops import (IN_CH, OUT_CH, blocked_cumsum, close_live, close_round,
                  close_round_inputs, close_round_xla)
from .ref import close_live_ref, close_round_inputs_ref, close_round_ref

__all__ = ["ops", "close_round", "close_round_inputs", "close_round_xla",
           "close_live", "blocked_cumsum", "close_round_inputs_ref",
           "close_round_ref", "close_live_ref", "IN_CH", "OUT_CH"]
