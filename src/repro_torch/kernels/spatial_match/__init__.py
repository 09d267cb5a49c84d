from . import ops
from .ops import spatial_match
from .ref import spatial_match_ref

__all__ = ["ops", "spatial_match", "spatial_match_ref"]
