from . import ops
from .ops import MAX_K, knn_match
from .ref import knn_match_ref

__all__ = ["ops", "knn_match", "knn_match_ref", "MAX_K"]
