from . import ops
from .ops import MAX_K, knn_match
from .ref import knn_match_ref, knn_match_split_ref

__all__ = ["ops", "knn_match", "knn_match_ref", "knn_match_split_ref",
           "MAX_K"]
