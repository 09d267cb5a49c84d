from . import ops
from .ops import keyword_match
from .ref import keyword_match_ref

__all__ = ["ops", "keyword_match", "keyword_match_ref"]
