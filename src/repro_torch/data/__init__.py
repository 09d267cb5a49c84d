"""Data pipeline: synthetic streams + prefetch."""
from .pipeline import PrefetchIterator, TokenStream, make_batch_iterator

__all__ = ["TokenStream", "make_batch_iterator", "PrefetchIterator"]
