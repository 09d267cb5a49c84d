"""Serving: prefill/decode step builders, SWARM request routing."""
from .engine import (cache_shardings, greedy_generate, make_prefill_step,
                     make_serve_step)
from .router import SwarmRequestRouter

__all__ = ["make_serve_step", "make_prefill_step", "greedy_generate",
           "cache_shardings",
           "SwarmRequestRouter"]
