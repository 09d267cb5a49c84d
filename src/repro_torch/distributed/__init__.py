"""Distribution: SWARM expert placement.  The reference's mesh-aware
``sharding`` module is not ported yet (ROADMAP Queue 1 item 9e)."""
from .moe_placement import ExpertBalancer

__all__ = ["ExpertBalancer"]
