"""Distribution: SWARM expert placement, and the logical-axis sharding
rules on DTensor (``sharding``)."""
from .moe_placement import ExpertBalancer

__all__ = ["ExpertBalancer"]
