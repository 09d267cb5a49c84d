"""SWARM core: the paper's contribution as a composable library.

Public surface:
  - Swarm           — the full adaptive protocol (protocol.py)
  - StatsState      — partition statistics bank (statistics.py)
  - GlobalIndex     — routing grid + Algorithm 1 (global_index.py)
  - cost_model      — Eqns 1–7
  - balancer        — FSM, Algorithm 3, split search
"""
from . import balancer, cost_model, geometry, integrity, statistics
from .global_index import GlobalIndex, PartitionTable
from .protocol import RoundReport, Swarm
from .statistics import StatsState

__all__ = [
    "Swarm", "RoundReport", "StatsState", "GlobalIndex", "PartitionTable",
    "balancer", "cost_model", "geometry", "integrity", "statistics",
]
