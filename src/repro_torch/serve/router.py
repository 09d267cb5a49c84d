"""SWARM request routing for serving (DESIGN.md §4, item 2).

Sessions (resident KV caches = the paper's continuous queries) are
hashed into SWARM's unit square; each generated token is a data point at
the session's location.  The *unmodified* spatial protocol then balances
decode load across replica groups: hotspot prompts (a viral prefix, a
burst tenant) concentrate in hash-space exactly like spatial hotspots,
and m_H sheds them to m_L with the usual subset/split moves.  Session
migration moves only the session entry (the "query"); the old replica
keeps serving the chain until the session window closes (§5.2) so no
token is dropped — KV caches are never copied.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import Swarm


def _hash_to_point(session_ids: np.ndarray) -> np.ndarray:
    """Deterministic session → [0,1)² (splitmix-style)."""
    x = np.asarray(session_ids, np.uint64)
    z = (x + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    a = (z & np.uint64(0xFFFFFFFF)).astype(np.float64) / 2 ** 32
    b = (z >> np.uint64(32)).astype(np.float64) / 2 ** 32
    return np.stack([a, b], -1).astype(np.float32)


@dataclass
class SwarmRequestRouter:
    """Routes decode traffic for resident sessions across replicas."""

    num_replicas: int
    grid_size: int = 64
    beta: int = 8
    swarm: Swarm = field(init=False)
    session_pt: dict = field(init=False, default_factory=dict)

    def __post_init__(self):
        self.swarm = Swarm(self.grid_size, self.num_replicas, beta=self.beta,
                           decay=0.5, smoothing=1.0)

    def admit(self, session_ids) -> np.ndarray:
        """Register new sessions (the 'queries').  Returns replica ids."""
        pts = _hash_to_point(np.asarray(session_ids))
        for sid, pt in zip(np.asarray(session_ids).ravel(), pts):
            self.session_pt[int(sid)] = pt
        side = 1.0 / self.grid_size
        rects = np.concatenate([pts, pts + side * 0.5], axis=1)
        self.swarm.ingest_queries(rects.astype(np.float32))
        return self.route(session_ids)

    def route(self, session_ids) -> np.ndarray:
        pts = _hash_to_point(np.asarray(session_ids))
        return self.swarm.ingest_points(pts.astype(np.float32))

    def step_tokens(self, session_ids) -> np.ndarray:
        """Account one generated token per session; returns replica ids."""
        return self.route(session_ids)

    def rebalance(self):
        return self.swarm.run_round()

    def replica_loads(self) -> np.ndarray:
        return self.swarm.machine_loads()
