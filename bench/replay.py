"""The benchmark's own event source: it hands the engine the batches that
set-up generated, by ``tick mod cycle``, through the interface the
engine's ``EventStream`` reads (``sample_points``, ``sample_terms``,
``query_arrivals`` and the arrival schedule).  Nothing here draws a
random number.

Continuous queries never expire in the engine, so a query burst is
handed over in the first cycle only, which set-up runs: the window then
replays the tuple stream against a fixed standing set.  The plan is not
fixed: the program only ever splits partitions, so the live partitions,
and with them the re-indexing of a rebalancing round, keep growing
through the window, and a faster program, which gets through more
rounds, meets more of them.
"""
from __future__ import annotations

import numpy as np


class ReplaySource:
    def __init__(self, traffic):
        self.traffic = traffic
        self.cycle = traffic.cycle
        self._burst_ticks = sorted(traffic.burst)

    def sample_points(self, n: int, tick: int) -> np.ndarray:
        return self.traffic.points[tick % self.cycle, :n]

    def sample_terms(self, xy: np.ndarray, tick: int, k: int) -> np.ndarray:
        return self.traffic.terms[tick % self.cycle, :len(xy), :k]

    def query_arrivals(self, tick: int) -> np.ndarray:
        if tick in self.traffic.burst:
            return self.traffic.burst[tick][0]
        return np.zeros((0, 4), np.float32)

    def sample_subscription_terms(self, n: int, tick: int,
                                  k: int) -> np.ndarray:
        terms = self.traffic.burst[tick][1]
        if terms is None or len(terms) != n:
            raise ValueError(f"no generated terms for {n} queries at "
                             f"tick {tick}")
        return terms[:, :k]

    def next_query_arrival(self, tick: int) -> int | None:
        later = [t for t in self._burst_ticks if t >= tick]
        return later[0] if later else None
