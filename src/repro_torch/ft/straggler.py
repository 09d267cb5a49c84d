"""Straggler mitigation for the training fleet via the SWARM decision
machinery (DESIGN.md §4 item 3).

Per-host step-time statistics play the role of the workload stats; the
Fig-9 FSM keeps the system from over-reacting to one slow step (the
paper's "do not over-react to transient changes").  When a host is
confirmed slow, its share of the data shards is reduced (m_H → m_L data
reassignment) — no barrier, no restart.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import balancer


@dataclass
class StragglerMitigator:
    num_hosts: int
    threshold: float = 1.3             # step time vs fleet median
    ema: float = 0.5
    beta: int = 8
    step_time: np.ndarray = field(init=False)
    shares: np.ndarray = field(init=False)   # data-shard share per host
    decision: balancer.DecisionState = field(init=False)

    def __post_init__(self):
        self.step_time = np.zeros(self.num_hosts)
        self.shares = np.ones(self.num_hosts) / self.num_hosts
        self.decision = balancer.DecisionState()

    def observe(self, times: np.ndarray) -> dict:
        """times: per-host wall time of the last step."""
        times = np.asarray(times, np.float64)
        self.step_time = np.where(self.step_time == 0, times,
                                  self.ema * self.step_time + (1 - self.ema) * times)
        # throughput proxy: inverse of the slowest host (the step barrier)
        r_s = 1.0 / max(self.step_time.max(), 1e-9)
        self.decision, act = balancer.step_decision(self.decision, r_s, self.beta)
        report = {"decision": act, "moved": 0.0}
        if act != balancer.REBALANCE:
            return report
        med = np.median(self.step_time)
        m_h = int(np.argmax(self.step_time))
        m_l = int(np.argmin(self.step_time))
        if self.step_time[m_h] < self.threshold * med or m_h == m_l:
            return report
        # shift shards proportional to the slowdown, bounded
        excess = (self.step_time[m_h] / med - 1.0)
        delta = min(self.shares[m_h] * min(excess, 0.5), self.shares[m_h] * 0.5)
        self.shares[m_h] -= delta
        self.shares[m_l] += delta
        report.update(m_h=m_h, m_l=m_l, moved=float(delta))
        return report

    def host_batch_sizes(self, global_batch: int) -> np.ndarray:
        raw = np.floor(self.shares * global_batch).astype(int)
        raw[np.argmax(raw)] += global_batch - raw.sum()
        return raw
