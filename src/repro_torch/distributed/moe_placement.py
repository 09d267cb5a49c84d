"""SWARM expert placement (SWARM-EP): the paper's protocol with experts
as partitions and EP shards as executor machines.

The MoE router's per-round expert histogram (kernels/moe_histogram — the
N' Statistics Collector) feeds the cost model; the decision FSM (Fig 9)
gates rebalancing; m_H sheds experts to m_L by *swapping* hot and cold
experts between the two shards (the permutation analogue of "move the
partition": only the placement table changes inside the step — weights
re-shard lazily at the next checkpoint boundary, and the old layout
keeps serving meanwhile, exactly like §5's partition chains).

Cost model: C(e) = N(e)·R(e) — N is the decayed historical token count
(the paper's N with the ÷2 fade), R the last-round arrivals.  The query
term Q has no MoE analogue (no standing queries over experts) and drops
out; the product structure and the two-scalar-per-machine wire format
are preserved.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import balancer


@dataclass
class ExpertBalancer:
    num_experts: int
    num_shards: int
    decay: float = 0.5
    beta: int = 20
    placement: np.ndarray = field(init=False)     # logical → physical slot
    n_ema: np.ndarray = field(init=False)
    decision: balancer.DecisionState = field(init=False)
    moves: int = field(init=False, default=0)

    def __post_init__(self):
        assert self.num_experts % self.num_shards == 0
        self.placement = np.arange(self.num_experts, dtype=np.int32)
        self.n_ema = np.zeros(self.num_experts, np.float64)
        self.decision = balancer.DecisionState()

    @property
    def per_shard(self) -> int:
        return self.num_experts // self.num_shards

    def shard_of_slot(self, slot) -> np.ndarray:
        return np.asarray(slot) // self.per_shard

    def shard_costs(self, counts: np.ndarray) -> np.ndarray:
        """counts: last-round logical-expert histogram (R(e))."""
        cost_e = self.n_ema * np.maximum(counts, 0.0)      # C(e) = N·R
        shard = self.shard_of_slot(self.placement)
        out = np.zeros(self.num_shards)
        np.add.at(out, shard, cost_e)
        return out

    def update(self, counts: np.ndarray) -> dict:
        """One SWARM round.  counts = expert histogram of the last round
        (logical ids).  Returns an action report."""
        counts = np.asarray(counts, np.float64)
        self.n_ema = self.n_ema * self.decay + counts
        r_s = float(counts.sum())
        self.decision, act = balancer.step_decision(self.decision, r_s, self.beta)
        report = {"decision": act, "swaps": [], "r_s": r_s}
        if act != balancer.REBALANCE:
            return report
        costs = self.shard_costs(counts)
        m_h = int(np.argmax(costs))
        m_l = int(np.argmin(costs))
        if m_h == m_l or costs[m_h] <= costs[m_l] * 1.05:
            return report
        report["m_h"], report["m_l"] = m_h, m_l
        gap = (costs[m_h] - costs[m_l]) / 2.0
        cost_e = self.n_ema * np.maximum(counts, 0.0)
        shard = self.shard_of_slot(self.placement)
        hot = [e for e in np.argsort(-cost_e) if shard[e] == m_h]
        cold = [e for e in np.argsort(cost_e) if shard[e] == m_l]
        moved = 0.0
        for eh, el in zip(hot, cold):
            delta = cost_e[eh] - cost_e[el]
            if delta <= 0 or moved + delta > gap * 1.5:
                break
            # swap physical slots → both shards keep their slot count
            ph, plo = self.placement[eh], self.placement[el]
            self.placement[eh], self.placement[el] = plo, ph
            shard[eh], shard[el] = m_l, m_h
            moved += delta
            self.moves += 1
            report["swaps"].append((int(eh), int(el)))
            if moved >= gap:
                break
        return report

    def imbalance(self, counts: np.ndarray) -> float:
        """max/mean shard load under the current placement."""
        shard = self.shard_of_slot(self.placement)
        load = np.zeros(self.num_shards)
        np.add.at(load, shard, np.asarray(counts, np.float64))
        mean = load.mean() if load.mean() > 0 else 1.0
        return float(load.max() / mean)
