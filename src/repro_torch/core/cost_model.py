"""SWARM probabilistic cost model (paper §3, Eqns 1–7).

    C(p)   = N(p) · Q(p) · Prob(p),   Prob(p) = R(p) / R(S)
    C(m)   = Σ_p C(p) = Num(C(m)) / R(S)

The numerator Num(C(m)) = Σ_p N(p)Q(p)R(p) is computable *locally*; the
Coordinator only ever needs the pair (Num(C(m)), R(m)) from each machine
— two scalars — to rank every machine by cost (Eqn 7).  That pair is the
entire per-round wire format (benchmarks/stats_network.py, Fig 20).

Under the STORED data-persistence model (repro.queries) the per-machine
report carries one extra scalar, D(m) = resident stored tuples, and the
partition product uses Ñ(p) = N(p) + γ·D(p) — probes over stored data
scan what is resident, not just what arrived (``effective_n``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CostReport:
    """What one executor machine sends the Coordinator each round."""

    machine: int
    num_cost: float  # Num(C(m)) = Σ_p N(p)·Q(p)·R(p)
    r_m: float       # R(m)      = Σ_p R(p)
    d_m: float = 0.0  # D(m)     = Σ_p resident stored tuples (STORED mode)

    WIRE_BYTES = 16         # two float64 scalars — Fig 20 accounting
    WIRE_BYTES_STORED = 24  # + one scalar when resident data is reported


def effective_n(n_p, d_p=None, data_weight: float = 0.0):
    """N(p) with the resident-data term: Ñ(p) = N(p) + γ·D(p).

    The paper's N(p) is the (decayed) arrival count; under the STORED
    persistence model a probe additionally scans the partition-resident
    tuples D(p), so D enters the cost product with weight γ
    (repro.queries.WorkloadSpec.data_weight).  γ=0 reproduces the paper.
    """
    n = np.asarray(n_p, np.float64)
    if d_p is None or data_weight == 0.0:
        return n
    return n + data_weight * np.asarray(d_p, np.float64)


def partition_cost_numerator(n_p, q_p, r_p, d_p=None,
                             data_weight: float = 0.0):
    """Num(C(p)) = Ñ(p)·Q(p)·R(p); vectorized."""
    return (effective_n(n_p, d_p, data_weight) * np.asarray(q_p)
            * np.asarray(r_p))


def machine_reports(part_n, part_q, part_r, part_owner, num_machines: int,
                    part_d=None, data_weight: float = 0.0):
    """Aggregate per-partition totals into per-machine CostReports.

    part_*: (P,) arrays of partition totals; part_owner: (P,) int machine
    ids (−1 for dead/retired partitions, excluded).  ``part_d`` (optional)
    adds the STORED resident-data term.
    """
    num = partition_cost_numerator(part_n, part_q, part_r, part_d, data_weight)
    part_d = (np.zeros_like(np.asarray(part_r, np.float64))
              if part_d is None else np.asarray(part_d, np.float64))
    reports = []
    for m in range(num_machines):
        sel = part_owner == m
        reports.append(CostReport(m, float(num[sel].sum()),
                                  float(np.asarray(part_r)[sel].sum()),
                                  float(part_d[sel].sum())))
    return reports


def total_rate(reports) -> float:
    """R(S) = Σ_m R(m)  (Eqn 4)."""
    return float(sum(r.r_m for r in reports))


def machine_costs(reports, r_s: float | None = None):
    """C(m) for every machine (Eqn 7).  Returns (costs array, R(S))."""
    if r_s is None:
        r_s = total_rate(reports)
    denom = r_s if r_s > 0 else 1.0
    costs = np.array([r.num_cost / denom for r in reports], np.float64)
    return costs, r_s


def rank_machines(reports):
    """Machines sorted by cost descending → (order, costs, R(S)).

    order[0] is m_H (highest cost), order[-1] is m_L (lowest)."""
    costs, r_s = machine_costs(reports)
    order = np.argsort(-costs, kind="stable")
    return order, costs, r_s


# ---------------------------------------------------------------------------
# Pub/sub delivery fan-out
# ---------------------------------------------------------------------------

DELIVERY_WIRE_BYTES = 48   # one matched-notification envelope on the wire


def delivery_wire_bytes(deliveries: float, bytes_per_delivery: int) -> int:
    """Wire bytes billed for subscription fan-out: every expected
    delivery ships one notification envelope to its subscriber.  The
    spatial-keyword workload sets ``bytes_per_delivery``
    (WorkloadSpec.delivery_bytes); 0 disables the billing so
    pure-spatial runs are untouched."""
    if bytes_per_delivery <= 0:
        return 0
    return int(round(float(deliveries) * bytes_per_delivery))
