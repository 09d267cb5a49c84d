"""SWARM adaptive load balancing (paper §4.3).

Three pieces:

* the 5-stage flip/hysteresis decision FSM (Fig 9) deciding *whether*
  to rebalance this round;
* Algorithm 3 — greedy ½-approximation subset-sum over m_H's partitions
  (move whole partitions to m_L);
* the best-split search — find the split point sp of one partition that
  zeroes C_diff.  The paper binary-searches the rows/cols (4 searches);
  we additionally provide the TPU-native *vectorized* search that
  evaluates C_diff for every split point in one fused pass and takes the
  exact argmin (C_diff is not monotone in general, so this is both
  faster on TPU and strictly more accurate — see DESIGN.md §3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from . import statistics as S

DO_NOTHING = 0
REBALANCE = 1

NUM_STAGES = 5
START_STAGE = NUM_STAGES // 2  # middle


# ---------------------------------------------------------------------------
# Decision FSM (Fig 9)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecisionState:
    stage: int = START_STAGE
    decision: int = DO_NOTHING
    same_count: int = 0
    pre_rs: float = -1.0  # R(S) of the previous round


def step_decision(ds: DecisionState, r_s: float, beta: int = 20):
    """One FSM step.  Move right when throughput improved (R(S) >
    preR(S)), left otherwise; flip the decision at the leftmost stage or
    after beta consecutive same decisions (anti-stick rule)."""
    improved = r_s > ds.pre_rs
    stage = min(ds.stage + (1 if improved else -1), NUM_STAGES - 1)
    decision, same = ds.decision, ds.same_count + 1
    if stage <= 0 or same >= beta:
        decision = 1 - decision
        stage, same = START_STAGE, 0
    return DecisionState(stage, decision, same, r_s), decision


# ---------------------------------------------------------------------------
# Algorithm 3: greedy subset-sum (½-approximation after the descending sort)
# ---------------------------------------------------------------------------

def find_subset(part_ids: np.ndarray, part_costs: np.ndarray,
                c_mh: float, c_ml: float):
    """Best subset of m_H's partitions to move to m_L.

    Returns (moved ids, total moved cost, sorted order) — the order is
    reused by the split search (paper: "sorting ... is necessary for the
    splitting algorithm").  Empty when nothing fits under C_max.
    """
    c_max = (c_mh - c_ml) / 2.0
    order = np.argsort(-part_costs, kind="stable")
    total = 0.0
    subset = []
    for k in order:
        c = float(part_costs[k])
        if c > 0 and total + c <= c_max:
            total += c
            subset.append(int(part_ids[k]))
            if total == c_max:
                break
    return subset, total, part_ids[order]


# ---------------------------------------------------------------------------
# Split search
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplitPlan:
    pid: int
    axis: str          # "row" | "col"
    sp: int            # global row/col index of the split (lo side ends at sp)
    move_lo: bool      # move the prefix side (True) or the suffix side
    c_diff: float      # achieved |C_diff| (signed value stored)
    c_lo: float
    c_hi: float


def product_cost(n, q, r, area, r_s):
    """The paper's Eqn 5: C = N·Q·R / R(S)."""
    denom = r_s if r_s > 0 else 1.0
    return n * q * r / denom


def make_rate_cost(c0: float = 1.0, kappa_probe: float = 1.0,
                   kappa_match: float = 1.0, query_area: float = 0.02 ** 2):
    """Beyond-paper cost model: predicted tuple rate × per-tuple work,
    C(p) = R(p)·(c0 + κp·log2(1+Q(p)) + κm·Q(p)·a_q/A(p)).

    Still fully local (two scalars per machine on the wire); fixes the
    product model's blindness to zero-query partitions and its cubic
    scale distortion.  See EXPERIMENTS.md §Beyond-paper."""
    def cost(n, q, r, area, r_s):
        density = np.minimum(query_area / np.maximum(area, 1e-12), 1.0)
        return r * (c0 + kappa_probe * np.log2(1.0 + np.maximum(q, 0.0))
                    + kappa_match * q * density)
    return cost


def _split_terms(st: S.StatsState, pid: int, axis: str, a0: int, a1: int,
                 r_s: float, box, cost_fn=product_cost):
    """C(p1), C(p2) for every split point sp in [a0 .. a1-1] (Eqns §4.3.2)."""
    bank = st.rows if axis == "row" else st.cols
    g = st.grid_size
    sp = np.arange(a0, a1)                       # candidate split points
    n_sp = bank[S.N, pid, sp]
    q_sp = bank[S.Q, pid, sp]
    r_sp = bank[S.R, pid, sp]
    n_tot = bank[S.N, pid, a1]
    q_tot = bank[S.Q, pid, a1]
    r_tot = bank[S.R, pid, a1]
    span_next = bank[S.SPANQ, pid, sp + 1]
    prespan_next = bank[S.PRESPANQ, pid, sp + 1]
    q_hi = q_tot - q_sp + span_next
    r_hi = r_tot - r_sp + prespan_next
    # areas of the two sides (normalized to the unit square)
    r0, c0_, r1, c1 = box
    ortho = (c1 - c0_ + 1) if axis == "row" else (r1 - r0 + 1)
    a_lo = (sp - a0 + 1) * ortho / (g * g)
    a_hi = (a1 - sp) * ortho / (g * g)
    c_lo = cost_fn(n_sp, q_sp, r_sp, a_lo, r_s)
    c_hi = cost_fn(n_tot - n_sp, q_hi, r_hi, a_hi, r_s)
    return sp, c_lo, c_hi


def find_best_split(st: S.StatsState, pid: int, box, c_mh: float, c_ml: float,
                    c_p: float, r_s: float, cost_fn=product_cost) -> SplitPlan | None:
    """Vectorized exact search: evaluate C_diff at *every* split point on
    both axes and both move directions; return the argmin |C_diff|.

    box = (r0, c0, r1, c1).  None when the partition is cell-sized.
    """
    r0, c0, r1, c1 = box
    base = (c_mh - c_p) - c_ml  # C_diff = base + C(keep) − C(move)
    best: SplitPlan | None = None
    for axis, a0, a1 in (("row", r0, r1), ("col", c0, c1)):
        if a1 <= a0:
            continue
        sp, c_lo, c_hi = _split_terms(st, pid, axis, a0, a1, r_s, box, cost_fn)
        for move_lo in (True, False):
            keep, move = (c_hi, c_lo) if move_lo else (c_lo, c_hi)
            c_diff = base + keep - move
            k = int(np.argmin(np.abs(c_diff)))
            cand = SplitPlan(pid, axis, int(sp[k]), move_lo, float(c_diff[k]),
                             float(c_lo[k]), float(c_hi[k]))
            if best is None or abs(cand.c_diff) < abs(best.c_diff):
                best = cand
            if best is not None and best.c_diff == 0.0:
                return best
    return best


def split_binary_search(st: S.StatsState, pid: int, box, c_mh: float,
                        c_ml: float, c_p: float, r_s: float,
                        cost_fn=product_cost) -> SplitPlan | None:
    """Paper-faithful variant: 4 binary searches (2 axes × 2 directions),
    assuming C_diff is monotone in sp for a fixed direction.  Kept for
    parity experiments; `find_best_split` dominates it on TPU."""
    r0, c0, r1, c1 = box
    base = (c_mh - c_p) - c_ml
    best: SplitPlan | None = None
    for axis, a0, a1 in (("row", r0, r1), ("col", c0, c1)):
        if a1 <= a0:
            continue
        sp_all, c_lo, c_hi = _split_terms(st, pid, axis, a0, a1, r_s, box, cost_fn)
        for move_lo in (True, False):
            keep, move = (c_hi, c_lo) if move_lo else (c_lo, c_hi)
            c_diff = base + keep - move
            lo, hi = 0, len(sp_all) - 1
            # moving the prefix: C(move) grows with sp → C_diff decreases;
            # moving the suffix: C_diff increases.  Search the crossing.
            increasing = not move_lo
            while lo < hi:
                mid = (lo + hi) // 2
                v = c_diff[mid]
                if (v < 0) == increasing:
                    lo = mid + 1
                else:
                    hi = mid
            # examine the crossing neighbourhood
            for k in (lo - 1, lo, lo + 1):
                if 0 <= k < len(sp_all):
                    cand = SplitPlan(pid, axis, int(sp_all[k]), move_lo,
                                     float(c_diff[k]), float(c_lo[k]), float(c_hi[k]))
                    if best is None or abs(cand.c_diff) < abs(best.c_diff):
                        best = cand
    return best


# ---------------------------------------------------------------------------
# Workload reduction driver (§4.3.2): subset first, then split.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReductionPlan:
    kind: str                       # "subset" | "split" | "none"
    subset: tuple[int, ...] = ()
    split: SplitPlan | None = None


def find_workload_reduction(st: S.StatsState, part_ids: np.ndarray,
                            part_costs: np.ndarray, boxes, c_mh: float,
                            c_ml: float, r_s: float,
                            use_binary_search: bool = False,
                            cost_fn=product_cost) -> ReductionPlan:
    """m_H's local search: try Algorithm 3; if no subset fits, split the
    largest-cost splittable partition (next-largest on failure)."""
    subset, total, sorted_ids = find_subset(part_ids, part_costs, c_mh, c_ml)
    if subset and total > 0:
        return ReductionPlan("subset", tuple(subset))
    cost_of = {int(p): float(c) for p, c in zip(part_ids, part_costs)}
    search = split_binary_search if use_binary_search else find_best_split
    for pid in sorted_ids:
        pid = int(pid)
        box = boxes[pid]
        if box[2] <= box[0] and box[3] <= box[1]:
            continue  # cell-sized — cannot split (paper §4.1.1 / Fig 3c)
        plan = search(st, pid, box, c_mh, c_ml, cost_of[pid], r_s, cost_fn)
        if plan is not None:
            return ReductionPlan("split", split=plan)
    return ReductionPlan("none")
