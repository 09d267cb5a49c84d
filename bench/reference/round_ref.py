"""The plain reference of SWARM's round decision (paper §4.3): from the
statistics the round close left and the plan and decision state the
round started from, the plan the round must end with, its transfers and
the standing queries they move.

Plain PyTorch on the CPU in a dtype the caller names (``float64`` the
reference, ``bfloat16`` the control); it imports nothing of the
program.  The deployment's choices, as its configuration runs them:
the paper's cost C(p) = N·Q·R / R(S) (Eqn 5), one m_H → m_L reduction a
round, the exact search over every split point, no failed machines.

* report: each live partition reads N, Q, R at the end of its row
  bank; a machine's cost is the sum of its partitions' costs (scaled
  by the partitions' R(S), over the machines' R(S));
* decision (Fig 9): move right when R(S) grew since the last round,
  left otherwise; flip the decision at the leftmost stage or after β
  rounds of one decision;
* reduction (§4.3.2): machines ranked by cost, the costliest with
  partitions against the cheapest; Algorithm 3 moves the largest
  partitions that fit under half the gap, else the costliest splittable
  partition is split where |C_diff| is least (row before column, moving
  the prefix before the suffix, the first split point of a tie).

A round whose decision rests on two quantities that float32 cannot tell
apart (within ``TIE`` of each other) is a tie: either side of it is the
deployment's answer.  ``plan_round`` lists the splits within ``TIE`` of
the least |C_diff| beside it, and names any other tie.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.swarm_ref import N, PRESPANQ, Q, R, SPANQ, resident_counts

NUM_STAGES = 5
TIE = 1e-5       # float32 products of the banks' N, Q, R
TIE_SUM = 1e-12  # sums of the banks' values, taken in float64 on both sides


def _close(a: float, b: float, tol: float = TIE) -> bool:
    return a != b and abs(a - b) <= tol * max(abs(a), abs(b))


def _order_desc(v: np.ndarray) -> np.ndarray:
    return np.argsort(-v, kind="stable")


def machine_costs(rows: np.ndarray, boxes: np.ndarray, owner: np.ndarray,
                  machines: int, dtype):
    """Per machine C(m), with the partitions' N, Q, R and R(S).
    ``rows`` is the (8, L, G+1) row bank of the live partitions after the
    close, ``boxes`` and ``owner`` theirs."""
    f = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype)  # noqa: E731
    end = torch.as_tensor(boxes[:, 2])
    ix = torch.arange(len(boxes))
    bank = f(rows)
    n, q, r = (bank[ch, ix, end] for ch in (N, Q, R))
    r_s = r.sum()
    own = torch.as_tensor(owner, dtype=torch.long)
    part = n * q * r / (r_s if float(r_s) > 0 else f(1.0))
    num = torch.zeros(machines, dtype=dtype).index_add_(0, own, part) \
        * torch.clamp_min(r_s, 1.0)
    r_m = torch.zeros(machines, dtype=dtype).index_add_(0, own, r)
    rs_m = r_m.sum()
    costs = num / (rs_m if float(rs_m) > 0 else f(1.0))
    return costs, n, q, r, rs_m


def step_fsm(state: dict, r_s: float, beta: int):
    """Fig 9: returns (new state, rebalance?, tie?).  R(S) is a sum of
    the banks' values (integer counts), which float64 adds exactly but
    for the order."""
    improved = r_s > state["pre_rs"]
    stage = min(state["stage"] + (1 if improved else -1), NUM_STAGES - 1)
    decision, same = state["decision"], state["same_count"] + 1
    if stage <= 0 or same >= beta:
        decision, stage, same = 1 - decision, NUM_STAGES // 2, 0
    new = {"stage": stage, "decision": decision, "same_count": same,
           "pre_rs": r_s}
    return new, decision == 1, _close(r_s, state["pre_rs"], TIE_SUM)


def _subset(costs: np.ndarray, c_mh: float, c_ml: float):
    """Algorithm 3 over one machine's partition costs: (picked
    positions, total, tie?)."""
    c_max = (c_mh - c_ml) / 2.0
    total, picked, tie = 0.0, [], False
    for k in _order_desc(costs):
        c = float(costs[k])
        tie |= c > 0 and _close(total + c, c_max)
        if c > 0 and total + c <= c_max:
            total += c
            picked.append(int(k))
            if total == c_max:
                break
    return picked, total, tie


def _split(rows_p, cols_p, box, base: float, r_s: float, g: int, dtype):
    """The splits of one partition that bring |C_diff| least: a list of
    (axis 0 row / 1 column, split point, move the prefix?), the least
    first, then every other within ``TIE`` of it, in order of |C_diff|.
    ``rows_p`` and ``cols_p`` are its (8, G+1) banks."""
    f = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype)  # noqa: E731
    rs = f(r_s) if r_s > 0 else f(1.0)
    sp = torch.arange(g)
    scores, vals = [], []
    for axis, bank in ((0, f(rows_p)), (1, f(cols_p))):
        a0, a1 = (box[0], box[2]) if axis == 0 else (box[1], box[3])
        n_lo, q_lo, r_lo = bank[N, :g], bank[Q, :g], bank[R, :g]
        n_hi = bank[N, a1] - n_lo
        q_hi = bank[Q, a1] - q_lo + bank[SPANQ, 1:g + 1]
        r_hi = bank[R, a1] - r_lo + bank[PRESPANQ, 1:g + 1]
        c_lo = n_lo * q_lo * r_lo / rs
        c_hi = n_hi * q_hi * r_hi / rs
        valid = (sp >= a0) & (sp < a1)
        for keep, move in ((c_hi, c_lo), (c_lo, c_hi)):
            d = (f(base) + keep - move).double()
            scores.append(torch.where(valid, d.abs(),
                                      torch.full_like(d, np.inf)))
            vals.append((keep.double().abs() + move.double().abs()))
    score = torch.stack(scores).numpy().reshape(-1)
    scale = torch.stack(vals).numpy().reshape(-1)
    best = int(np.argmin(score))
    tol = TIE * (abs(base) + float(scale[best]))
    near = np.nonzero(score <= score[best] + tol)[0]
    near = [best] + [int(i) for i in near[np.argsort(score[near],
                                                      kind="stable")]
                     if i != best]
    out = []
    for i in near:
        combo, s = divmod(i, g)
        axis, direction = divmod(combo, 2)
        out.append((axis, s, direction == 0))
    return out


def plan_round(rnd: dict, sysp: dict, queries: dict, dtype) -> dict:
    """The round's decision from ``rnd``: ``rows``, ``cols`` the live
    partitions' banks after the close (8, L, G+1); ``start`` the plan at
    the round's start (``grid``, ``boxes``, ``owner``, ``live``);
    ``fsm`` the decision state it started from.

    Returns ``cells``: per cell of the grid its partition's box and
    owner at the round's end (G, G, 5); ``transfers``; ``to``, the
    receiver m_L; ``moved``, the standing queries resident on what it
    gets; ``fsm``, the
    decision state after the round; ``tie``, the decisions that rested
    on a near-tie, if any, but for the split point; ``alts``, the
    partitions each split within ``TIE`` of the least would make."""
    g, m = int(sysp["grid"]), int(sysp["machines"])
    st = rnd["start"]
    live = st["live"]
    boxes = st["boxes"][live]
    owner = st["owner"][live]
    costs_t, n, q, r, rs_m = machine_costs(rnd["rows"], boxes, owner, m,
                                           dtype)
    costs = costs_t.double().numpy()
    fsm, rebalance, t_fsm = step_fsm(rnd["fsm"], float(rs_m),
                                     int(sysp["beta"]))
    ties = ["fsm"] if t_fsm else []
    made, alts = [], []            # (box, owner) of the new partitions
    m_l, transfers = -1, 0
    if rebalance and m >= 2:
        rs = float(rs_m)
        part = (n * q * r / (torch.as_tensor(rs, dtype=dtype) if rs > 0
                             else torch.as_tensor(1.0, dtype=dtype)))
        part = part.double().numpy()
        order = _order_desc(costs)
        srt = costs[order]
        lo = m - 1
        if _close(float(srt[lo]), float(srt[lo - 1])):
            ties.append("m_l")
        for hi in range(m):
            if hi >= lo:
                break
            m_h, m_l = int(order[hi]), int(order[lo])
            if _close(float(srt[hi]), float(srt[hi + 1])) \
                    or _close(float(costs[m_h]), float(costs[m_l])):
                ties.append("m_h")
            if costs[m_h] <= costs[m_l]:
                break
            mine = np.nonzero(owner == m_h)[0]
            if not len(mine):
                continue
            c_mh, c_ml = float(costs[m_h]), float(costs[m_l])
            picked, total, t_sub = _subset(part[mine], c_mh, c_ml)
            if t_sub:
                ties.append("subset")
            if picked and total > 0:
                made = [(boxes[k], m_l) for k in mine[picked]]
                transfers = 1
                break
            by_cost = mine[_order_desc(part[mine])]
            for j, k in enumerate(by_cost):
                b = boxes[k]
                if b[2] <= b[0] and b[3] <= b[1]:
                    continue                    # a cell cannot split
                if any(_close(float(part[a]), float(part[c]))
                       for a, c in zip(by_cost[:j + 1], by_cost[1:j + 2])):
                    ties.append("partition")
                splits = _split(rnd["rows"][:, k], rnd["cols"][:, k], b,
                                (c_mh - float(part[k])) - c_ml, rs, g,
                                dtype)
                made, *alts = [_halves(b, sp, m_h, m_l) for sp in splits]
                transfers = 1
                break
            if transfers:
                break
    cells, moved = outcome(st, made, m_l, queries)
    return {"cells": cells, "transfers": transfers, "moved": moved,
            "fsm": fsm, "tie": ",".join(ties), "alts": alts, "to": m_l}


def _halves(box, split, m_h: int, m_l: int) -> list:
    """The two partitions a split makes, with their owners."""
    axis, s, move_lo = split
    lo, hi = box.copy(), box.copy()
    lo[2 + axis], hi[axis] = s, s + 1
    return [(lo, m_l if move_lo else m_h), (hi, m_h if move_lo else m_l)]


def outcome(start: dict, made: list, m_l: int, queries: dict):
    """The plan at the round's end, cell by cell — (G, G, 5) box and
    owner — when the round makes the partitions ``made`` (boxes with
    their owners) from the plan ``start``, and the standing queries
    resident on what the receiver ``m_l`` gets."""
    live = start["live"]
    g = start["grid"].shape[0]
    pid_of = np.full(len(start["owner"]), -1, np.int64)
    pid_of[live] = np.arange(len(live))
    k = pid_of[start["grid"]]
    cells = np.concatenate([start["boxes"][live][k],
                            start["owner"][live][k][..., None]], -1)
    if not made:
        return cells, 0
    rr, cc = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    for b, o in made:
        inside = ((rr >= b[0]) & (rr <= b[2]) & (cc >= b[1]) & (cc <= b[3]))
        cells[inside] = np.append(b, o)
    gets = np.stack([b for b, o in made if o == m_l]).astype(np.int64)
    return cells, int(resident_counts(queries["cells"], gets)[0].sum())


def program_cells(plan: dict) -> np.ndarray:
    """The program's reported plan, cell by cell: (G, G, 5) box and
    owner of each cell's partition."""
    pid = plan["grid"].astype(np.int64)
    return np.concatenate([plan["boxes"][pid],
                           plan["owner"][pid][..., None]], -1)
