"""Array-native round planner: the per-round decision pipeline of
§4.2–§4.3 as a pure batched array program.

``core.protocol.Swarm`` used to interleave the round's *decisions* with
its *mutations*: a per-machine Python loop built the cost reports, one
m_H candidate at a time ran the workload-reduction search, and exactly
one m_H→m_L transfer was applied per round.  This module extracts every
decision into pure functions over arrays:

* :func:`collect` — batched report collection.  One gather of the live
  partitions' totals and three ``np.bincount`` calls replace the
  per-machine loop; the wire format (two scalars per machine, Fig 20)
  is unchanged — only how the Coordinator-side math runs.
* :func:`split_terms` / :func:`split_cost_curves` — batched §4.3.2
  split-candidate evaluation: C(p1), C(p2) for *every* split point of
  *every* candidate partition in one array pass (the per-pid
  ``find_best_split`` loop ran one partition at a time).  Written in
  backend-neutral array ops so the JAX data plane can trace the same
  source (``streaming.planes``).
* :func:`plan_round` — multi-pair rebalancing (DESIGN.md §5): rank the
  machines once, then greedily match the most-overloaded machines with
  the least-loaded ones and emit up to ``max_pairs`` independent
  subset/split transfers in a single :class:`RoundPlan`.
  ``max_pairs=1`` reproduces the paper's single m_H→m_L reduction
  exactly (the golden fixture pins this); ``max_pairs≥2`` is the
  concurrent-pairs extension of Mahmood et al. — convergence in
  O(rounds/k) instead of O(rounds) under cluster-wide skew.

Everything here is side-effect free: the planner reads statistics and
the partition table and returns a :class:`RoundPlan`; ``Swarm`` applies
it.  The heavy math (round close, split terms) is served by a pluggable
``streaming.planes.DataPlane`` — ``None`` means the NumPy reference
implementations below.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import balancer, geometry
from . import statistics as S
from ..telemetry.records import CandidateDecision
from .balancer import ReductionPlan, SplitPlan, product_cost
from .cost_model import effective_n


# ---------------------------------------------------------------------------
# Batched report collection (replaces the per-machine loop)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RoundAggregate:
    """Everything the Coordinator derives from one round of reports.

    Per-partition arrays are aligned with ``live``; per-machine arrays
    have length ``num_machines``.  ``r_s_local`` is the executor-side
    R(S) estimate used to scale partition costs before they are summed
    into Num(C(m)); ``r_s`` is the Coordinator-side total
    (``total_rate`` over the machine reports) used by the FSM and the
    ranking denominators — kept distinct to match the wire protocol's
    two summation points exactly.
    """

    live: np.ndarray        # (L,) live partition ids
    n: np.ndarray           # (L,) N(p) (+ smoothing, + γ·D(p) under STORED)
    q: np.ndarray           # (L,) Q(p)
    r: np.ndarray           # (L,) R(p)
    d: np.ndarray           # (L,) resident stored tuples
    area: np.ndarray        # (L,) partition area fraction
    owner: np.ndarray       # (L,) owning machine per live partition
    num_m: np.ndarray       # (M,) Num(C(m)) — scaled partition-cost sums
    r_m: np.ndarray         # (M,) R(m)
    d_m: np.ndarray         # (M,) D(m)
    costs: np.ndarray       # (M,) C(m) = Num(C(m)) / R(S)
    r_s: float              # Coordinator-side R(S)
    r_s_local: float        # executor-side R(S) used for cost scaling


def collect(stats: S.StatsState, parts, num_machines: int, *,
            grid_size: int, smoothing: float = 0.0, cost_fn=product_cost,
            store_counts=None, data_weight: float = 0.0,
            cap_factor=None) -> RoundAggregate:
    """Batched §4.3.1 report collection: one gather over the live
    partitions + ``np.bincount`` per machine — no per-machine loop.

    ``cap_factor`` (optional, (M,) in (0, 1]) is each machine's
    effective-capacity factor: C(m) is divided by it, so a straggler at
    half speed ranks as twice as costly for the same workload and the
    Fig-9 FSM sheds its load through the ordinary reduction machinery
    instead of a dedicated straggler path."""
    live = parts.live_ids()
    s = smoothing
    n = stats.rows[S.N, live, parts.r1[live]] + s
    q = stats.rows[S.Q, live, parts.r1[live]] + s
    r = stats.rows[S.R, live, parts.r1[live]] + s
    d = np.zeros(len(live), np.float64)
    if store_counts is not None:
        d = np.asarray(store_counts)[live].astype(np.float64)
        n = effective_n(n, d, data_weight)
    area = (geometry.box_area(parts.r0[live], parts.c0[live],
                              parts.r1[live], parts.c1[live])
            .astype(np.float64) / (grid_size * grid_size))
    owner = parts.owner[live]
    r_s_local = float(r.sum())
    part_cost = np.asarray(cost_fn(n, q, r, area, r_s_local), np.float64)
    # wire format is unchanged: two scalars per machine — Num(C(m))
    # (scaled so Num/R(S) = Σ C(p)) and R(m); STORED adds D(m).
    num_m = (np.bincount(owner, weights=part_cost, minlength=num_machines)
             * max(r_s_local, 1.0))
    r_m = np.bincount(owner, weights=r, minlength=num_machines)
    d_m = np.bincount(owner, weights=d, minlength=num_machines)
    r_s = float(r_m.sum())
    costs = num_m / (r_s if r_s > 0 else 1.0)
    if cap_factor is not None:
        costs = costs / np.maximum(np.asarray(cap_factor, np.float64), 1e-6)
    return RoundAggregate(live, n, q, r, d, area, owner,
                          num_m, r_m, d_m, costs, r_s, r_s_local)


# ---------------------------------------------------------------------------
# Batched split evaluation
# ---------------------------------------------------------------------------

def split_terms(bank_sub, a1, g: int):
    """Batched §4.3.2 side totals for every candidate split point.

    ``bank_sub`` is the gathered stats bank of the K candidate
    partitions, shape (≥5, K, G+1) with the maintained channels first —
    ``stats.rows[:C_N, pids]`` for a row split, ``stats.cols[:C_N,
    pids]`` for a column split (collector channels are never read).
    ``a1`` is the (K,) split-axis end bound the totals are read at.
    Returns six (K, G) arrays — the N/Q/R totals of the lo and hi side
    at every *global* split position ``s`` in [0, G); positions outside
    a partition's [a0, a1) span are garbage — :func:`split_cost_curves`
    masks them.

    Written in backend-neutral array ops: NumPy arrays give the
    reference path, jnp arrays trace under ``jax.jit`` (the JAX data
    plane compiles exactly this source — ``streaming.planes``).
    """
    k = bank_sub.shape[1]
    rows = np.arange(k)
    n_sp = bank_sub[S.N, :, :g]
    q_sp = bank_sub[S.Q, :, :g]
    r_sp = bank_sub[S.R, :, :g]
    n_tot = bank_sub[S.N, rows, a1][:, None]
    q_tot = bank_sub[S.Q, rows, a1][:, None]
    r_tot = bank_sub[S.R, rows, a1][:, None]
    span_next = bank_sub[S.SPANQ, :, 1:g + 1]
    prespan_next = bank_sub[S.PRESPANQ, :, 1:g + 1]
    q_hi = q_tot - q_sp + span_next
    r_hi = r_tot - r_sp + prespan_next
    return n_sp, q_sp, r_sp, n_tot - n_sp, q_hi, r_hi


def split_cost_curves(terms, boxes, axis: int, g: int, r_s: float,
                      cost_fn=product_cost):
    """Apply the (pluggable, host-side) cost model to batched split
    terms: (c_lo, c_hi, valid), each (K, G).  ``axis`` 0 = row split,
    1 = column split; ``boxes`` = (r0, c0, r1, c1) arrays."""
    n_lo, q_lo, r_lo, n_hi, q_hi, r_hi = terms
    r0, c0, r1, c1 = boxes
    a0, a1 = (r0, r1) if axis == 0 else (c0, c1)
    ortho = (c1 - c0 + 1) if axis == 0 else (r1 - r0 + 1)
    sp = np.arange(g)[None, :]
    a_lo = (sp - a0[:, None] + 1) * ortho[:, None] / (g * g)
    a_hi = (a1[:, None] - sp) * ortho[:, None] / (g * g)
    c_lo = cost_fn(n_lo, q_lo, r_lo, a_lo, r_s)
    c_hi = cost_fn(n_hi, q_hi, r_hi, a_hi, r_s)
    valid = (sp >= a0[:, None]) & (sp < a1[:, None])
    return c_lo, c_hi, valid


def numpy_split_costs(stats: S.StatsState, pids, boxes, r_s: float,
                      cost_fn=product_cost):
    """Reference split-candidate evaluation for K partitions at once:
    stacked (c_lo, c_hi, valid) of shape (K, 2, G), axis 0 = row."""
    g = stats.grid_size
    pids = np.asarray(pids)
    out_lo, out_hi, out_valid = [], [], []
    for axis, bank in ((0, stats.rows), (1, stats.cols)):
        a1 = boxes[2] if axis == 0 else boxes[3]
        terms = split_terms(bank[:S.C_N, pids], a1, g)
        c_lo, c_hi, valid = split_cost_curves(terms, boxes, axis, g, r_s,
                                              cost_fn)
        out_lo.append(c_lo)
        out_hi.append(c_hi)
        out_valid.append(valid)
    return (np.stack(out_lo, 1), np.stack(out_hi, 1), np.stack(out_valid, 1))


def best_splits(stats: S.StatsState, pids, boxes, bases, r_s: float,
                cost_fn=product_cost, plane=None, keep_scale=None,
                move_scale=None) -> list[SplitPlan]:
    """Batched argmin-|C_diff| search over K candidate partitions.

    ``bases`` is the per-candidate constant (C(m_H) − C(p)) − C(m_L)
    (in effective units when capacities are heterogeneous).  Evaluates
    every (axis, direction, split point) of every candidate in one
    array program and returns one :class:`SplitPlan` per candidate —
    identical to running ``balancer.find_best_split`` per pid (same
    first-minimum tie-breaking), but one pass instead of K.

    ``keep_scale`` / ``move_scale`` (optional (K,) arrays) convert the
    raw side costs into per-machine *effective* cost: the kept side
    stays on m_H (× 1/f_H), the moved side lands on m_L (× 1/f_L) — a
    split onto a straggler must look as expensive as it will actually
    be there.  ``None`` is the homogeneous paper case (both 1).
    """
    g = stats.grid_size
    pids = np.asarray(pids)
    fn = plane.split_costs if plane is not None else numpy_split_costs
    c_lo, c_hi, valid = fn(stats, pids, boxes, r_s, cost_fn)
    bases = np.asarray(bases, np.float64)[:, None, None, None]
    ks = (np.ones(len(pids)) if keep_scale is None
          else np.asarray(keep_scale, np.float64))[:, None, None, None]
    ms = (np.ones(len(pids)) if move_scale is None
          else np.asarray(move_scale, np.float64))[:, None, None, None]
    # (K, axis, move_lo?, G): move_lo=True keeps the hi side
    keep = np.stack([c_hi, c_lo], 2)
    move = np.stack([c_lo, c_hi], 2)
    c_diff = bases + ks * keep - ms * move
    score = np.where(valid[:, :, None, :], np.abs(c_diff), np.inf)
    flat = score.reshape(len(pids), -1)
    # first-occurrence argmin == find_best_split's axis→direction→sp
    # iteration order with strict-< improvement
    best = np.argmin(flat, 1)
    axis_i, dir_i, sp = np.unravel_index(best, score.shape[1:])
    rows = np.arange(len(pids))
    plans = []
    for k in rows:
        plans.append(SplitPlan(
            int(pids[k]), "row" if axis_i[k] == 0 else "col", int(sp[k]),
            bool(dir_i[k] == 0), float(c_diff[k, axis_i[k], dir_i[k], sp[k]]),
            float(c_lo[k, axis_i[k], sp[k]]),
            float(c_hi[k, axis_i[k], sp[k]])))
    return plans


# ---------------------------------------------------------------------------
# Multi-pair round planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Transfer:
    """One planned m_H → m_L workload reduction."""

    m_h: int
    m_l: int
    plan: ReductionPlan


@dataclass(frozen=True)
class TransferRecord:
    """One *applied* transfer (what the round actually changed)."""

    m_h: int
    m_l: int
    action: str                     # "subset" | "split"
    moved_pids: tuple[int, ...]
    new_pids: tuple[int, ...]


@dataclass(frozen=True)
class RoundPlan:
    """The round's full decision: machine costs + the transfer set.

    ``candidates`` is the flight-recorder trail — every (m_H, m_L)
    pairing the scan considered, in order, with its outcome
    (:class:`~repro.telemetry.records.CandidateDecision`)."""

    costs: np.ndarray
    transfers: tuple[Transfer, ...] = ()
    candidates: tuple[CandidateDecision, ...] = ()


def _splittable(r0, c0, r1, c1) -> bool:
    # cell-sized partitions cannot split (paper §4.1.1 / Fig 3c)
    return not (r1 <= r0 and c1 <= c0)


def _plan_evacuation(agg: RoundAggregate, failed: int, dead,
                     cost_fn, f) -> RoundPlan:
    """Emergency redistribution of one machine's live partitions onto
    the surviving machines (see :func:`plan_round` ``evacuate``)."""
    sel = agg.owner == failed
    ids = agg.live[sel]
    if len(ids) == 0:
        return RoundPlan(agg.costs)
    survivors = [m for m in range(len(agg.costs))
                 if m != failed and m not in dead]
    if not survivors:
        return RoundPlan(agg.costs)
    part_cost = np.asarray(cost_fn(agg.n[sel], agg.q[sel], agg.r[sel],
                                   agg.area[sel], agg.r_s), np.float64)
    load = {m: float(agg.costs[m]) for m in survivors}
    assigned: dict[int, list[int]] = {}
    moved: dict[int, float] = {}
    for k in np.argsort(-part_cost, kind="stable"):
        m_l = min(survivors, key=lambda m: load[m])
        assigned.setdefault(m_l, []).append(int(ids[k]))
        moved[m_l] = moved.get(m_l, 0.0) + float(part_cost[k])
        # effective projected cost: a slow receiver fills up faster
        load[m_l] += float(part_cost[k]) / f[m_l]
    transfers = tuple(
        Transfer(failed, m_l, ReductionPlan("subset", tuple(pids)))
        for m_l, pids in assigned.items())
    cands = tuple(
        CandidateDecision(failed, m_l, float(agg.costs[failed]),
                          float(agg.costs[m_l]), "evacuate",
                          pids=tuple(pids), moved_cost=moved[m_l])
        for m_l, pids in assigned.items())
    return RoundPlan(agg.costs, transfers, cands)


# cost-units price of one link_cost unit (≈ one tick of one-way link
# latency), as a fraction of the mean live-machine cost — see the
# ``link_cost`` paragraph of plan_round
_LINK_PRICE = 0.05


def plan_round(stats: S.StatsState, agg: RoundAggregate, parts, *,
               dead=frozenset(), max_pairs: int = 1,
               use_binary_search: bool = False, cost_fn=product_cost,
               plane=None, evacuate: int | None = None,
               cap_factor=None, link_cost=None) -> RoundPlan:
    """Greedy multi-pair matching (DESIGN.md §5).

    Machines are ranked by cost once; the scan walks overloaded
    machines from the top while handing each successful reduction the
    next-cheapest m_L.  A machine with no viable reduction (no
    partitions, or only cell-sized ones and no subset) is skipped and
    the *same* m_L is offered to the next m_H — with ``max_pairs=1``
    this is exactly the paper's single-reduction round.  Split-point
    searches for all chosen pairs run as one batched evaluation.

    ``cap_factor`` (optional (M,)) makes transfer *sizing* capacity
    aware: ``agg.costs`` already ranks by effective cost C(m)/f_m, but
    raw partition cost c lands as c/f_L on the receiver, so the subset
    bound generalizes from the paper's (C_H − C_L)/2 to
    (C_H − C_L)/(1/f_H + 1/f_L) — identical at f ≡ 1 — and split
    candidates price their kept/moved sides at the owning machine's
    factor.  Without this a freshly-drained straggler (measured cost
    ≈ 0) looks like the cheapest m_L and the planner would pile work
    onto the slowest machine.

    ``link_cost`` (optional (M, M)) extends the capacity factors from
    per-machine to per-link: entry ``[h, l]`` is the *relative* cost of
    shipping state ``h → l`` (e.g. expected link latency in ticks, from
    ``ft.links.LinkModel.cost_matrix``).  Receivers are then chosen to
    minimize ``C(m_L) + link_cost[m_H, m_L]·κ·C̄`` instead of blindly
    taking the globally cheapest machine — a same-region receiver wins
    unless the machine behind the 25 ms link is genuinely cheaper by
    more than the latency price — and the viability/subset bound
    prices the penalty in, so a pair whose cost gap is smaller than
    its link penalty is skipped (``reason="link_cost"``).  κ
    (``_LINK_PRICE``) keeps the penalty a *tiebreaker*: pricing a
    latency tick at the full mean machine cost would ban cross-region
    moves outright and trap hot-region load on hot-region machines.
    ``None`` keeps the exact paper scan.

    ``evacuate`` switches the planner to the emergency recovery mode of
    §4.1.1: *every* live partition of the (crash-stopped or departing)
    machine is re-homed onto the surviving machines — partitions walk
    cost-descending onto the currently least-loaded survivor, whose
    projected cost is bumped as it receives, so one failure fans out
    across several receivers instead of doubling up the single cheapest
    machine.  One subset :class:`Transfer` is emitted per receiver
    (multi-pair by construction); ``max_pairs`` is ignored — an
    evacuation cannot be partial.
    """
    f = (np.ones(len(agg.costs)) if cap_factor is None
         else np.maximum(np.asarray(cap_factor, np.float64), 1e-6))
    if evacuate is not None:
        return _plan_evacuation(agg, int(evacuate), dead, cost_fn, f)
    order = [m for m in map(int, np.argsort(-agg.costs, kind="stable"))
             if m not in dead]
    if len(order) < 2:
        return RoundPlan(agg.costs)
    costs = agg.costs
    # the split search uses the Coordinator-side R(S), like the paper's
    # executor receiving (C(m_H), C(m_L), R(S)) in the reduction request
    part_cost = np.asarray(cost_fn(agg.n, agg.q, agg.r, agg.area, agg.r_s),
                           np.float64)
    # transfer slots in pairing order; split slots carry (pid, base,
    # scales) until the batched evaluation at the end fills them in
    slots: list[Transfer | None] = []
    pending_split: list[tuple] = []  # m_h, m_l, pid, base, 1/f_h, 1/f_l
    cands: list[CandidateDecision] = []   # flight-recorder trail
    # link penalties priced in cost units: relative latency × κ × the
    # mean live-machine cost, so the tradeoff scales with the workload
    # but stays a tiebreaker (a ~3-tick inter-region link costs ~15 %
    # of the mean load, not 3× it)
    lc_scale = 0.0
    if link_cost is not None:
        pos = costs[np.asarray(order)]
        pos = pos[pos > 0]
        lc_scale = _LINK_PRICE * float(pos.mean()) if len(pos) else 0.0
    used_l: set[int] = set()
    lo_idx = len(order) - 1
    for hi_idx, m_h in enumerate(order):
        if len(slots) >= max_pairs:
            break
        if hi_idx >= lo_idx:
            break
        if link_cost is None:
            m_l = order[lo_idx]
            penalty = 0.0
        else:
            pool = [m for m in order[hi_idx + 1:lo_idx + 1]
                    if m not in used_l]
            if not pool:
                break
            m_l = min(pool, key=lambda m: float(costs[m])
                      + float(link_cost[m_h, m]) * lc_scale)
            penalty = float(link_cost[m_h, m_l]) * lc_scale
        if costs[m_h] <= costs[m_l] + penalty:
            reason = ("link_cost" if costs[m_h] > costs[m_l]
                      else "balanced")
            cands.append(CandidateDecision(
                m_h, m_l, float(costs[m_h]), float(costs[m_l]),
                "skip", reason=reason))
            break
        sel = agg.owner == m_h
        ids, cst = agg.live[sel], part_cost[sel]
        c_mh, c_ml = float(costs[m_h]), float(costs[m_l]) + penalty
        if len(ids) == 0:
            cands.append(CandidateDecision(m_h, m_l, c_mh, c_ml, "skip",
                                           reason="no_partitions"))
            continue
        # heterogeneous capacity: raw cost x leaves m_H as x/f_H and
        # lands as x/f_L, so "total ≤ (C_H − C_L)/2" becomes
        # "x ≤ (C_H − C_L)/(1/f_H + 1/f_L)" — scale the part costs so
        # find_subset's homogeneous bound enforces exactly that
        inv_fh, inv_fl = 1.0 / f[m_h], 1.0 / f[m_l]
        scale = (inv_fh + inv_fl) / 2.0
        subset, total, sorted_ids = balancer.find_subset(
            ids, cst * scale, c_mh, c_ml)
        if subset and total > 0:
            slots.append(Transfer(m_h, m_l,
                                  ReductionPlan("subset", tuple(subset))))
            cands.append(CandidateDecision(
                m_h, m_l, c_mh, c_ml, "subset",
                pids=tuple(int(p) for p in subset),
                moved_cost=float(total)))
            if link_cost is None:
                lo_idx -= 1
            else:
                used_l.add(m_l)
            continue
        # no subset fits → split the largest-cost splittable partition
        cost_of = {int(p): float(c) for p, c in zip(ids, cst)}
        placed = False
        for pid in map(int, sorted_ids):
            box = (int(parts.r0[pid]), int(parts.c0[pid]),
                   int(parts.r1[pid]), int(parts.c1[pid]))
            if not _splittable(*box):
                continue
            if use_binary_search:
                # parity-experiment path; assumes homogeneous capacity
                plan = balancer.split_binary_search(
                    stats, pid, box, c_mh, c_ml, cost_of[pid], agg.r_s,
                    cost_fn)
                if plan is None:
                    continue
                slots.append(Transfer(m_h, m_l,
                                      ReductionPlan("split", split=plan)))
            else:
                pending_split.append(
                    (m_h, m_l, pid, (c_mh - cost_of[pid] * inv_fh) - c_ml,
                     inv_fh, inv_fl))
                slots.append(None)
            cands.append(CandidateDecision(
                m_h, m_l, c_mh, c_ml, "split", pids=(pid,),
                moved_cost=cost_of[pid]))
            placed = True
            break
        if placed:
            if link_cost is None:
                lo_idx -= 1
            else:
                used_l.add(m_l)
        else:
            # every candidate of m_H failed — try the next m_H against
            # the same m_L (paper behavior)
            cands.append(CandidateDecision(m_h, m_l, c_mh, c_ml, "skip",
                                           reason="no_splittable"))
    if pending_split:
        pids = np.array([p for _, _, p, _, _, _ in pending_split], np.int64)
        boxes = (parts.r0[pids].astype(np.int64),
                 parts.c0[pids].astype(np.int64),
                 parts.r1[pids].astype(np.int64),
                 parts.c1[pids].astype(np.int64))
        bases = [b for _, _, _, b, _, _ in pending_split]
        ks = [k for _, _, _, _, k, _ in pending_split]
        ms = [m for _, _, _, _, _, m in pending_split]
        plans = iter(best_splits(stats, pids, boxes, bases, agg.r_s, cost_fn,
                                 plane, keep_scale=ks, move_scale=ms))
        filled = iter(pending_split)
        for i, slot in enumerate(slots):
            if slot is None:
                m_h, m_l = next(filled)[:2]
                slots[i] = Transfer(m_h, m_l,
                                    ReductionPlan("split", split=next(plans)))
    return RoundPlan(agg.costs, tuple(slots), tuple(cands))
