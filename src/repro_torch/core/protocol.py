"""The SWARM protocol: ties index, statistics, cost model, planner and
balancer into the per-round control loop of §4.3 (Figs 8–10).

The object here *is* the distributed protocol run as one logical
program, but since the array-native control-plane refactor it is a thin
orchestrator: ingest touches only local collectors (executor-side), and
``run_round`` delegates every decision to the pure, batched
``core.planner`` — round close → report collection → FSM → multi-pair
reduction planning — then applies the returned :class:`~.planner.RoundPlan`
(partition moves, splits, latch-free plan install).  The heavy array
math (prefix-sum round close, batched split evaluation) can be served
by a pluggable ``streaming.planes.DataPlane``; the default (``None``)
is the NumPy reference path.

The streaming engine (streaming/engine.py) drives this object against a
simulated cluster; the MoE placement layer (distributed/moe_placement.py)
drives the very same machinery over experts instead of spatial
partitions.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ..telemetry import records as trec
from ..telemetry.tracer import current as _tracer
from . import balancer, cost_model, geometry, integrity, planner
from . import statistics as S
from .global_index import GlobalIndex


@dataclass
class RoundReport:
    round_no: int
    decision: int
    r_s: float
    costs: np.ndarray | None = None
    m_h: int = -1                     # first transfer's pair (legacy view)
    m_l: int = -1
    action: str = "none"              # none | subset | split (first transfer)
    moved_pids: tuple[int, ...] = ()  # all transfers, concatenated
    new_pids: tuple[int, ...] = ()
    wire_bytes: int = 0               # Coordinator traffic this round (Fig 20)
    moved_tuples: int = 0             # stored tuples re-homed by plan changes
    data_bytes: int = 0               # …billed as wire bytes (STORED mode)
    transfers: tuple[planner.TransferRecord, ...] = ()
    # flight-recorder trail for this round (telemetry.records); always
    # populated by run_round/recover_machine, None only for reports
    # built outside the protocol (e.g. hand-rolled tests)
    record: trec.DecisionRecord | None = None

    @property
    def did_rebalance(self) -> bool:
        """Whether this round changed the plan (typed consumption point
        for ``streaming.api.RoundOutcome.from_report``)."""
        return self.action != "none"


class Swarm:
    """One SWARM deployment over ``num_machines`` executor machines."""

    def __init__(self, grid_size: int, num_machines: int, *, beta: int = 20,
                 decay: float = 0.5, window_rounds: int = 4,
                 use_binary_search: bool = False, smoothing: float = 0.0,
                 cost_fn=None, seed: int = 0, max_pairs: int = 1,
                 data_plane=None, active_machines: int | None = None,
                 link_cost=None, trend_window: int = 0,
                 trend_threshold: float = 0.35):
        self.g = grid_size
        self.m = num_machines
        self.beta = beta
        self.decay = decay
        self.window_rounds = window_rounds
        self.use_binary_search = use_binary_search
        # Beyond-paper: Laplace-smoothed cost (N+s)(Q+s)(R+s) — the paper's
        # pure product is blind to partitions with zero queries that still
        # receive tuples (per-tuple routing/probe work).  smoothing=0
        # reproduces the paper exactly.
        self.smoothing = smoothing
        # Pluggable partition-cost model.  Default: the paper's product
        # (Eqn 5).  balancer.make_rate_cost() is the beyond-paper model.
        self.cost_fn = cost_fn or balancer.product_cost
        # Concurrent m_H→m_L pairs per round (DESIGN.md §5).  1 is the
        # paper's single-reduction round; k>1 converges O(k)× faster
        # under cluster-wide skew.
        self.max_pairs = max_pairs
        # Optional streaming.planes.DataPlane serving the round-close /
        # split-evaluation array math; None = NumPy reference.
        self.plane = data_plane
        self.index = GlobalIndex.initialize(grid_size, num_machines,
                                            active_machines=active_machines)
        self.stats = S.StatsState.zeros(self.index.parts.capacity, grid_size)
        self.decision = balancer.DecisionState()
        self.round_no = 0
        self.reports: list[RoundReport] = []
        # always-on flight recorder: the last rounds' DecisionRecords
        # (rounds are rare relative to ingest, so recording is cheap)
        self.decision_log: deque[trec.DecisionRecord] = deque(maxlen=512)
        self.dead: set[int] = set()   # crash-stop machines (ft layer)
        # standby slots: not yet members — they neither report nor
        # receive load until a MachineJoin activates them (elasticity)
        active = num_machines if active_machines is None \
            else max(1, min(int(active_machines), num_machines))
        self.standby: set[int] = set(range(active, num_machines))
        # per-machine effective-capacity factor (stragglers < 1); folds
        # into C(m) at collection so the ordinary reduction machinery
        # sheds a slow machine's load (no dedicated straggler path)
        self.cap_factor = np.ones(num_machines, np.float64)
        # Data-persistence hook (repro.queries): when a TupleStore is
        # attached, plan changes re-home its per-partition counts and
        # D(p) enters the cost product with weight ``data_weight``.
        self.store = None
        self.data_weight = 0.0
        self.bill_data_migration = False
        self._moved_tuples = 0
        # Geo extension (DESIGN.md §12): an (M, M) relative link-cost
        # matrix folds per-link latency into pair matching (None keeps
        # the paper's latency-blind scan), and ``trend_window > 0``
        # arms the cost-trend rebalance trigger — under jittery links
        # R(S) flaps and backpressure lies, so a sustained high
        # cost-imbalance (CoV of member costs averaged over the window
        # exceeding ``trend_threshold``) forces a rebalance even when
        # the Fig-9 FSM would sit still.
        self.link_cost = (None if link_cost is None
                          else np.asarray(link_cost, np.float64))
        self.trend_window = int(trend_window)
        self.trend_threshold = float(trend_threshold)
        self._trend: deque[float] = deque(maxlen=max(self.trend_window, 1))

    def attach_store(self, store, *, data_weight: float = 0.0,
                     bill_migration: bool = False) -> None:
        """Wire a ``repro.queries.TupleStore`` into the protocol.

        ``data_weight`` > 0 folds resident tuples into N(p) (STORED
        cost); ``bill_migration`` bills moved tuples' bytes on the round
        that moved them (§5.2 chain-forwarding ships them lazily, but
        they do cross the wire once)."""
        self.store = store
        self.data_weight = float(data_weight)
        self.bill_data_migration = bool(bill_migration)

    # ------------------------------------------------------------------
    # Executor-side ingest (hot path)
    # ------------------------------------------------------------------
    def ingest_points(self, xy: np.ndarray) -> np.ndarray:
        """Route float points and update collectors.  Returns the owning
        machine per point (for the engine's work accounting)."""
        row, col = geometry.points_to_cells(xy, self.g)
        pids, owners = self.index.route_points(row, col)
        self._sync_capacity()
        S.ingest_points(self.stats, pids, row, col)
        return owners

    def ingest_queries(self, rects: np.ndarray):
        """Route float query rects; update collectors of every overlapped
        partition with the *clipped* rectangle (§4.2.2).

        Fully vectorized: one partitions×queries overlap test, one
        batched clip, one collector scatter — no per-query loop.
        Returns ``(query_idx, pids, owners)`` arrays, one entry per
        (query, overlapped partition) pair, ordered by query then pid.
        """
        r0, c0, r1, c1 = geometry.rects_to_cells(rects, self.g)
        self._sync_capacity()
        p = self.index.parts
        n = p.n_alloc
        if len(rects) == 0 or n == 0:
            empty = np.zeros(0, np.int64)
            return empty, empty, empty
        hit = p.alive[:n][None, :] & geometry.boxes_overlap(
            r0[:, None], c0[:, None], r1[:, None], c1[:, None],
            p.r0[:n][None, :], p.c0[:n][None, :],
            p.r1[:n][None, :], p.c1[:n][None, :])
        qi, pids = np.nonzero(hit)
        qr0, qc0, qr1, qc1 = geometry.clip_box(
            r0[qi], c0[qi], r1[qi], c1[qi],
            p.r0[pids], p.c0[pids], p.r1[pids], p.c1[pids])
        S.ingest_queries(self.stats, pids, qr0, qc0, qr1, qc1)
        return qi, pids, p.owner[pids]

    def ingest_snapshot_probes(self, rects: np.ndarray):
        """One-shot snapshot probes (repro.queries SNAPSHOT model).

        Probes arrive at stream rate, so unlike continuous-query
        registration this path is fully vectorized: each probe is
        attributed to the partition containing its center (probes are
        campus-sized, partitions much larger).  Feeds the Q'/spanQ'
        collectors so the cost model sees probe hotspots exactly like
        query hotspots.  Returns (pids, owners) per probe."""
        centers = np.stack([(rects[:, 0] + rects[:, 2]) * 0.5,
                            (rects[:, 1] + rects[:, 3]) * 0.5], axis=1)
        row, col = geometry.points_to_cells(centers, self.g)
        pids, owners = self.index.route_points(row, col)
        self._sync_capacity()
        r0, c0, r1, c1 = geometry.rects_to_cells(rects, self.g)
        p = self.index.parts
        qr0, qc0, qr1, qc1 = geometry.clip_box(
            r0, c0, r1, c1, p.r0[pids], p.c0[pids], p.r1[pids], p.c1[pids])
        S.ingest_queries(self.stats, pids, qr0, qc0, qr1, qc1)
        return pids, owners

    def absorb_collectors(self, cn_rows: np.ndarray,
                          cn_cols: np.ndarray) -> None:
        """Fold externally accumulated N′ collector deltas into the
        stats bank.

        The device-resident ingest path (``streaming.fused``) keeps the
        per-tuple collector scatter on the data plane's device and
        drains it here right before any host event that consumes or
        relocates statistics — the round close reads the deltas exactly
        as if ``ingest_points`` had accumulated them tuple by tuple
        (integer counts in float32, so the fold is exact).  ``cn_*``
        are (P_device, G+1) banks indexed by partition id; the device
        bank may trail the host capacity after mid-round growth."""
        self._sync_capacity()
        p = cn_rows.shape[0]
        self.stats.rows[S.C_N, :p] += cn_rows
        self.stats.cols[S.C_N, :p] += cn_cols

    # ------------------------------------------------------------------
    # Coordinator round (Figs 8–10): close → collect → decide → apply
    # ------------------------------------------------------------------
    def run_round(self) -> RoundReport:
        tr = _tracer()
        with tr.span("round_close", round=self.round_no + 1) as sp:
            self.round_no += 1
            self._close_stats()
            agg = self._collect()
            per_machine = (cost_model.CostReport.WIRE_BYTES_STORED
                           if self.store is not None and self.data_weight > 0
                           else cost_model.CostReport.WIRE_BYTES)
            # only member executors report to the Coordinator:
            # crash-stopped machines send nothing, standby slots are not
            # members yet (Fig 20 accounting)
            reporting = self.m - sum(1 for d in self.excluded
                                     if 0 <= d < self.m)
            wire = reporting * per_machine
            fsm_before = trec.FsmState.capture(self.decision)
            self.decision, decision = balancer.step_decision(
                self.decision, agg.r_s, self.beta)
            fsm_after = trec.FsmState.capture(self.decision)
            if tr.enabled and (fsm_after.stage != fsm_before.stage
                               or fsm_after.decision != fsm_before.decision):
                tr.instant("fsm_transition", round=self.round_no,
                           stage_from=fsm_before.stage,
                           stage_to=fsm_after.stage,
                           decision=decision, r_s=agg.r_s)
            if self.trend_window > 0 and decision != balancer.REBALANCE:
                cov = self._cost_trend(agg)
                if (len(self._trend) >= self.trend_window
                        and sum(self._trend) / len(self._trend)
                        > self.trend_threshold):
                    decision = balancer.REBALANCE
                    self._trend.clear()
                    if tr.enabled:
                        tr.instant("trend_trigger", round=self.round_no,
                                   cov=cov)
            rep = RoundReport(self.round_no, decision, agg.r_s,
                              wire_bytes=wire)
            plan = None
            if decision == balancer.REBALANCE:
                with tr.span("plan_round", round=self.round_no):
                    plan = planner.plan_round(
                        self.stats, agg, self.index.parts,
                        dead=self.excluded, max_pairs=self.max_pairs,
                        use_binary_search=self.use_binary_search,
                        cost_fn=self.cost_fn, plane=self.plane,
                        cap_factor=self.cap_factor,
                        link_cost=self.link_cost)
                with tr.span("apply_plan", round=self.round_no,
                             transfers=len(plan.transfers)):
                    self._apply_plan(plan, rep)
            integrity.expire_chains(self.index.parts, self.round_no,
                                    self.window_rounds)
            self._finish_round(rep)
            self._record_decision("round", rep, plan, fsm_before, fsm_after)
            if tr.enabled:
                sp.set(decision=decision, r_s=agg.r_s,
                       transfers=len(rep.transfers))
        return rep

    def _record_decision(self, kind: str, rep: RoundReport, plan,
                         fsm_before=None, fsm_after=None,
                         evacuated: int = -1) -> trec.DecisionRecord:
        """Assemble the flight-recorder record for one round/recovery
        and attach it to both the report and the decision log."""
        rec = trec.DecisionRecord(
            round_no=rep.round_no, kind=kind, decision=int(rep.decision),
            r_s=float(rep.r_s),
            r_s_prev=fsm_before.pre_rs if fsm_before is not None else -1.0,
            improved=bool(fsm_before is not None
                          and rep.r_s > fsm_before.pre_rs),
            fsm_before=fsm_before, fsm_after=fsm_after,
            costs=(tuple(float(c) for c in rep.costs)
                   if rep.costs is not None else ()),
            candidates=tuple(plan.candidates) if plan is not None else (),
            transfers=(trec.transfer_traces(plan.transfers, rep.transfers)
                       if plan is not None else ()),
            wire_bytes=int(rep.wire_bytes), data_bytes=int(rep.data_bytes),
            moved_tuples=int(rep.moved_tuples), evacuated=evacuated)
        rep.record = rec
        self.decision_log.append(rec)
        return rec

    def replace_last_decision(self, rec: trec.DecisionRecord) -> None:
        """Swap the newest log entry for an enriched copy (the router
        folds in query-migration accounting after it reindexes)."""
        if self.decision_log:
            self.decision_log[-1] = rec

    def _cost_trend(self, agg) -> float:
        """Push this round's member-cost imbalance (coefficient of
        variation) onto the trend window and return it."""
        member = np.ones(self.m, bool)
        for d in self.excluded:
            if 0 <= d < self.m:
                member[d] = False
        c = agg.costs[member]
        mu = float(c.mean()) if len(c) else 0.0
        cov = float(c.std() / mu) if mu > 0 else 0.0
        self._trend.append(cov)
        return cov

    def note_transfer_event(self, round_no: int, kind: str) -> None:
        """Fold an asynchronous transfer outcome (geo links: a retry or
        abort observed ticks after the plan was recorded) back into the
        round's flight-recorder record."""
        from dataclasses import replace as _replace
        for i in range(len(self.decision_log) - 1, -1, -1):
            rec = self.decision_log[i]
            if rec.round_no == round_no:
                if kind == "retry":
                    rec = _replace(rec, retries=rec.retries + 1)
                else:
                    rec = _replace(rec, aborts=rec.aborts + 1)
                self.decision_log[i] = rec
                return

    def _close_stats(self) -> None:
        """Algorithm-2 round close, served by the data plane when one is
        attached (prefix-sum fold over the live partitions)."""
        if self.plane is not None:
            self.plane.close_round(self.stats, self.decay,
                                   self.index.parts.live_ids())
        else:
            S.close_round(self.stats, self.decay)

    def _collect(self) -> planner.RoundAggregate:
        """Batched report collection (planner.collect) over live state."""
        if self.store is not None:
            self.store.ensure(self.index.parts.capacity)
        return planner.collect(
            self.stats, self.index.parts, self.m, grid_size=self.g,
            smoothing=self.smoothing, cost_fn=self.cost_fn,
            store_counts=self.store.counts if self.store is not None else None,
            data_weight=self.data_weight, cap_factor=self.cap_factor)

    def _finish_round(self, rep: RoundReport) -> None:
        """Fold the data-migration accounting (emergency failure moves
        bill on their own recovery report) and log the round."""
        rep.moved_tuples, self._moved_tuples = self._moved_tuples, 0
        if self.bill_data_migration and self.store is not None:
            rep.data_bytes = rep.moved_tuples * self.store.bytes_per_tuple
        self.reports.append(rep)

    @property
    def excluded(self) -> set[int]:
        """Machines outside the working set: crashed or standby."""
        return self.dead | self.standby

    def mark_dead(self, machine: int) -> None:
        """Crash-stop: the machine is excluded from m_H/m_L selection."""
        self.dead.add(int(machine))

    def mark_alive(self, machine: int, capacity_factor: float = 1.0) -> None:
        """A machine slot (re)joins the working set: it reports from the
        next round on and is immediately eligible as an m_L target —
        re-homing onto it runs through the ordinary ``plan_round``
        reduction rounds, not a dedicated join path."""
        m = int(machine)
        self.dead.discard(m)
        self.standby.discard(m)
        self.cap_factor[m] = float(capacity_factor)

    def set_capacity_factor(self, machine: int, factor: float) -> None:
        """Effective-capacity change (straggler when < 1): folds into
        C(m) at collection — see ``planner.collect``."""
        self.cap_factor[int(machine)] = float(factor)

    def recover_machine(self, machine: int) -> RoundReport:
        """Crash-stop recovery (§4.1.1): mark the machine dead and
        emergency-redistribute its live partitions over the survivors
        through ``planner.plan_round(evacuate=...)`` — the same
        multi-pair redistribution machinery as rebalancing, applied
        outside the round cadence.  Statistics are *not* closed (the
        failure does not end the round); migration accounting bills on
        the returned report immediately."""
        m = int(machine)
        tr = _tracer()
        with tr.span("failover", machine_failed=m) as sp:
            self.mark_dead(m)
            rep = RoundReport(self.round_no, balancer.REBALANCE, 0.0)
            agg = self._collect()
            rep.r_s = agg.r_s
            with tr.span("plan_round", round=self.round_no, evacuate=m):
                plan = planner.plan_round(
                    self.stats, agg, self.index.parts, dead=self.excluded,
                    cost_fn=self.cost_fn, plane=self.plane, evacuate=m,
                    cap_factor=self.cap_factor)
            with tr.span("apply_plan", round=self.round_no,
                         transfers=len(plan.transfers)):
                self._apply_plan(plan, rep)
            self._finish_round(rep)
            self._record_decision("recovery", rep, plan, evacuated=m)
            if tr.enabled:
                sp.set(transfers=len(rep.transfers),
                       moved_pids=len(rep.moved_pids))
        return rep

    # ------------------------------------------------------------------
    # Plan application (the only mutating half of the round)
    # ------------------------------------------------------------------
    def _apply_plan(self, plan: planner.RoundPlan, rep: RoundReport) -> None:
        rep.costs = plan.costs
        records = []
        for t in plan.transfers:
            if t.plan.kind == "subset":
                new = [self._move_partition(pid, t.m_l)
                       for pid in t.plan.subset]
                records.append(planner.TransferRecord(
                    t.m_h, t.m_l, "subset", tuple(t.plan.subset), tuple(new)))
            elif t.plan.kind == "split":
                new = self._split_partition(t.plan.split, t.m_h, t.m_l)
                records.append(planner.TransferRecord(
                    t.m_h, t.m_l, "split", (t.plan.split.pid,), tuple(new)))
            else:
                continue
            self.index.apply_changes(records[-1].new_pids)
        if records:
            rep.transfers = tuple(records)
            rep.action = records[0].action
            rep.m_h, rep.m_l = records[0].m_h, records[0].m_l
            rep.moved_pids = tuple(p for r in records for p in r.moved_pids)
            rep.new_pids = tuple(p for r in records for p in r.new_pids)

    def _move_partition(self, pid: int, m_l: int) -> int:
        """Whole-partition move: mint a new id owned by m_L, chain to the
        old one (which keeps the data until expiry, §5.2)."""
        p = self.index.parts
        new = p.allocate(int(p.r0[pid]), int(p.c0[pid]), int(p.r1[pid]),
                         int(p.c1[pid]), owner=m_l, parent=pid,
                         prev_machine=int(p.owner[pid]), birth_round=self.round_no)
        p.retire(pid)
        self._sync_capacity()
        S.move_partition_stats(self.stats, pid, new)
        if self.store is not None:
            moved = self.store.migrate(pid, new)
            # only STORED persistence ships durable data; the ephemeral
            # probe window re-homes counts without crossing the wire
            if self.bill_data_migration:
                self._moved_tuples += moved
        return new

    def _split_partition(self, plan: balancer.SplitPlan, m_h: int, m_l: int):
        p = self.index.parts
        pid = plan.pid
        r0, c0, r1, c1 = (int(p.r0[pid]), int(p.c0[pid]), int(p.r1[pid]), int(p.c1[pid]))
        own_lo = m_l if plan.move_lo else m_h
        own_hi = m_h if plan.move_lo else m_l
        if plan.axis == "row":
            lo = p.allocate(r0, c0, plan.sp, c1, own_lo, pid, m_h, self.round_no)
            hi = p.allocate(plan.sp + 1, c0, r1, c1, own_hi, pid, m_h, self.round_no)
            self._sync_capacity()
            S.derive_row_split(self.stats, pid, lo, hi, r0, plan.sp, r1, c0, c1)
        else:
            lo = p.allocate(r0, c0, r1, plan.sp, own_lo, pid, m_h, self.round_no)
            hi = p.allocate(r0, plan.sp + 1, r1, c1, own_hi, pid, m_h, self.round_no)
            self._sync_capacity()
            S.derive_col_split(self.stats, pid, lo, hi, c0, plan.sp, c1, r0, r1)
        if self.store is not None:
            if plan.axis == "row":
                frac_lo = (plan.sp - r0 + 1) / max(r1 - r0 + 1, 1)
            else:
                frac_lo = (plan.sp - c0 + 1) / max(c1 - c0 + 1, 1)
            total = self.store.split(pid, lo, hi, frac_lo)
            # only the side handed to m_L actually changes machine, and
            # only STORED persistence ships it (ephemeral counts re-home
            # without crossing the wire)
            if self.bill_data_migration:
                moved_frac = frac_lo if plan.move_lo else 1.0 - frac_lo
                self._moved_tuples += int(round(total * moved_frac))
        p.retire(pid)
        return lo, hi

    # ------------------------------------------------------------------
    # Background merge of adjacent same-owner partitions (§4.3.1 end)
    # ------------------------------------------------------------------
    def merge_adjacent(self) -> int:
        """Merge any two same-owner partitions forming a rectangle.

        Sorted edge-sweep: candidates are found by lexsorting the live
        boxes by (orthogonal span, owner, axis start) and testing only
        *consecutive* rows — O(P log P) per pass instead of the old
        O(P²) rescan.  Each pass merges a disjoint pair set, then
        re-sweeps so cascaded merges (strip → block) still happen.

        Returns #merges.  Merged stats: exact for N/R along both axes;
        queries spanning the old boundary are counted once per side
        (slight overcount that fresh rounds wash out — documented)."""
        merges = 0
        changed = []
        while True:
            pairs = self._merge_candidates()
            if not pairs:
                break
            for a, b, row_adj in pairs:
                changed.append(self._do_merge(a, b, row_adj))
                merges += 1
        if changed:
            self.index.apply_changes(changed)
        return merges

    def _merge_candidates(self) -> list[tuple[int, int, bool]]:
        """One sweep: disjoint same-owner pairs forming rectangles."""
        p = self.index.parts
        live = p.live_ids()
        out: list[tuple[int, int, bool]] = []
        used: set[int] = set()
        for row_adj in (True, False):
            if row_adj:  # same col span, stacked rows
                keys = (p.r0[live], p.owner[live], p.c1[live], p.c0[live])
            else:        # same row span, side-by-side cols
                keys = (p.c0[live], p.owner[live], p.r1[live], p.r0[live])
            order = live[np.lexsort(keys)]
            for k in range(len(order) - 1):
                i, j = int(order[k]), int(order[k + 1])
                if i in used or j in used or p.owner[i] != p.owner[j]:
                    continue
                if row_adj:
                    ok = (p.c0[i] == p.c0[j] and p.c1[i] == p.c1[j]
                          and p.r1[i] + 1 == p.r0[j])
                else:
                    ok = (p.r0[i] == p.r0[j] and p.r1[i] == p.r1[j]
                          and p.c1[i] + 1 == p.c0[j])
                if ok:
                    out.append((i, j, row_adj))
                    used.update((i, j))
        return out

    def _do_merge(self, a: int, b: int, row_adj: bool) -> int:
        p = self.index.parts
        ar0, ac0 = p.r0[a], p.c0[a]
        br0, bc0 = p.r0[b], p.c0[b]
        new = p.allocate(int(min(ar0, br0)), int(min(ac0, bc0)),
                         int(max(p.r1[a], p.r1[b])), int(max(p.c1[a], p.c1[b])),
                         owner=int(p.owner[a]), parent=a,
                         prev_machine=int(p.owner[a]), birth_round=self.round_no)
        self._sync_capacity()
        st = self.stats
        if row_adj:
            lo, hi = (a, b) if ar0 < br0 else (b, a)
            sp = int(p.r1[lo])
            for ch in S.MAINTAINED:
                # cols: same col span → elementwise sum is exact for N/R
                st.cols[ch, new] = st.cols[ch, lo] + st.cols[ch, hi]
                # rows: lo prefix, then hi suffix shifted by lo's totals
                st.rows[ch, new] = 0.0
                st.rows[ch, new, : sp + 1] = st.rows[ch, lo, : sp + 1]
                st.rows[ch, new, sp + 1:] = st.rows[ch, hi, sp + 1:] + st.rows[ch, lo, sp]
            st.rows[S.SPANQ, new, sp + 1] = 0.0
            st.rows[S.PRESPANQ, new, sp + 1] = 0.0
        else:
            lo, hi = (a, b) if ac0 < bc0 else (b, a)
            sp = int(p.c1[lo])
            for ch in S.MAINTAINED:
                st.rows[ch, new] = st.rows[ch, lo] + st.rows[ch, hi]
                st.cols[ch, new] = 0.0
                st.cols[ch, new, : sp + 1] = st.cols[ch, lo, : sp + 1]
                st.cols[ch, new, sp + 1:] = st.cols[ch, hi, sp + 1:] + st.cols[ch, lo, sp]
            st.cols[S.SPANQ, new, sp + 1] = 0.0
            st.cols[S.PRESPANQ, new, sp + 1] = 0.0
        if self.store is not None:
            # same-owner merge: counts re-home, nothing crosses the wire
            self.store.migrate(a, new)
            self.store.migrate(b, new)
        p.retire(a)
        p.retire(b)
        return new

    # ------------------------------------------------------------------
    def _sync_capacity(self) -> None:
        """Grow the stats bank alongside the partition table."""
        cap = self.index.parts.capacity
        if self.store is not None:
            self.store.ensure(cap)
        if self.stats.rows.shape[1] < cap:
            pad = cap - self.stats.rows.shape[1]
            self.stats.rows = np.concatenate(
                [self.stats.rows, np.zeros((S.NUM_CH, pad, self.g + 1), np.float32)], 1)
            self.stats.cols = np.concatenate(
                [self.stats.cols, np.zeros((S.NUM_CH, pad, self.g + 1), np.float32)], 1)

    # Convenience -------------------------------------------------------
    def machine_loads(self) -> np.ndarray:
        """Current C(m) per machine (for monitoring/benchmarks)."""
        return self._collect().costs
