"""Flight-recorder records: *why* each round decided what it did.

The tracer (``telemetry.tracer``) answers *when* and *how long*; these
frozen dataclasses answer *why*.  A :class:`DecisionRecord` is built by
``core/protocol.Swarm`` at every round close — FSM state before/after,
the R(S) trend the FSM saw, the per-machine collected costs the planner
ranked, every candidate (m_H, m_L) pair it considered with the outcome
(subset move, split, or skip and for what reason), the chosen splits
with their cost curves, and the realized transfers with wire/data
byte accounting.  Records are kept on ``Swarm.decision_log`` and
surfaced per-round on ``RoundReport.record`` / ``RoundOutcome.
decision_record`` — the flight recorder is always on (rounds are rare;
recording one is a few hundred ns), independent of whether a
:class:`~repro.telemetry.tracer.Tracer` is capturing spans.

Everything here is value-like and wall-clock free, so two runs with
the same seed and scenario produce *identical* records on either data
plane — the property the determinism tests pin.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _to_jsonable(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _to_jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _to_jsonable(x) for k, x in v.items()}
    if hasattr(v, "item"):          # numpy scalar
        return v.item()
    return v


@dataclass(frozen=True)
class FsmState:
    """Snapshot of the Fig-9 FSM (``core.balancer.DecisionState``)."""

    stage: int
    decision: int
    same_count: int
    pre_rs: float

    @classmethod
    def capture(cls, ds) -> "FsmState":
        return cls(int(ds.stage), int(ds.decision), int(ds.same_count),
                   float(ds.pre_rs))


@dataclass(frozen=True)
class SplitChoice:
    """One chosen partition split and its cost curve at the split
    point (mirrors ``core.planner.SplitPlan``)."""

    pid: int
    axis: str            # "row" | "col"
    sp: int              # split line index
    move_lo: bool        # True: low half moves to m_L
    c_diff: float        # |C(lo) - C(hi)| at the chosen line
    cost_lo: float
    cost_hi: float


@dataclass(frozen=True)
class CandidateDecision:
    """One (m_H, m_L) pairing the planner considered, and what came of
    it.  ``outcome`` is one of ``"subset"`` (whole partitions moved),
    ``"split"`` (one partition split), ``"skip"`` (pair rejected —
    ``reason`` says why), or ``"evacuate"`` (failover reassignment)."""

    m_h: int
    m_l: int
    c_mh: float          # collected cost of the overloaded machine
    c_ml: float          # collected cost of the underloaded machine
    outcome: str
    reason: str = ""
    pids: tuple = ()     # partitions moved / split / evacuated
    moved_cost: float = 0.0


@dataclass(frozen=True)
class TransferTrace:
    """One realized transfer.  The first five fields mirror
    ``core.planner.TransferRecord`` exactly (the acceptance contract:
    ``DecisionRecord.transfers`` must match ``RoundReport.transfers``);
    ``split`` carries the cost-curve detail for split transfers and
    ``moved_queries`` is filled in by the router after it reindexes."""

    m_h: int
    m_l: int
    action: str          # "subset" | "split"
    moved_pids: tuple
    new_pids: tuple
    split: SplitChoice | None = None
    moved_queries: int = -1


@dataclass(frozen=True)
class DecisionRecord:
    """Everything one round close knew and decided.

    ``kind`` is ``"round"`` for FSM-driven rounds, ``"recovery"`` for
    failover evacuations, ``"forced"`` for baseline-forced rebalances.
    ``costs`` are the per-machine collected costs the planner ranked
    (dead machines hold 0).  Wall-clock never appears here — records
    from same-seed runs compare equal.
    """

    round_no: int
    kind: str
    decision: int                    # balancer.DO_NOTHING | REBALANCE
    r_s: float                       # throughput signal this round
    r_s_prev: float                  # FSM's pre_rs before stepping
    improved: bool
    fsm_before: FsmState | None
    fsm_after: FsmState | None
    costs: tuple = ()                # per-machine collected costs
    candidates: tuple = ()           # CandidateDecision, planner order
    transfers: tuple = ()            # TransferTrace, realized order
    wire_bytes: int = 0
    data_bytes: int = 0
    moved_tuples: int = 0
    evacuated: int = -1              # machine evacuated (recovery only)
    moved_queries: int = -1          # filled by the router
    migration_bytes: int = -1        # filled by the router
    moved_by_transfer: tuple = ()    # queries moved per transfer
    # geo links (DESIGN.md §12): transfer payloads ride real links and
    # may be severed mid-flight — retry/abort counts are folded back
    # into the round's record as they happen (Swarm.note_transfer_event)
    retries: int = 0
    aborts: int = 0

    @property
    def did_rebalance(self) -> bool:
        return bool(self.transfers)

    def to_dict(self) -> dict:
        return _to_jsonable(self)


def candidates_from_plan(plan) -> tuple:
    """``RoundPlan.candidates`` already holds CandidateDecisions; kept
    as a seam so callers never reach into planner internals."""
    return tuple(plan.candidates)


def transfer_traces(plan_transfers, records) -> tuple:
    """Zip the planner's intended transfers with the realized
    ``TransferRecord`` list from ``Swarm._apply_plan`` into
    :class:`TransferTrace` rows (split detail from the plan side)."""
    by_pair = {}
    for t in plan_transfers:
        sp = t.plan.split
        if sp is not None:
            by_pair[(t.m_h, t.m_l)] = SplitChoice(
                int(sp.pid), sp.axis, int(sp.sp), bool(sp.move_lo),
                float(sp.c_diff), float(sp.c_lo), float(sp.c_hi))
    return tuple(
        TransferTrace(int(r.m_h), int(r.m_l), r.action,
                      tuple(int(p) for p in r.moved_pids),
                      tuple(int(p) for p in r.new_pids),
                      split=by_pair.get((r.m_h, r.m_l)))
        for r in records)
