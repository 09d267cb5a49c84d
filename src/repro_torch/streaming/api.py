"""Typed event/decision API of the streaming runtime.

The engine↔router boundary is a small set of frozen event batches and
one formal entry point::

    Router.ingest(batch: EventBatch) -> RoutingDecision | None

* ``TupleBatch``     — stream tuples to route (the data plane hot path).
* ``QueryBatch``     — continuous queries to register as resident state.
* ``ProbeBatch``     — one-shot snapshot probes over stored tuples.
* ``MachineFailure`` — crash-stop notification for one executor.
* ``MachineJoin``    — an executor (re)joins the cluster, optionally at
  a non-unit capacity factor (elastic scale-out, §4.1.1 / CheetahGIS).
* ``MachineSlow``    — an executor's effective capacity changes (a
  straggler appears or recovers); adaptive routers fold the factor into
  their cost model so the Fig-9 FSM sheds the machine's load.

``ingest`` answers with a :class:`RoutingDecision` (owner machine, work
cost and partition per item) for work-carrying batches, and ``None`` for
pure state changes (query registration, joins, slowdowns).  A
``MachineFailure`` may instead answer with a :class:`RoundOutcome`
describing the emergency re-homing it triggered (recovery transfers,
moved queries, migration bytes) so the engine can bill the receivers'
install work like any rebalancing round.  Per-round control
traffic is typed as :class:`RoundOutcome`; executor memory accounting as
:class:`MemoryUsage`.  The engine contains **no** per-query-model
branches: which events a workload emits is decided here, by
:class:`EventStream`, from the ``repro.queries`` registry — adding a new
query/persistence model means registering a spec and emitting the right
batches, not editing the engine.

Migration note: ``route_points`` / ``route_snapshots`` /
``register_queries`` survive as router-internal methods, but the
supported entry point is ``ingest`` — see README "Event-stream API".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Protocol, Union, runtime_checkable

import numpy as np

from ..core.planner import TransferRecord
from ..core.protocol import RoundReport
from ..queries import TermHasher, WorkloadSpec
from ..telemetry.records import DecisionRecord

if TYPE_CHECKING:  # pragma: no cover
    from .sources import ScenarioSource


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TupleBatch:
    """A batch of stream tuples: ``xy`` is (N, 2) float32 in [0, 1)².

    Spatial-keyword workloads additionally carry ``terms`` — (N, K)
    int64 vocabulary term ids per tuple — and ``buckets``, the hashed
    (N, K+1) int32 probe-bucket encoding (sorted, deduped, trailing
    wildcard column; ``queries.keywords.TermHasher.tuple_buckets``).
    Both stay ``None`` for pure-spatial workloads, keeping those
    batches byte-identical to before the pub/sub subsystem.

    ``cells`` is optional ingest-tier routing metadata: the flat grid
    cell id (``row * cells_grid + col``) of each tuple on a
    ``cells_grid``-sized uniform grid, precomputed where the data is
    born (replay sources carry it for their static pool, exactly like
    the coordinates themselves).  Cell ids depend only on the grid
    geometry — never on the routing plan — so they are plan-invariant
    and safe to precompute.  Consumers must check ``cells_grid``
    matches their own grid before trusting ``cells``; it is a hint, and
    ``None`` keeps the batch identical to before."""

    xy: np.ndarray
    tick: int = 0
    terms: np.ndarray | None = None
    buckets: np.ndarray | None = None
    cells: np.ndarray | None = None
    cells_grid: int = 0

    def __len__(self) -> int:
        return len(self.xy)


@dataclass(frozen=True)
class QueryBatch:
    """Continuous queries to register: ``rects`` is (Q, 4) float32
    (x0, y0, x1, y1).  Spatial-keyword subscriptions also carry
    ``terms`` — (Q, Ks) int64 term ids each registered subscription
    conjoins with its rectangle (``None`` for pure-spatial models)."""

    rects: np.ndarray
    tick: int = 0
    terms: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.rects)


@dataclass(frozen=True)
class ProbeBatch:
    """One-shot snapshot probes: ``rects`` is (Q, 4) float32."""

    rects: np.ndarray
    tick: int = 0

    def __len__(self) -> int:
        return len(self.rects)


@dataclass(frozen=True)
class MachineFailure:
    """Crash-stop failure of executor ``machine``."""

    machine: int
    tick: int = 0


@dataclass(frozen=True)
class MachineJoin:
    """Executor ``machine`` (re)joins the cluster at ``capacity_factor``
    × nominal per-tick capacity.  Joining a slot that is already alive
    only updates the factor."""

    machine: int
    tick: int = 0
    capacity_factor: float = 1.0


@dataclass(frozen=True)
class MachineSlow:
    """Effective-capacity change of executor ``machine``: ``factor`` < 1
    is a straggler, ``factor`` = 1 restores nominal speed."""

    machine: int
    factor: float
    tick: int = 0


MembershipChange = Union[MachineFailure, MachineJoin, MachineSlow]

EventBatch = Union[TupleBatch, QueryBatch, ProbeBatch, MachineFailure,
                   MachineJoin, MachineSlow]


# ---------------------------------------------------------------------------
# Decisions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RoutingDecision:
    """Per-item routing answer for a work-carrying batch.

    ``owners``  — (N,) int32, executor machine per item.
    ``costs``   — (N,) float32, work units per item (the engine enqueues
                  these against machine capacity).
    ``pids``    — (N,) int32, global-index partition per item (−1 where
                  no partition applies, e.g. round-robin routing still
                  carries the shadow-grid pid used for accounting).
    ``deliveries`` — (N,) float64 expected subscription deliveries per
                  tuple (spatial-keyword workloads; the engine bills
                  their fan-out as wire bytes).  ``None`` otherwise.
    """

    owners: np.ndarray
    costs: np.ndarray
    pids: np.ndarray
    deliveries: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.owners)


@dataclass(frozen=True)
class RoundOutcome:
    """Typed result of one load-balancing round (replaces the old
    mutable ``RoundInfo``).

    ``transfers`` carries every m_H→m_L reduction the round applied —
    one per concurrently rebalanced machine pair since the multi-pair
    planner (``core.planner``); ``action`` keeps the first transfer's
    kind for the legacy single-pair view.  ``moved_by_transfer`` (when
    provided, aligned with ``transfers``) says how many resident
    queries each transfer delivered to its receiver ``m_L`` — the
    engine bills the per-query install work there, on the machine that
    actually receives it.
    """

    wire_bytes: int = 0        # coordinator statistics traffic (Fig 20)
    migration_bytes: int = 0   # moved queries + (STORED) moved data bytes
    moved_queries: int = 0
    moved_tuples: int = 0      # stored tuples re-homed this round
    action: str = "none"
    transfers: tuple[TransferRecord, ...] = ()
    moved_by_transfer: tuple[int, ...] = ()   # per-transfer receiver counts
    # flight-recorder record for this round (telemetry.records) — the
    # full why of the decision; None for no-op rounds of non-adaptive
    # routers (NO_ROUND)
    decision_record: DecisionRecord | None = None

    @classmethod
    def from_report(cls, rep: RoundReport, *, moved_queries: int = 0,
                    bytes_per_query: int = 0,
                    moved_by_transfer: tuple[int, ...] = (),
                    record: DecisionRecord | None = None
                    ) -> "RoundOutcome":
        """Consume a typed ``core.protocol.RoundReport``: fold the
        coordinator wire bytes, STORED data shipment, the transfer set
        and the caller's moved-query count into one engine-facing
        outcome."""
        return cls(
            wire_bytes=rep.wire_bytes,
            migration_bytes=rep.data_bytes + moved_queries * bytes_per_query,
            moved_queries=moved_queries,
            moved_tuples=rep.moved_tuples,
            action=rep.action,
            transfers=rep.transfers,
            moved_by_transfer=moved_by_transfer,
            decision_record=record if record is not None else rep.record,
        )


NO_ROUND = RoundOutcome()


@dataclass(frozen=True)
class MemoryUsage:
    """Per-machine executor memory accounting.  ``tuples`` is all zeros
    unless the workload's persistence model makes resident data count
    against executor memory (STORED)."""

    queries: np.ndarray
    tuples: np.ndarray


# ---------------------------------------------------------------------------
# The Router protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class Router(Protocol):
    """What the engine requires of a routing approach.  All four systems
    of the paper's evaluation (replicated, static-uniform,
    static-history, SWARM) implement this via ``baselines._Base``."""

    workload: WorkloadSpec

    @property
    def q_total(self) -> int: ...

    def ingest(self, batch: EventBatch
               ) -> "RoutingDecision | RoundOutcome | None": ...

    def on_round(self, tick: int) -> RoundOutcome: ...

    def end_tick(self) -> None: ...

    def memory_usage(self) -> MemoryUsage: ...


# ---------------------------------------------------------------------------
# Source → event adaptation
# ---------------------------------------------------------------------------

class EventStream:
    """Adapts a ``ScenarioSource`` + ``WorkloadSpec`` into typed event
    batches.  This is where the query-model dispatch lives: continuous
    models emit ``QueryBatch`` arrivals, the snapshot model emits
    ``ProbeBatch`` arrivals — the engine just ingests whatever comes."""

    def __init__(self, source: "ScenarioSource", workload: WorkloadSpec):
        self.source = source
        self.workload = workload
        # term hashing lives at the event boundary: sources emit raw
        # vocabulary ids, routers/planes only ever see hashed buckets
        self.hasher = (TermHasher(workload.term_buckets)
                       if workload.spec.keyword else None)

    def arrivals(self, tick: int) -> list[EventBatch]:
        """Query/probe arrivals for this tick (tuple injection is
        rate-controlled by the engine via :meth:`tuples`)."""
        wl = self.workload
        events: list[EventBatch] = []
        if wl.spec.snapshot:
            rects = self.source.snapshot_arrivals(tick, wl.snapshot_rate,
                                                  wl.snapshot_side)
            if len(rects):
                events.append(ProbeBatch(rects, tick))
        else:
            rects = self.source.query_arrivals(tick)
            if len(rects):
                events.append(QueryBatch(rects, tick,
                                         self._sub_terms(len(rects), tick)))
        return events

    def _sub_terms(self, n: int, tick: int) -> np.ndarray | None:
        if self.hasher is None:
            return None
        return self.source.sample_subscription_terms(
            n, tick, self.workload.sub_terms)

    def tuples(self, n: int, tick: int) -> TupleBatch:
        xy = self.source.sample_points(n, tick)
        # ingest-tier cell ids: sources that precompute them publish the
        # slice aligned with the points they just served (ReplaySource)
        cells = getattr(self.source, "last_cells", None)
        cg = int(getattr(self.source, "cell_grid", 0)) if cells is not None \
            else 0
        if self.hasher is None:
            return TupleBatch(xy, tick, cells=cells, cells_grid=cg)
        terms = self.source.sample_terms(xy, tick,
                                         self.workload.tuple_terms)
        return TupleBatch(xy, tick, terms, self.hasher.tuple_buckets(terms),
                          cells=cells, cells_grid=cg)

    def next_arrival(self, tick: int) -> int | None:
        """First tick ≥ ``tick`` that will emit query/probe arrivals,
        ``None`` if there are none.  The fused engine path cuts its
        scan windows here — *predicting* arrivals must not consume the
        source RNG, so sources expose their deterministic schedules via
        ``next_query_arrival`` / ``next_probe_arrival``; a source
        without one conservatively reports ``tick`` (every tick is a
        potential arrival, forcing the per-tick path)."""
        wl = self.workload
        if wl.spec.snapshot:
            if wl.snapshot_rate <= 0:
                return None
            sched = getattr(self.source, "next_probe_arrival", None)
            return tick if sched is None else sched(tick)
        sched = getattr(self.source, "next_query_arrival", None)
        if sched is None:
            return tick
        return sched(tick)

    # -- cluster-membership schedule (elasticity) -----------------------
    def membership(self, tick: int) -> list[MembershipChange]:
        """Scheduled membership changes firing at exactly ``tick``,
        as typed events (sources carry plain ``MembershipEvent``
        schedule entries; the kind→event mapping lives here)."""
        sched = getattr(self.source, "membership_events", None)
        if sched is None:
            return []
        out: list[MembershipChange] = []
        for ev in sched(tick):
            if ev.kind == "fail":
                out.append(MachineFailure(ev.machine, tick))
            elif ev.kind == "join":
                out.append(MachineJoin(ev.machine, tick, ev.factor))
            elif ev.kind == "slow":
                out.append(MachineSlow(ev.machine, ev.factor, tick))
            else:
                raise ValueError(f"unknown membership kind {ev.kind!r}")
        return out

    def next_membership(self, tick: int) -> int | None:
        """First tick ≥ ``tick`` with a scheduled membership change
        (deterministic — the fused path cuts windows here, exactly as
        at query arrivals)."""
        sched = getattr(self.source, "next_membership_event", None)
        return sched(tick) if sched is not None else None

    def preload(self, n: int) -> QueryBatch | None:
        """Initial resident queries — only continuous models have any."""
        if n <= 0 or not self.workload.spec.continuous:
            return None
        return QueryBatch(self.source.sample_queries(n), 0,
                          self._sub_terms(n, 0))
