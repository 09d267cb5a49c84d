"""Discrete-time distributed streaming engine (the Storm stand-in).

Each tick ≈ one load-balancing round (15 s in the paper).  Machines have
a work capacity per tick; processing a tuple routed to partition p costs
``c0 + kappa·Qres(p)`` units (the tuple-vs-resident-queries check — the
very quantity the paper's *Units of Work* metric counts).  Queues build
on overloaded machines; Storm-style spout backpressure throttles the
*global* injection rate to the slowest machine (multiplicative decrease,
slow additive recovery — which produces the sawtooth of Fig 14).

Metrics per tick: units of work (= processed tuples × Q_total, §6.1),
mean execution latency, per-machine utilization, network bytes.

Cluster membership is elastic (§4.1.1): scenario sources may carry a
deterministic schedule of ``MachineFailure`` / ``MachineJoin`` /
``MachineSlow`` events, applied at the top of each tick.  A scheduled
failure silences the machine (it stops heartbeating and its queue is
lost); the ``ft.CoordinatorGroup`` driven by the engine's per-tick
heartbeats *detects* the silence after ``EngineConfig.heartbeat_timeout``
beats and only then notifies the router, which re-homes the dead
machine's partitions through the planner's emergency redistribution —
rank-order Coordinator failover is billed as wire bytes when the dead
machine led the group.  Joins and slowdowns adjust the per-machine
effective capacity (``cap_factor``); adaptive routers fold the factor
into their cost model and shed a straggler's load through ordinary
FSM-gated rounds.  ``StreamingEngine.fail_machine`` remains the
immediate (out-of-band notification) path.

The engine is workload-agnostic: it drives the typed event/decision API
of ``streaming.api`` and contains no per-query-model branches.  Which
events a tick carries (``QueryBatch`` registrations vs one-shot
``ProbeBatch`` work) is decided by :class:`~repro.streaming.api.EventStream`
from the workload's registered query-model spec; persistence shows up
only through the router's ``memory_usage()`` accounting and ``end_tick``
upkeep.

Two run modes share these semantics: :meth:`StreamingEngine.step` (the
per-tick reference loop) and :meth:`StreamingEngine.run_fused`, the
device-resident fast path — steady-state ticks are pre-staged and
executed as scanned windows on the router's data plane, crossing the
host boundary only at query arrivals, failures and round boundaries
(where ``core.planner.plan_round`` runs and the resident state is
scatter-patched).  ``EngineConfig.fused_window > 0`` makes ``run``
dispatch to the fused mode, so the experiment suite can sweep it.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np

from ..core import geometry
from ..core.cost_model import CostReport, delivery_wire_bytes
from ..ft import CoordinatorGroup, LinkModel, LinkSpec
from ..telemetry import NOOP, TelemetryConfig, Tracer, activate
from ..telemetry.tracer import _NULL_SPAN
from .api import (NO_ROUND, EventStream, MachineFailure, MachineJoin,
                  MachineSlow, MembershipChange, ProbeBatch, QueryBatch,
                  Router, RoundOutcome, RoutingDecision)
from .fused import (EngineCarry, FusedOutputs, FusedParams,
                    host_process_tick)
from .sources import ScenarioSource

# name of the profiler-capture anchors (``record_function`` + instant)
PROFILER_ANCHOR = "profiler_anchor"


@dataclass
class EngineConfig:
    num_machines: int = 22
    cap_units: float = 4.0e5        # work units per machine per tick
    lambda_max: float = 6.0e3       # injected tuples/tick ceiling (source rate)
    mem_queries: int = 50_000       # resident-query capacity per machine
    mem_tuples: float = 1.0e6       # stored-tuple capacity per machine
    bp_high: float = 2.0            # queue > bp_high·cap ⇒ backpressure
    bp_dec: float = 0.6
    bp_inc: float = 0.04            # additive recovery, fraction of λmax
    round_every: int = 1            # ticks per load-balancing round
    migration_unit_cost: float = 2.0  # work units to install one moved query
    fused_window: int = 0           # >0: run() scans W-tick fused windows
    devices: int = 0                # >0: shard the "sharded" data plane
    #                                 over this many mesh devices (0 =
    #                                 all visible; non-sharded planes
    #                                 ignore the knob)
    heartbeat_timeout: int = 3      # missed beats before a machine is dead
    standby_machines: int = 0       # trailing slots that start outside
    #                                 the cluster (elastic join targets)
    # geo fault model (DESIGN.md §12).  ``links`` adds a per-pair
    # latency/jitter matrix: heartbeats and transfer payloads ride the
    # links and arrive late; None keeps the instantaneous network (the
    # golden-pinned default).  ``adaptive_detector`` swaps the fixed
    # missed-beat counter for a phi-accrual-style per-member threshold
    # learned from observed beat gaps, so jittery links do not cause
    # false suspicion.  Interrupted transfers retry with exponential
    # backoff up to ``max_transfer_retries`` attempts.
    links: LinkSpec | None = None
    adaptive_detector: bool = False
    max_transfer_retries: int = 8
    # a falsely-failed-over machine rejoins *cold*: its state restores
    # from the last checkpoint and it serves at ``revive_cold_factor``
    # of its capability for ``revive_recovery_ticks`` ticks before it
    # is warm again.  Only the revival path pays this — genuine crash
    # recovery (standby joins) is priced by the membership timeline.
    revive_cold_factor: float = 0.25
    revive_recovery_ticks: int = 6
    # None (default) keeps the zero-overhead no-op tracer; a
    # TelemetryConfig turns on spans/counters and (via trace_dir) the
    # JSONL + Perfetto exporters — see repro.telemetry / DESIGN.md §9
    telemetry: TelemetryConfig | None = None
    # runtime protocol sanitizer (repro.analysis.sanitizer, DESIGN.md
    # §13): assert the conservation laws — queue/tuple conservation,
    # disjoint partition cover, collector deposits == drains, billed ==
    # resharded bytes — every tick/round, ASAN-style.  REPRO_SANITIZE=1
    # enables it without touching experiment labels.
    sanitize: bool = False


@dataclass
class Metrics:
    units_of_work: list = field(default_factory=list)
    latency: list = field(default_factory=list)
    throughput: list = field(default_factory=list)
    q_total: list = field(default_factory=list)
    utilization: list = field(default_factory=list)   # (M,) per tick
    wire_bytes: list = field(default_factory=list)
    migration_bytes: list = field(default_factory=list)
    moved_tuples: list = field(default_factory=list)
    transfers: list = field(default_factory=list)     # rebalance pairs/tick
    retried_transfers: list = field(default_factory=list)   # geo retries/tick
    aborted_transfers: list = field(default_factory=list)   # geo aborts/tick
    false_suspicions: list = field(default_factory=list)    # revived/tick
    snapshots: list = field(default_factory=list)     # one-shot probes/tick
    deliveries: list = field(default_factory=list)    # pub/sub fan-out/tick
    resident_tuples: list = field(default_factory=list)  # max per machine
    injected: list = field(default_factory=list)
    alive: list = field(default_factory=list)         # (M,) membership mask
    cap_factor: list = field(default_factory=list)    # (M,) effective speed
    # any tick ever hit a memory wall (Fig-11 reporting); injection is
    # gated by the *per-tick* check, so pressure that recedes (decay,
    # rebalancing) lets the stream resume instead of latching it off
    was_infeasible: bool = False

    @property
    def infeasible(self) -> bool:
        """Legacy alias of :attr:`was_infeasible`."""
        return self.was_infeasible

    def asarrays(self) -> dict:
        return {k: np.asarray(v) for k, v in self.__dict__.items()
                if isinstance(v, list)}


@dataclass
class _InFlight:
    """One transfer payload riding a geo link (links mode only): the
    round's migration bytes are split across its transfers and each
    share completes — and is billed — when it arrives at ``m_l``."""

    m_h: int
    m_l: int
    round_no: int        # DecisionRecord round (retries fold back there)
    moved_queries: int
    bytes: int
    tuples: int
    sent: int
    arrive: int
    attempts: int = 1


class StreamingEngine:
    def __init__(self, router: Router, source: ScenarioSource,
                 config: EngineConfig | None = None):
        self.router = router
        self.source = source
        self.stream = EventStream(source, router.workload)
        self.cfg = config or EngineConfig()
        m = self.cfg.num_machines
        self.queue_units = np.zeros(m)
        self.queue_tuples = np.zeros(m)
        self.alive = np.ones(m, bool)
        # per-machine effective-capacity factor: 1 = nominal, < 1 is a
        # straggler; a join may bring heterogeneous hardware
        self.cap_factor = np.ones(m)
        standby = max(0, min(self.cfg.standby_machines, m - 1))
        if standby:
            self.alive[m - standby:] = False
        self.lam_bp = self.cfg.lambda_max
        self.metrics = Metrics()
        self.tick_no = 0
        # the tracer: a live buffering Tracer only when the config asks
        # for one, otherwise the shared no-op singleton (zero-overhead
        # contract — hot paths guard on ``tracer.enabled``)
        tcfg = self.cfg.telemetry
        self.tracer = (Tracer(tcfg)
                       if tcfg is not None and tcfg.enabled else NOOP)
        self._fused = None   # device-resident state cache (run_fused)
        self.declined_windows = 0   # fused windows whose full batch failed
        # geo fault model (DESIGN.md §12): per-pair link latency/jitter
        # and the compiled chaos schedule (carried by the source, like
        # membership timelines).  ``_faults`` gates every new code path
        # so the default run is bit-identical to the pre-geo engine.
        self.links = (LinkModel(self.cfg.links, m)
                      if self.cfg.links is not None else None)
        cspec = getattr(source, "chaos", None)
        self.chaos = cspec.compile(m) if cspec is not None else None
        self._faults = self.links is not None or self.chaos is not None
        # cold-start grace: a member that has never been heard from is
        # not "silent" until its first beat has had time to cross the
        # slowest link — without this every cross-region machine is
        # suspected at boot, before a beat could possibly arrive
        self._boot_grace = max(self.cfg.heartbeat_timeout, 1) + (
            self.links.max_delay_ticks() if self.links is not None else 0)
        # heartbeat table (ft layer): every member beats once per tick;
        # the group detects silent machines and elects by rank order
        self.coord = CoordinatorGroup(
            m, heartbeat_timeout=max(self.cfg.heartbeat_timeout, 1),
            adaptive=self.cfg.adaptive_detector)
        for s in range(m - standby, m):
            self.coord.suspend(s)
        self._coordinator = self.coord.coordinator()
        self._pending_detect: dict[int, int] = {}  # machine → detect tick
        self._pending_beats: dict[int, list[int]] = {}  # arrive tick → who
        self._in_flight: list[_InFlight] = []      # transfer payloads
        self._partitioned: dict[int, int] = {}     # machine → heal tick
        self._suspected: set[int] = set()          # live but evacuated
        self._chaos_drop: set[int] = set()         # staged for this tick
        self._chaos_delay: dict[int, int] = {}
        self._recover_at: dict[int, int] = {}      # machine → warm tick
        self._recover_cap: dict[int, float] = {}   # machine → warm factor
        self.transfer_stats = {
            "dispatched": 0, "completed": 0, "retried": 0, "aborted": 0,
            "dispatched_bytes": 0, "billed_bytes": 0, "aborted_bytes": 0}
        # control/migration traffic of membership changes, folded into
        # the metrics row of the tick that records next
        # (wire, migration, tuples, pairs, retried, aborted, false_susp)
        self._acc = np.zeros(7, np.int64)
        # protocol sanitizer (opt-in): wraps the router's data plane so
        # collector/reshard laws are checked at the plane boundary, and
        # hooks the tick/round paths below for the engine-level laws
        self.san = None
        if self.cfg.sanitize or os.environ.get("REPRO_SANITIZE") == "1":
            from ..analysis.sanitizer import ProtocolSanitizer
            self.san = ProtocolSanitizer()
            if getattr(router, "plane", None) is not None:
                router.plane = self.san.wrap_plane(router.plane)

    def _eff_alive(self) -> np.ndarray:
        """The (M,) effective per-machine capacity mask: the alive mask
        scaled by each machine's capacity factor (stragglers < 1)."""
        return self.alive * self.cap_factor

    # ------------------------------------------------------------------
    def preload_queries(self, rects: np.ndarray) -> None:
        self.router.ingest(QueryBatch(rects, self.tick_no))

    def fail_machine(self, m: int) -> None:
        """Immediate crash-stop (out-of-band notification): the machine
        is silenced *and* the router learns right away — the legacy
        test/benchmark entry point.  Scheduled failures instead go
        through heartbeat detection (``EngineConfig.heartbeat_timeout``
        ticks of silence before the router is told)."""
        # drain device-held collector deltas before the failure handler
        # re-homes partitions (their stats rows move with them)
        with activate(self.tracer):
            self._fused_sync_collectors()
            self._silence(m)
            self.coord.suspend(m)
            self._pending_detect.pop(m, None)
            self._notify_failure(m)

    def _silence(self, m: int) -> None:
        """The machine stops working and heartbeating; queued work on a
        crashed machine is lost (at-most-once spouts).  Beats already in
        flight on a geo link still arrive (they were sent while alive) —
        detection is delayed accordingly, never un-done."""
        self.alive[m] = False
        self._suspected.discard(m)   # a real crash ends any suspicion
        self._recover_at.pop(m, None)
        self._recover_cap.pop(m, None)
        self.queue_units[m] = 0.0
        self.queue_tuples[m] = 0.0

    def _notify_failure(self, m: int) -> None:
        """Tell the router about a (detected) crash-stop and absorb the
        emergency re-homing it answers with; fail over the Coordinator
        by rank order if the dead machine led the group."""
        if self.tracer.enabled:
            self.tracer.instant("failure_detected", tick=self.tick_no,
                                machine=m)
        self._absorb_outcome(self.router.ingest(
            MachineFailure(m, self.tick_no)))
        # work routed at the stale plan between failure and detection
        # piled up on the silent machine — it is lost with the crash
        self.queue_units[m] = 0.0
        self.queue_tuples[m] = 0.0
        self._refresh_coordinator()

    def _refresh_coordinator(self) -> None:
        """Rank-order failover (§4.1.1, DESIGN.md §3): the lowest-ranked
        live member leads.  A leadership change makes every live member
        re-send its per-round report to the new Coordinator — billed as
        wire bytes on the current tick."""
        try:
            new = self.coord.coordinator()
        except RuntimeError:
            return    # whole group silent; keep the stale leader
        if new != self._coordinator:
            self._coordinator = new
            live = len(self.coord.live_members())
            self._acc[0] += live * CostReport.WIRE_BYTES
            if self.tracer.enabled:
                self.tracer.instant(
                    "coordinator_failover", tick=self.tick_no,
                    new_leader=new,
                    billed_bytes=live * CostReport.WIRE_BYTES)

    def apply_membership(self, ev: MembershipChange) -> None:
        """Apply one scheduled membership change at the current tick."""
        t = self.tick_no
        if self.tracer.enabled:
            kind = type(ev).__name__
            self.tracer.instant(f"membership:{kind}", tick=t,
                                machine=ev.machine)
        if isinstance(ev, MachineFailure):
            m = ev.machine
            if self.alive[m]:
                self._silence(m)
                # instantaneous network: the detect tick is closed-form
                # (timeout beats of silence).  With links/chaos the gap
                # depends on in-flight beats and the adaptive threshold,
                # so the value is only a watch marker — the fused
                # boundary probe (_next_fault_tick) simulates the real
                # detection tick.
                self._pending_detect[m] = (
                    t if self._faults
                    else t + max(self.cfg.heartbeat_timeout, 1) - 1)
        elif isinstance(ev, MachineJoin):
            m = ev.machine
            if not self.alive[m]:
                # fresh/standby slot: nothing queued survives a (re)join
                self.queue_units[m] = 0.0
                self.queue_tuples[m] = 0.0
            self.alive[m] = True
            self.cap_factor[m] = float(ev.capacity_factor)
            self._pending_detect.pop(m, None)
            self._suspected.discard(m)
            self._recover_at.pop(m, None)   # explicit join sets its own cap
            self._recover_cap.pop(m, None)
            self.coord.beat(m)
            self._absorb_outcome(self.router.ingest(
                MachineJoin(m, t, float(ev.capacity_factor))))
            self._refresh_coordinator()
        elif isinstance(ev, MachineSlow):
            self.cap_factor[ev.machine] = float(ev.factor)
            self._absorb_outcome(self.router.ingest(
                MachineSlow(ev.machine, float(ev.factor), t)))
        else:
            raise TypeError(f"not a membership change: {ev!r}")

    def _membership_tick(self, t: int) -> None:
        """Top-of-tick membership processing: scheduled events, chaos
        injection, one heartbeat round (link-delayed under a geo
        topology), failure detection — timeout-based for silenced
        machines, suspicion of live-but-unheard ones — and in-flight
        transfer arrivals."""
        for ev in self.stream.membership(t):
            self.apply_membership(ev)
        self._chaos_tick(t)
        with self.tracer.span("heartbeat_scan", tick=t):
            self._beat_tick(t)
            live = None
            if self._pending_detect:
                live = set(self.coord.live_members())
                for m in [m for m in self._pending_detect
                          if m not in live]:
                    del self._pending_detect[m]
                    self._fused_sync_collectors()
                    self._notify_failure(m)
            if self._faults:
                if live is None:
                    live = set(self.coord.live_members())
                for m in map(int, np.nonzero(self.alive)[0]):
                    if m in live or m in self._suspected:
                        continue
                    if self.coord.last_beat.get(m, 0) == 0 \
                            and t < self._boot_grace:
                        continue   # first beat still riding the link
                    self._suspect_live(m, t)
        if self._recover_at:
            for m in [m for m, tt in self._recover_at.items() if tt <= t]:
                if m in self._suspected:
                    continue   # suspected again mid-restore: wait for
                #              the next revival to restart the clock
                del self._recover_at[m]
                warm = self._recover_cap.pop(m)
                self.cap_factor[m] = warm
                self._absorb_outcome(self.router.ingest(
                    MachineSlow(m, warm, t)))
        self._transfer_tick(t)

    # -- geo fault model (links + chaos; DESIGN.md §12) -----------------

    def _chaos_tick(self, t: int) -> None:
        """Apply this tick's chaos events: drops/delays are staged for
        ``_beat_tick`` (one-tick effects), partitions open a window
        during which the machine's beats and transfers cannot cross,
        interrupts sever every in-flight transfer (each retries)."""
        if self.chaos is None:
            return
        for e in self.chaos.events_at(t):
            if self.tracer.enabled:
                self.tracer.instant(f"chaos:{e.kind}", tick=t,
                                    machine=e.machine)
            if e.kind == "drop_beat":
                self._chaos_drop.add(e.machine)
            elif e.kind == "delay_beat":
                self._chaos_delay[e.machine] = max(
                    self._chaos_delay.get(e.machine, 0), e.delay)
            elif e.kind == "partition":
                self._partitioned[e.machine] = max(
                    self._partitioned.get(e.machine, 0), t + e.duration)
            elif e.kind == "interrupt" and self._in_flight:
                self._in_flight = [
                    f for f in self._in_flight if self._retry_transfer(f, t)]

    def _beat_tick(self, t: int) -> None:
        """One heartbeat round.  Without links/chaos every live machine
        beats instantly (the pre-geo engine, bit for bit).  With them,
        each beat rides the machine→leader link: partitioned or chaos-
        dropped beats are lost, delayed ones land ``d`` ticks later via
        ``_pending_beats``; a beat arriving from a *suspected* machine
        revives it (false-suspicion recovery)."""
        self.coord.tick()
        if not self._faults:
            for m in np.nonzero(self.alive)[0]:
                self.coord.beat(int(m))
            return
        leader = self._coordinator
        for m in map(int, np.nonzero(self.alive)[0]):
            if self._partitioned.get(m, 0) > t or m in self._chaos_drop:
                continue
            d = (self.links.delay_ticks(m, leader, t)
                 if self.links is not None else 0)
            d += self._chaos_delay.get(m, 0)
            if d <= 0:
                self._deliver_beat(m, t)
            else:
                self._pending_beats.setdefault(t + d, []).append(m)
        self._chaos_drop.clear()
        self._chaos_delay.clear()
        for m in self._pending_beats.pop(t, ()):
            # in-flight beats arrive even if the sender crashed after
            # sending — they delay detection, which is the point
            self._deliver_beat(m, t)

    def _deliver_beat(self, m: int, t: int) -> None:
        self.coord.beat(m)
        if m in self._suspected:
            self._revive(m, t)

    def _suspect_live(self, m: int, t: int) -> None:
        """The detector lost a machine that is actually alive (dropped
        or delayed beats, or a partition).  The cluster cannot know the
        difference and must act: the router evacuates its partitions
        exactly as for a real crash.  Unlike a crash, the machine keeps
        draining its queue — and if a beat gets through later it rejoins
        (``_revive``) and the suspicion is recorded as false."""
        self._suspected.add(m)
        self._fused_sync_collectors()
        if self.tracer.enabled:
            self.tracer.instant("failure_detected", tick=t, machine=m,
                                suspected=True)
        self._absorb_outcome(self.router.ingest(MachineFailure(m, t)))
        self._refresh_coordinator()

    def _revive(self, m: int, t: int) -> None:
        """A suspected machine's beat arrived: it was never dead.  It
        rejoins through the ordinary join path (the planner re-homes
        load back over rounds); the leader is sticky, so a revival
        never re-bills a coordinator failover (the false suspicion is
        counted instead).  The rejoin is *cold*: the failover already
        re-homed its state, so the machine restores from its last
        checkpoint and serves at ``revive_cold_factor`` capability
        until the warm tick — a false failover costs real capacity,
        not just migration bytes."""
        self._suspected.discard(m)
        self._acc[6] += 1
        if self.tracer.enabled:
            self.tracer.instant("false_suspicion", tick=t, machine=m)
        if self.cfg.revive_recovery_ticks > 0 \
                and self.cfg.revive_cold_factor < 1.0:
            warm = self._recover_cap.get(m, float(self.cap_factor[m]))
            self._recover_cap[m] = warm
            self._recover_at[m] = t + self.cfg.revive_recovery_ticks
            self.cap_factor[m] = warm * self.cfg.revive_cold_factor
        self._absorb_outcome(self.router.ingest(
            MachineJoin(m, t, float(self.cap_factor[m]))))
        self._refresh_coordinator()

    def _transfer_tick(self, t: int) -> None:
        """Settle in-flight transfer payloads due at ``t``: a dead or
        suspected receiver aborts the transfer (its bytes are never
        billed — the failure evacuation re-homed the state), a
        partitioned endpoint forces a retry with backoff, otherwise the
        payload lands — install work queues on the receiver and the
        bytes are billed exactly once."""
        if not self._in_flight:
            return
        keep = []
        for f in self._in_flight:
            if f.arrive > t:
                keep.append(f)
            elif not self.alive[f.m_l] or f.m_l in self._suspected:
                self._abort_transfer(f, t)
            elif (self._partitioned.get(f.m_l, 0) > t
                  or self._partitioned.get(f.m_h, 0) > t):
                if self._retry_transfer(f, t):
                    keep.append(f)
            else:
                self._complete_transfer(f, t)
        self._in_flight = keep

    def _retry_transfer(self, f: _InFlight, t: int) -> bool:
        """Re-send an interrupted transfer with exponential backoff
        against the same (surviving) receiver; gives up after
        ``max_transfer_retries`` attempts.  Returns False when the
        transfer was aborted instead of re-queued."""
        if f.attempts >= self.cfg.max_transfer_retries:
            self._abort_transfer(f, t)
            return False
        f.attempts += 1
        backoff = min(1 << (f.attempts - 1), 16)
        d = (self.links.delay_ticks(f.m_h, f.m_l, t + backoff)
             if self.links is not None else 1)
        f.arrive = t + backoff + max(d, 0)
        self._acc[4] += 1
        self.transfer_stats["retried"] += 1
        if self.tracer.enabled:
            self.tracer.instant("transfer_retry", tick=t, machine=f.m_l,
                                m_h=f.m_h, attempts=f.attempts,
                                arrive=f.arrive)
        note = getattr(self.router, "note_transfer_event", None)
        if note is not None and f.round_no >= 0:
            note(f.round_no, "retry")
        return True

    def _abort_transfer(self, f: _InFlight, t: int) -> None:
        """Drop a transfer whose receiver died (or whose retries ran
        out).  Nothing is billed and nothing is lost: the receiver's
        crash evacuation re-homed the logical partitions onto survivors
        (including the ones this payload carried), so the moved queries
        are installed by *that* outcome's transfers — billing this one
        too would double-count."""
        self._acc[5] += 1
        self.transfer_stats["aborted"] += 1
        self.transfer_stats["aborted_bytes"] += f.bytes
        if self.tracer.enabled:
            self.tracer.instant("transfer_abort", tick=t, machine=f.m_l,
                                m_h=f.m_h, attempts=f.attempts)
        note = getattr(self.router, "note_transfer_event", None)
        if note is not None and f.round_no >= 0:
            note(f.round_no, "abort")

    def _complete_transfer(self, f: _InFlight, t: int) -> None:
        self.queue_units[f.m_l] += (f.moved_queries
                                    * self.cfg.migration_unit_cost)
        self._acc[1] += f.bytes
        self._acc[2] += f.tuples
        self.transfer_stats["completed"] += 1
        self.transfer_stats["billed_bytes"] += f.bytes
        if self.tracer.enabled:
            self.tracer.instant("transfer_complete", tick=t,
                                machine=f.m_l, m_h=f.m_h,
                                bytes=f.bytes, attempts=f.attempts)

    def _settle_outcome(self, outcome, t: int | None = None) -> tuple:
        """Install/reshard a round or recovery outcome and return the
        traffic to bill on the current row: ``(wire, migration, tuples,
        pairs)``.  Without links everything settles instantly (the
        paper's atomic transfers — identical to the pre-geo engine).
        With links, control traffic bills now but each transfer's
        payload is enqueued on its link and bills at completion; the
        logical reshard still applies immediately (routing follows the
        new plan while state is in flight)."""
        if not isinstance(outcome, RoundOutcome):
            return (0, 0, 0, 0)
        detailed = (outcome.moved_by_transfer
                    and len(outcome.moved_by_transfer)
                    == len(outcome.transfers))
        if self.links is None or not outcome.transfers or not detailed:
            self._install_moved_queries(outcome)
            self._reshard_outcome(outcome)
            return (outcome.wire_bytes, outcome.migration_bytes,
                    outcome.moved_tuples, len(outcome.transfers))
        self._reshard_outcome(outcome)
        self._dispatch_transfers(
            outcome, self.tick_no if t is None else t)
        return (outcome.wire_bytes, 0, 0, len(outcome.transfers))

    def _dispatch_transfers(self, outcome: RoundOutcome, t: int) -> None:
        """Put an outcome's transfers in flight on their links.  The
        round's migration bytes/tuples are split across transfers
        proportionally to moved queries (cumulative rounding, so the
        shares sum exactly); each share bills on arrival.  A zero-delay
        link (intra-region at coarse ticks) completes its share
        immediately — bit-identical to the instantaneous network."""
        n_tr = len(outcome.transfers)
        moved = [int(n) for n in outcome.moved_by_transfer]
        tot_mv = sum(moved)
        rec = outcome.decision_record
        rno = int(rec.round_no) if rec is not None else -1
        mig = max(int(outcome.migration_bytes), 0)
        tup = max(int(outcome.moved_tuples), 0)
        acc_b = acc_t = 0
        cum = 0.0
        for i, trf in enumerate(outcome.transfers):
            cum += (moved[i] / tot_mv) if tot_mv else 1.0 / n_tr
            b_to, t_to = int(round(mig * cum)), int(round(tup * cum))
            d = self.links.delay_ticks(int(trf.m_h), int(trf.m_l), t)
            fl = _InFlight(m_h=int(trf.m_h), m_l=int(trf.m_l),
                           round_no=rno, moved_queries=moved[i],
                           bytes=b_to - acc_b, tuples=t_to - acc_t,
                           sent=t, arrive=t + max(d, 0))
            acc_b, acc_t = b_to, t_to
            self.transfer_stats["dispatched"] += 1
            self.transfer_stats["dispatched_bytes"] += fl.bytes
            if self.tracer.enabled:
                self.tracer.instant("transfer_dispatch", tick=t,
                                    machine=fl.m_l, m_h=fl.m_h,
                                    bytes=fl.bytes, arrive=fl.arrive)
            if fl.arrive <= t:
                self._complete_transfer(fl, t)
            else:
                self._in_flight.append(fl)

    def _absorb_outcome(self, out) -> None:
        """Fold a membership change's RoundOutcome (emergency re-homing)
        into the current tick's traffic accounting and bill the moved
        queries' install work on their receivers."""
        if not isinstance(out, RoundOutcome):
            return
        if self.tracer.enabled and out.decision_record is not None:
            self.tracer.record_decision(out.decision_record,
                                        tick=self.tick_no)
        self._acc[:4] += self._settle_outcome(out)

    def _take_acc(self) -> np.ndarray:
        acc, self._acc = self._acc, np.zeros(7, np.int64)
        return acc

    def _install_moved_queries(self, outcome: RoundOutcome) -> None:
        """Bill the install work of moved queries on the machines that
        *receive* them — one entry per transfer (the receiver ``m_L``).
        Outcomes without per-transfer detail fall back to the least
        loaded live machine (legacy single-target billing)."""
        if not outcome.moved_queries:
            return
        c = self.cfg.migration_unit_cost
        if (outcome.moved_by_transfer
                and len(outcome.moved_by_transfer) == len(outcome.transfers)):
            for tr, n in zip(outcome.transfers, outcome.moved_by_transfer):
                self.queue_units[tr.m_l] += n * c
        else:
            tgt = int(np.argmin(self.queue_units + (~self.alive) * 1e18))
            self.queue_units[tgt] += outcome.moved_queries * c

    def _enqueue(self, decision: RoutingDecision) -> None:
        np.add.at(self.queue_units, decision.owners,
                  decision.costs.astype(np.float64))
        np.add.at(self.queue_tuples, decision.owners, 1.0)

    # ------------------------------------------------------------------
    def fused_supported(self) -> bool:
        """Whether this router can run fused windows: any grid-index
        router exposing the ``fused_host_state`` seam.  Store-keeping
        workloads (snapshot probes / STORED persistence) fuse too —
        probe arrivals follow the sources' deterministic schedule
        (window boundaries), and the engine replays each window's
        deposits into the host-side store."""
        return hasattr(self.router, "fused_host_state")

    def run(self, ticks: int) -> Metrics:
        # fused_window is an execution knob, not a semantics change:
        # routers/workloads outside the fused envelope (replicated,
        # tuple stores) silently take the per-tick loop so mixed
        # sweeps complete; calling run_fused directly still raises
        with self._profiler_hook():
            if self.cfg.fused_window > 0 and self.fused_supported():
                return self.run_fused(ticks, self.cfg.fused_window)
            for _ in range(ticks):
                self.step()
            return self.metrics

    def _profiler_hook(self):
        """Optional ``torch.profiler`` capture around a run (device-level
        detail beneath our spans), written to
        ``TelemetryConfig.profiler_dir``; a no-op context otherwise."""
        tcfg = self.cfg.telemetry
        if tcfg is None or not tcfg.profiler_dir:
            return _NULL_SPAN
        return self._profiled(tcfg.profiler_dir)

    @contextlib.contextmanager
    def _profiled(self, out_dir: str):
        """The capture.  With the tracer on it holds a
        ``record_function`` anchor (:data:`PROFILER_ANCHOR`) at its start
        and at its end, each taken at a tracer reading that the tracer
        also records as an instant of that name (``at``: "start" /
        "end"): the two give the offset between the span export's clock
        and the device trace's."""
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(out_dir)):
            self._profiler_anchor("start")
            try:
                yield
            finally:
                self._profiler_anchor("end")

    def _profiler_anchor(self, at: str) -> None:
        tr = self.tracer
        if tr.enabled:
            import torch
            with torch.profiler.record_function(PROFILER_ANCHOR):
                t = tr.now()
            tr.instant(PROFILER_ANCHOR, tick=self.tick_no, t0=t, at=at)

    def step(self) -> None:
        with activate(self.tracer):
            self._step_body()

    def _step_body(self) -> None:
        cfg, mtr = self.cfg, self.metrics
        tr = self.tracer
        t = self.tick_no
        tick_span = tr.span("tick", tick=t) if tr.enabled else None
        t0 = tr.now()
        # 0. scheduled membership changes, heartbeats, failure detection
        self._membership_tick(t)
        # 1. query/probe arrivals — whatever events the workload's
        #    EventStream emits for this tick.
        n_snap = 0
        for event in self.stream.arrivals(t):
            decision = self.router.ingest(event)
            if decision is not None:
                self._enqueue(decision)
                if isinstance(event, ProbeBatch):
                    n_snap += len(decision)
        # 2. memory feasibility (Fig 11: Replicated dies at high |Q|;
        #    STORED persistence adds the resident-data wall).  The check
        #    is per tick: pressure that recedes — retention decay, a
        #    rebalance spreading resident state — lets injection resume;
        #    ``was_infeasible`` keeps the latched view for reporting.
        mem = self.router.memory_usage()
        d_max = float(mem.tuples.max(initial=0))
        infeasible = (mem.queries.max(initial=0) > cfg.mem_queries
                      or d_max > cfg.mem_tuples)
        if infeasible:
            mtr.was_infeasible = True
        # 3. inject tuples (backpressure-throttled)
        qt_pre = self.queue_tuples.sum() if self.san is not None else 0.0
        lam = 0.0 if infeasible else min(cfg.lambda_max, self.lam_bp)
        n = int(lam)
        dsum = 0.0
        if n > 0:
            decision = self.router.ingest(self.stream.tuples(n, t))
            self._enqueue(decision)
            if decision.deliveries is not None:
                dsum = float(decision.deliveries.sum())
        # 4–6. process, latency, backpressure — the shared tick dynamics
        # (fused.host_process_tick is the single home; the fused window
        # paths run the very same function / its float32 mirror).  The
        # capacity mask folds each machine's effective speed, so a
        # straggler processes proportionally less per tick.
        processed_units, w, latency, self.lam_bp = host_process_tick(
            self.queue_units, self.queue_tuples, self.lam_bp,
            cfg.cap_units, self._eff_alive(), cfg.bp_high, cfg.bp_dec,
            cfg.bp_inc, cfg.lambda_max)
        if self.san is not None:
            self.san.check_tick(self, qt_pre, n, float(w))
        # 7. load-balancing round — at the end of each full interval
        #    (never at tick 0, when no load has accumulated yet)
        round_traffic = (0, 0, 0, 0)
        if t > 0 and t % cfg.round_every == 0:
            outcome = self.router.on_round(t)
            if tr.enabled and outcome.decision_record is not None:
                tr.record_decision(outcome.decision_record, tick=t)
                if outcome.transfers:
                    tr.instant("rebalance", tick=t,
                               transfers=len(outcome.transfers),
                               moved_queries=outcome.moved_queries,
                               migration_bytes=outcome.migration_bytes)
            # installing moved queries costs work on their receivers;
            # under geo links the payloads go in flight instead and
            # bill on arrival (_settle_outcome)
            round_traffic = self._settle_outcome(outcome)
            if self.san is not None:
                self.san.check_round(self, outcome)
        # 8. persistence upkeep (ephemeral probe-window decay)
        self.router.end_tick()
        # 9. record.  The units-of-work factor is the query load served:
        # resident queries for continuous models plus this tick's
        # one-shot probes.  Membership traffic (emergency re-homing,
        # Coordinator failover) accumulated since the last record is
        # folded into this tick's row.
        acc = self._take_acc()
        q_total = self.router.q_total
        mtr.units_of_work.append(float(w) * (q_total + n_snap))
        mtr.throughput.append(float(w))
        mtr.latency.append(latency)
        mtr.q_total.append(q_total)
        mtr.utilization.append(processed_units / np.maximum(cfg.cap_units, 1e-9))
        # pub/sub fan-out ships one notification per expected delivery
        mtr.wire_bytes.append(
            round_traffic[0] + int(acc[0])
            + delivery_wire_bytes(dsum, self.router.workload.delivery_bytes))
        mtr.migration_bytes.append(round_traffic[1] + int(acc[1]))
        mtr.moved_tuples.append(round_traffic[2] + int(acc[2]))
        mtr.transfers.append(round_traffic[3] + int(acc[3]))
        mtr.retried_transfers.append(int(acc[4]))
        mtr.aborted_transfers.append(int(acc[5]))
        mtr.false_suspicions.append(int(acc[6]))
        mtr.snapshots.append(n_snap)
        mtr.deliveries.append(dsum)
        mtr.resident_tuples.append(d_max)
        mtr.injected.append(n)
        mtr.alive.append(self.alive.copy())
        mtr.cap_factor.append(self.cap_factor.copy())
        if tick_span is not None:
            self._tick_telemetry(t, t0, w, latency, n, q_total,
                                 mtr.units_of_work[-1], processed_units)
            tick_span.set(injected=n, throughput=float(w))
            tick_span.__exit__(None, None, None)
        self.tick_no += 1

    def _tick_telemetry(self, t: int, t0: int, w: float, latency: float,
                        injected: int, q_total: int, uow: float,
                        processed_units: np.ndarray) -> None:
        """Per-tick spans/counters (enabled tracer only): one synthetic
        span per live machine on its own track (the tick's wall bounds —
        machine work is simulated in one vectorized host step) plus the
        headline counter tracks."""
        tr = self.tracer
        if not tr.config.tick_spans:
            return
        t1 = tr.now()
        cap = max(self.cfg.cap_units, 1e-9)
        for m in np.nonzero(self.alive)[0]:
            m = int(m)
            tr.emit_span("tick", t0, t1, machine=m, tick=t,
                         queue_units=float(self.queue_units[m]),
                         utilization=float(processed_units[m] / cap))
            tr.counter("queue_units", float(self.queue_units[m]),
                       machine=m, tick=t, t0=t1)
        tr.counter("units_of_work", uow, tick=t, t0=t1)
        tr.counter("throughput", float(w), tick=t, t0=t1)
        tr.counter("latency", latency, tick=t, t0=t1)
        tr.counter("q_total", q_total, tick=t, t0=t1)
        tr.counter("lam_bp", self.lam_bp, tick=t, t0=t1)
        tr.counter("injected", injected, tick=t, t0=t1)

    # ------------------------------------------------------------------
    # Device-resident fast path (streaming.fused / planes.run_window)
    # ------------------------------------------------------------------
    def run_fused(self, ticks: int, window: int = 32) -> Metrics:
        """Run ``ticks`` engine ticks with steady-state ingest fused on
        the router's data plane.

        The timeline is cut into scan windows of up to ``window`` ticks;
        a window ends early at the next query/probe arrival tick, the
        next scheduled membership change or heartbeat-detection tick, or
        just after the next round boundary — those host-boundary ticks
        run through the per-tick :meth:`step` path (arrivals, membership
        and rounds mutate router state the device snapshot mirrors, and
        a rebalance/recovery becomes a ``scatter_update`` patch of the
        resident state, never a rebuild).  Each window stages ``⌊λmax⌋``
        candidate tuples per tick up front — inside the scan,
        backpressure still throttles injection dynamically by masking
        the batch prefix, so windowing changes *where* sampling happens,
        not the engine dynamics (with backpressure idle the RNG stream
        is identical to the per-tick loop, which is what the parity
        tests pin).  Workloads with a tuple store (snapshot probes /
        STORED persistence) run fused too: the fused step does not model
        deposits, so the engine replays each window's injected batches
        into the host-side store (counts only) and applies the per-tick
        retention decay — and under STORED persistence windows are
        additionally shortened so the resident-data memory wall can
        never engage inside one.
        """
        cfg, mtr = self.cfg, self.metrics
        router = self.router
        if not hasattr(router, "fused_host_state"):
            raise ValueError(
                f"{type(router).__name__} does not expose fused_host_state; "
                "the device-resident path supports grid-index routers — "
                "use run() instead")
        b = int(cfg.lambda_max)
        if b <= 0 or window < 1:
            for _ in range(ticks):
                self.step()
            return self.metrics
        with activate(self.tracer):
            return self._run_fused_windows(ticks, window)

    def _run_fused_windows(self, ticks: int, window: int) -> Metrics:
        cfg, mtr = self.cfg, self.metrics
        router = self.router
        tr = self.tracer
        b = int(cfg.lambda_max)
        plane = router.plane
        store = getattr(router, "store", None)
        t_end = self.tick_no + ticks
        while self.tick_no < t_end:
            t = self.tick_no
            nb = self._next_boundary(t)
            if (nb is not None and nb <= t) or self._mem_infeasible():
                # host-boundary tick: arrivals, membership changes and
                # stalled (memory-infeasible) ticks go through the
                # reference path; drain collectors first in case the
                # tick closes a round or re-homes partitions
                self._fused_sync_collectors()
                self.step()
                continue
            r = max(t, 1)
            if r % cfg.round_every:
                r = (r // cfg.round_every + 1) * cfg.round_every
            stop = min(t_end, t + window, r + 1)
            if nb is not None:
                stop = min(stop, nb)
            if store is not None and router.workload.stored:
                # shorten the window so the per-machine resident-data
                # wall cannot engage mid-window (conservative: all of a
                # tick's deposits could land on the fullest machine)
                d_now = float(self.router.memory_usage()
                              .tuples.max(initial=0))
                room = int((cfg.mem_tuples - d_now) // max(b, 1))
                if room < 1:
                    self._fused_sync_collectors()
                    self.step()
                    continue
                stop = min(stop, t + room)
            w = stop - t
            win_span = (tr.span("fused_window", tick=t, ticks=w)
                        if tr.enabled else None)
            w0 = tr.now()
            # stage W ticks of candidate batches (tick-ordered, so the
            # source RNG stream matches the per-tick loop); keyword
            # workloads stage the hashed probe buckets alongside
            with (tr.span("window_stage") if tr.enabled else _NULL_SPAN):
                batches = [self.stream.tuples(b, tt)
                           for tt in range(t, stop)]
                xy = np.stack([bt.xy for bt in batches])
                kw_stack = (np.stack([bt.buckets for bt in batches])
                            if batches[0].buckets is not None else None)
            with (tr.span("state_refresh") if tr.enabled else _NULL_SPAN):
                self._fused_refresh(plane)
            # ingest-tier cell ids: forwarded only to planes that want
            # them, and only when every staged batch carries ids for
            # exactly this router's grid (a hint, verified here)
            cells = None
            if getattr(plane, "wants_cells", False):
                g_plane = int(self._fused["host"].grid.shape[0])
                if all(bt.cells is not None and bt.cells_grid == g_plane
                       for bt in batches):
                    cells = [bt.cells for bt in batches]
            fp = FusedParams(
                cap_units=float(cfg.cap_units),
                lambda_max=float(cfg.lambda_max), bp_high=float(cfg.bp_high),
                bp_dec=float(cfg.bp_dec), bp_inc=float(cfg.bp_inc),
                alive=self._eff_alive(),
                track_stats=self._fused["host"].track_stats,
                n_alloc=self._fused["host"].n_alloc)
            carry = EngineCarry(self.queue_units, self.queue_tuples,
                                self.lam_bp)
            cp = router._cost_params()
            # the plane runs the window exactly, throttled or not
            state, carry_out, outs, ok = plane.run_window(
                self._fused["state"], cp, fp, carry, xy,
                kw_stack=kw_stack, cells=cells)
            self.declined_windows += not ok
            self._fused["state"] = state
            self.queue_units = np.asarray(carry_out.queue_units, np.float64)
            self.queue_tuples = np.asarray(carry_out.queue_tuples,
                                           np.float64)
            self.lam_bp = float(carry_out.lam_bp)
            # store-keeping workloads: the fused step priced the batches
            # but did not deposit them — replay counts into the host-side
            # store (+ per-tick retention decay)
            resid = self._replay_store(xy, outs.injected)
            # heartbeats advance through the window (membership is
            # constant inside one: boundaries are cut at every
            # scheduled event and detection tick)
            self._advance_heartbeats(w)
            if win_span is not None:
                # skipped: the carry throttled tick 0, so the plane
                # dispatched no full-batch body
                win_span.set(ok=bool(ok), declined=self.declined_windows,
                             skipped=bool(not ok and outs.injected[0] < b),
                             throughput=float(outs.throughput.sum()))
                win_span.__exit__(None, None, None)
                self._fused_tick_telemetry(t, w, w0, tr.now(), outs)
            acc = self._take_acc()
            q_total = router.q_total
            dbytes = router.workload.delivery_bytes
            for i in range(w):
                d_i = (float(outs.deliveries[i])
                       if outs.deliveries is not None else 0.0)
                mtr.units_of_work.append(float(outs.throughput[i]) * q_total)
                mtr.throughput.append(float(outs.throughput[i]))
                mtr.latency.append(float(outs.latency[i]))
                mtr.q_total.append(q_total)
                mtr.utilization.append(np.asarray(outs.utilization[i],
                                                  np.float64))
                mtr.wire_bytes.append((int(acc[0]) if i == 0 else 0)
                                      + delivery_wire_bytes(d_i, dbytes))
                mtr.migration_bytes.append(int(acc[1]) if i == 0 else 0)
                mtr.moved_tuples.append(int(acc[2]) if i == 0 else 0)
                mtr.transfers.append(int(acc[3]) if i == 0 else 0)
                mtr.retried_transfers.append(int(acc[4]) if i == 0 else 0)
                mtr.aborted_transfers.append(int(acc[5]) if i == 0 else 0)
                mtr.false_suspicions.append(int(acc[6]) if i == 0 else 0)
                mtr.snapshots.append(0)
                mtr.deliveries.append(d_i)
                mtr.resident_tuples.append(float(resid[i]))
                mtr.injected.append(int(outs.injected[i]))
                mtr.alive.append(self.alive.copy())
                mtr.cap_factor.append(self.cap_factor.copy())
            self.tick_no = stop
            last = stop - 1
            if last > 0 and last % cfg.round_every == 0:
                # round boundary: drain device collectors into the host
                # stats bank, run the planner round, patch the last
                # tick's round metrics in place (step() records them on
                # the same tick row)
                self._fused_sync_collectors()
                outcome = router.on_round(last)
                if tr.enabled and outcome.decision_record is not None:
                    tr.record_decision(outcome.decision_record, tick=last)
                    if outcome.transfers:
                        tr.instant("rebalance", tick=last,
                                   transfers=len(outcome.transfers),
                                   moved_queries=outcome.moved_queries,
                                   migration_bytes=outcome.migration_bytes)
                rw, rm, rt, rp = self._settle_outcome(outcome, t=last)
                if self.san is not None:
                    self.san.check_round(self, outcome)
                # zero-delay transfer shares completed inside the settle
                # bill through the accumulator — they belong to this
                # round's tick row, exactly as the per-tick loop records
                extra = self._take_acc()
                mtr.wire_bytes[-1] += rw + int(extra[0])
                mtr.migration_bytes[-1] += rm + int(extra[1])
                mtr.moved_tuples[-1] += rt + int(extra[2])
                mtr.transfers[-1] += rp + int(extra[3])
                mtr.retried_transfers[-1] += int(extra[4])
                mtr.aborted_transfers[-1] += int(extra[5])
                mtr.false_suspicions[-1] += int(extra[6])
        # leave no deltas stranded on device: a later per-tick run()
        # or direct protocol use must see complete host statistics
        self._fused_sync_collectors()
        return mtr

    def _fused_tick_telemetry(self, t: int, w: int, w0: int, w1: int,
                              outs: FusedOutputs) -> None:
        """Per-tick spans/counters for a fused window (enabled tracer
        only).  Within-window per-tick wall times do not exist — the
        whole window ran as one device dispatch — so tick timestamps
        are linearly interpolated across the window's wall bounds
        (wall-only synthesis: structural fields stay deterministic)."""
        tr = self.tracer
        if not tr.config.tick_spans:
            return
        dt = max(w1 - w0, 0) // max(w, 1)
        live = [int(m) for m in np.nonzero(self.alive)[0]]
        for i in range(w):
            s0, s1 = w0 + i * dt, w0 + (i + 1) * dt
            util = np.asarray(outs.utilization[i], np.float64)
            for m in live:
                tr.emit_span("tick", s0, s1, machine=m, tick=t + i,
                             utilization=float(util[m]))
            tr.counter("throughput", float(outs.throughput[i]),
                       tick=t + i, t0=s1)
            tr.counter("latency", float(outs.latency[i]),
                       tick=t + i, t0=s1)
            tr.counter("units_of_work",
                       float(outs.throughput[i]) * self.router.q_total,
                       tick=t + i, t0=s1)
            tr.counter("injected", int(outs.injected[i]),
                       tick=t + i, t0=s1)

    def _replay_store(self, xy_stack, injected) -> np.ndarray:
        """Post-window store replay for store-keeping workloads: route
        each tick's injected prefix on the host grid snapshot, deposit
        the per-partition counts, apply the tick's retention decay.
        Bit-equal to what the per-tick loop's ``_route_tuples`` deposits
        (integer counts; same grid, static within the window).  Returns
        the per-tick resident-tuple metric (pre-deposit, like step 2 of
        the per-tick loop records it)."""
        w = len(xy_stack)
        resid = np.zeros(w)
        store = getattr(self.router, "store", None)
        if store is None:
            return resid
        host = self._fused["host"]
        grid = host.grid
        g = grid.shape[0]
        parts = self.router.index.parts
        stored = self.router.workload.stored
        for i in range(w):
            if stored:
                resid[i] = float(store.by_machine(parts,
                                                  len(self.alive)).max())
            n = int(injected[i])
            if n > 0:
                row, col = geometry.points_to_cells(
                    np.asarray(xy_stack[i, :n], np.float32), g)
                store.deposit(grid[row, col], parts.capacity)
            store.expire()
        return resid

    def _next_boundary(self, t: int) -> int | None:
        """First tick ≥ ``t`` that must run on the host: a query/probe
        arrival, a scheduled membership change, or the heartbeat
        detection of a pending failure.  Under the geo fault model,
        also: the next chaos event, the next in-flight transfer
        arrival, and the next tick the failure detector would change
        its view (``_next_fault_tick``, a cloned-state look-ahead).
        All schedules are deterministic, so fused windows cut exactly
        there."""
        cands = [self.stream.next_arrival(t), self.stream.next_membership(t)]
        if not self._faults:
            cands += list(self._pending_detect.values())
        else:
            if self.chaos is not None:
                cands.append(self.chaos.next_event(t))
            if self._in_flight:
                cands.append(min(f.arrive for f in self._in_flight))
            if self._recover_at:
                # a postponed restore (machine re-suspected mid-ramp)
                # can sit in the past — never cut behind ``t``
                cands.append(max(min(self._recover_at.values()), t))
            cands.append(self._next_fault_tick(t))
        cands = [c for c in cands if c is not None]
        return min(cands) if cands else None

    def _next_fault_tick(self, t: int) -> int | None:
        """Look-ahead for the fused path under links/chaos: the first
        tick in ``[t, t + window]`` at which the failure detector would
        change the cluster's view — a watched machine (live, or silenced
        and pending detection) leaving the detector's live set, or a
        suspected machine's beat arriving (revival).  Runs on a *clone*
        of the detector state; link delays are hash-sampled by
        ``(src, dst, tick)``, so the probe consumes no RNG and predicts
        the per-tick path exactly.  Chaos effects are not simulated —
        the window is already cut at the next chaos event, before the
        simulation could diverge."""
        horizon = t + max(self.cfg.fused_window, 1) + 1
        g = self.coord.clone()
        pending = {tt: list(ms) for tt, ms in self._pending_beats.items()}
        senders = [int(m) for m in np.nonzero(self.alive)[0]]
        watch = set(senders) | set(self._pending_detect)
        leader = self._coordinator
        for u in range(t, horizon):
            g.tick()
            for m in senders:
                if self._partitioned.get(m, 0) > u:
                    continue
                d = (self.links.delay_ticks(m, leader, u)
                     if self.links is not None else 0)
                if d <= 0:
                    if m in self._suspected:
                        return u           # revival fires at u
                    g.beat(m)
                else:
                    pending.setdefault(u + d, []).append(m)
            for m in pending.pop(u, ()):
                if m in self._suspected:
                    return u               # delayed revival fires at u
                g.beat(m)
            live = set(g.live_members())
            for m in watch:
                if m not in live and m not in self._suspected:
                    if g.last_beat.get(m, 0) == 0 \
                            and u < self._boot_grace:
                        continue           # boot grace (same as the scan)
                    return u               # new suspicion / detection
        return None

    def _advance_heartbeats(self, ticks: int) -> None:
        """Fast-forward the heartbeat table across a fused window.
        Without links membership is constant inside one, so beating
        once at the final clock equals beating every tick.  With links
        each window tick runs the real beat-delivery logic (sends,
        link-delayed arrivals) — ``_next_fault_tick`` guarantees no
        suspicion, detection or revival can fire inside the window."""
        if not self._faults:
            for _ in range(ticks):
                self.coord.tick()
            for m in np.nonzero(self.alive)[0]:
                self.coord.beat(int(m))
            return
        t0 = self.tick_no
        for i in range(ticks):
            self._beat_tick(t0 + i)

    def _mem_infeasible(self) -> bool:
        mem = self.router.memory_usage()
        return (mem.queries.max(initial=0) > self.cfg.mem_queries
                or float(mem.tuples.max(initial=0)) > self.cfg.mem_tuples)

    def _fused_refresh(self, plane) -> None:
        """Build or diff-patch the resident device state.  Successive
        router snapshots are diffed so a rebalance becomes a scatter
        update of the changed grid cells / owner rows; only a capacity
        growth forces a rebuild."""
        host = self.router.fused_host_state()
        f = self._fused
        if f is None or f["plane"] is not plane:
            self._fused = {"plane": plane, "host": host,
                           "state": plane.make_state(host)}
            return
        updates = f["host"].diff(host)
        if updates is None:                      # capacity grew: rebuild
            self._fused_sync_collectors()        # (banks change shape)
            f["state"] = plane.make_state(host)
        elif updates:
            f["state"] = plane.scatter_update(f["state"], updates)
        f["host"] = host

    def _fused_sync_collectors(self) -> None:
        """Drain device-accumulated N′ collector deltas into the host
        stats bank (no-op for routers that keep no statistics).  With
        the tracer on, a drain that finds deltas is span
        ``collectors_drain`` (the banks' read, fold and reset) with the
        banks' ``bytes``."""
        f = self._fused
        if not f or not f["host"].track_stats:
            return
        tr = self.tracer
        d0 = tr.now()
        cnr, cnc = f["plane"].collector_banks(f["state"])
        if cnr.any() or cnc.any():
            self.router.fused_absorb(cnr, cnc)
            f["state"] = f["plane"].reset_collectors(f["state"])
            if tr.enabled:
                tr.emit_span("collectors_drain", d0, tr.now(),
                             bytes=cnr.nbytes + cnc.nbytes)

    def _reshard_outcome(self, outcome) -> None:
        """Physically re-home a round/recovery outcome's transferred
        state across device shards (sharded plane; single-device planes
        report 0 — the plan patch is the whole move).  The bytes moved
        must equal the billed migration bytes (tests pin this)."""
        f = self._fused
        if not f or not isinstance(outcome, RoundOutcome) \
                or not outcome.transfers:
            return
        f["plane"].reshard_transfers(f["state"], outcome, self.router)


# ---------------------------------------------------------------------------
# Legacy convenience: run one (router, source) pair end to end.  New code
# should use ``repro.streaming.experiments`` (Experiment / run_suite),
# which also threads seeds end-to-end.
# ---------------------------------------------------------------------------

def run_experiment(router: Router, source: ScenarioSource, *, ticks: int,
                   preload_queries: int,
                   config: EngineConfig | None = None) -> Metrics:
    eng = StreamingEngine(router, source, config)
    preload = eng.stream.preload(preload_queries)
    if preload is not None:
        router.ingest(preload)
    return eng.run(ticks)
