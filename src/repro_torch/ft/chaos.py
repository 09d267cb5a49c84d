"""Seeded chaos injection: deterministic fault schedules for the engine.

PR 5's membership timelines made kills/joins/stragglers a sweepable
scenario dimension; chaos events extend the same idea to *messy*
failures — dropped and delayed heartbeats, transient network
partitions, and interrupted mid-flight transfers.  A frozen
:class:`ChaosSpec` describes fault *rates*; :meth:`ChaosSpec.compile`
expands it once into a concrete :class:`ChaosSchedule` of typed
:class:`ChaosEvent` entries using an RNG derived solely from
``ChaosSpec.seed`` — same seed, same fault schedule, bit for bit, and
fully independent of the scenario source's RNG stream (goldens without
chaos are untouched).

The schedule is known ahead of time, so the fused engine path cuts its
scan windows at chaos ticks exactly the way it already cuts at
membership events — chaos never forces the per-tick loop globally,
only at the ticks where a fault actually fires.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KINDS = ("drop_beat", "delay_beat", "partition", "interrupt")


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault.

    ``drop_beat``      — ``machine``'s heartbeat at ``tick`` is lost.
    ``delay_beat``     — the beat is held back ``delay`` extra ticks.
    ``partition``      — ``machine`` is unreachable for ``duration``
                         ticks: no beats get through and transfers
                         touching it cannot complete.
    ``interrupt``      — every transfer in flight at ``tick`` is
                         severed and must retry."""

    tick: int
    kind: str
    machine: int = -1
    duration: int = 0
    delay: int = 0


@dataclass(frozen=True)
class ChaosSpec:
    """Fault-rate description, compiled to a schedule per experiment.

    Rates are per-machine per-tick probabilities (``drop_beats``,
    ``delay_beats``) or absolute counts over the fault window
    (``partitions``, ``interrupts``).  ``ticks`` bounds the fault
    window — the horizon the schedule is expanded over — so compiling
    needs only the machine count and the expansion is independent of
    how long the engine actually runs.  Frozen + comparable so it
    folds into ``ScenarioSpec.key`` — two suite cells differing only
    in chaos cannot collide."""

    seed: int = 0
    ticks: int = 64          # fault window: events land in [start, ticks)
    drop_beats: float = 0.0
    delay_beats: float = 0.0
    max_delay: int = 2
    partitions: int = 0
    partition_len: int = 3
    interrupts: int = 0
    start: int = 1           # first tick eligible for faults
    # optional machine pool partitions are drawn from — partitions are
    # a property of *links*, so a geo scenario scopes them to the
    # machines behind the WAN (empty tuple: any machine)
    partition_machines: tuple[int, ...] = ()
    # correlated partitions: each partition event is a WAN *flap* that
    # cuts the whole pool at once (one event per pool machine, same
    # tick) instead of isolating a single machine — the failure mode
    # that makes geo-blind detectors evacuate an entire region
    partition_correlated: bool = False
    # minimum spacing between partition start ticks (rejection-sampled
    # from the same RNG stream; 0 = flaps may overlap and compound)
    partition_min_gap: int = 0

    def __str__(self):
        parts = [f"s{self.seed}@{self.ticks}t"]
        if self.drop_beats:
            parts.append(f"drop{self.drop_beats:g}")
        if self.delay_beats:
            parts.append(f"dly{self.delay_beats:g}x{self.max_delay}")
        if self.partitions:
            scope = ("@" + ",".join(map(str, self.partition_machines))
                     if self.partition_machines else "")
            corr = "corr" if self.partition_correlated else ""
            parts.append(f"part{corr}{self.partitions}x{self.partition_len}"
                         f"{scope}")
        if self.interrupts:
            parts.append(f"int{self.interrupts}")
        return "chaos[" + ",".join(parts) + "]"

    def compile(self, num_machines: int) -> "ChaosSchedule":
        """Expand the rates into a concrete, seeded event schedule."""
        rng = np.random.default_rng(self.seed)
        events: list[ChaosEvent] = []
        lo, hi = self.start, max(self.ticks, self.start + 1)
        if self.drop_beats > 0 or self.delay_beats > 0:
            u = rng.random((hi - lo, num_machines))
            v = rng.random((hi - lo, num_machines))
            for i, m in zip(*np.nonzero(u < self.drop_beats)):
                events.append(ChaosEvent(lo + int(i), "drop_beat", int(m)))
            for i, m in zip(*np.nonzero(
                    (u >= self.drop_beats)
                    & (v < self.delay_beats))):
                d = 1 + int(rng.integers(max(self.max_delay, 1)))
                events.append(ChaosEvent(lo + int(i), "delay_beat", int(m),
                                         delay=d))
        pool = [m for m in self.partition_machines if m < num_machines] \
            or list(range(num_machines))
        part_ticks: list[int] = []
        for _ in range(self.partitions):
            t = int(rng.integers(lo, hi))
            for _try in range(64):
                if all(abs(t - u) >= self.partition_min_gap
                       for u in part_ticks):
                    break
                t = int(rng.integers(lo, hi))
            part_ticks.append(t)
            # draw the victim even when correlated — the RNG stream
            # stays identical between the two partition shapes
            m = int(pool[rng.integers(len(pool))])
            dur = max(self.partition_len, 1)
            if self.partition_correlated:
                for pm in pool:
                    events.append(ChaosEvent(t, "partition", int(pm),
                                             duration=dur))
            else:
                events.append(ChaosEvent(t, "partition", m, duration=dur))
        for _ in range(self.interrupts):
            t = int(rng.integers(lo, hi))
            events.append(ChaosEvent(t, "interrupt"))
        events.sort(key=lambda e: (e.tick, KINDS.index(e.kind), e.machine))
        return ChaosSchedule(tuple(events))


@dataclass(frozen=True)
class ChaosSchedule:
    """A compiled, tick-sorted fault schedule (the runtime object the
    engine and the fused window-boundary logic consult)."""

    events: tuple[ChaosEvent, ...] = ()

    def events_at(self, tick: int) -> list[ChaosEvent]:
        return [e for e in self.events if e.tick == tick]

    def next_event(self, tick: int) -> int | None:
        """First scheduled fault tick ≥ ``tick`` (fused windows cut
        here), ``None`` when the rest of the timeline is clean."""
        ts = [e.tick for e in self.events if e.tick >= tick]
        return min(ts) if ts else None

    def __len__(self):
        return len(self.events)
