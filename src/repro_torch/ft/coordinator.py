"""Coordinator failover (paper §4.1.1: "If the Coordinator fails, another
GlobalIndex machine takes over").

The paper elects via Byzantine agreement; on a single-tenant pod with
crash-stop failures we use deterministic rank-order election (documented
deviation, DESIGN.md §3): every member observes the same heartbeat table,
so the lowest-ranked live member is a consistent choice without a vote.
Leadership is *sticky*: once elected, a leader keeps the role until it
is itself declared dead — a lower-ranked member that was falsely
suspected and then revived rejoins as a follower instead of forcing a
second (spurious) failover resync.

Failure detection comes in two flavours.  The fixed detector declares a
member dead after ``heartbeat_timeout`` silent beats — exact and cheap
on a pod where beats either arrive or the sender crashed.  Geo links
break that: beats are delayed and jittered, so a fixed timeout either
false-suspects live machines or is uselessly slack.  ``adaptive=True``
enables a phi-accrual-style detector (Hayashibara et al.): each member
tracks the recent inter-arrival gaps of its peers' beats and declares
suspicion only when the current silence exceeds ``mean + k_sigma·std``
of the observed history.  Under clean once-per-tick beats the history
collapses to gap 1 / std 0 and the adaptive threshold reduces exactly
to the fixed ``heartbeat_timeout`` — the two detectors are bit-identical
on jitter-free links, which is what keeps the existing goldens pinned.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from math import ceil, sqrt

from ..telemetry.tracer import current as _tracer


@dataclass
class CoordinatorGroup:
    num_members: int
    heartbeat_timeout: int = 3          # missed beats before declared dead
    adaptive: bool = False              # phi-accrual-style jitter slack
    k_sigma: float = 3.0                # jitter slack: k·std beyond mean
    window: int = 16                    # inter-arrival history per member
    last_beat: dict = field(default_factory=dict)
    clock: int = 0
    leader: int = -1                    # sticky leadership (-1 = unelected)

    def __post_init__(self):
        for m in range(self.num_members):
            self.last_beat.setdefault(m, 0)
        self._gaps: dict[int, deque] = {}

    # -- detection threshold ------------------------------------------
    def threshold(self, member: int) -> int:
        """Silent beats before ``member`` is suspected.  Fixed detector:
        ``heartbeat_timeout``.  Adaptive: the fixed detector's budget of
        ``heartbeat_timeout − 1`` extra silent ticks, granted on top of
        the *statistically expected worst gap* (observed inter-arrival
        mean + ``k_sigma``·std) instead of on top of the ideal gap of 1.
        On a clean once-per-tick link (mean 1, std 0) this reduces
        exactly to ``heartbeat_timeout``; on a jittery WAN link the
        whole missed-beat budget survives the jitter instead of being
        eaten by it (a bare ``mean + k·std`` bound leaves less than one
        dropped beat of slack, and a short partition trips it)."""
        if not self.adaptive:
            return self.heartbeat_timeout
        g = self._gaps.get(member)
        if not g:
            return self.heartbeat_timeout
        n = len(g)
        mu = sum(g) / n
        var = sum((x - mu) ** 2 for x in g) / n
        return max(self.heartbeat_timeout,
                   int(ceil(mu + self.k_sigma * sqrt(var)))
                   + self.heartbeat_timeout - 1)

    def beat(self, member: int) -> None:
        gap = self.clock - self.last_beat[member]
        if self.adaptive and 0 < gap:
            if gap < self.threshold(member):
                self._gaps.setdefault(
                    member, deque(maxlen=self.window)).append(gap)
            else:
                # a beat from a suspected member: it was never dead —
                # start its arrival history fresh (the silence is a
                # suspicion artifact, not an inter-arrival sample)
                self._gaps.pop(member, None)
        self.last_beat[member] = self.clock

    def suspend(self, member: int) -> None:
        """Declare ``member`` non-live immediately (standby slots that
        have not joined yet, or an out-of-band failure notification
        that should not wait out the heartbeat timeout)."""
        self.last_beat[member] = self.clock - self.threshold(member)
        self._gaps.pop(member, None)

    def tick(self) -> None:
        self.clock += 1
        tr = _tracer()
        if tr.enabled:
            # the engine beats its live members *after* ticking, so a
            # healthy machine sits at delta == 1 here; anything quieter
            # is missing beats, and delta reaching the threshold is the
            # suspicion edge (fires exactly once per silence)
            for m, last in self.last_beat.items():
                delta = self.clock - last
                to = self.threshold(m)
                if 2 <= delta < to:
                    tr.instant("heartbeat_miss", machine=m,
                               missed=delta - 1)
                elif delta == to:
                    tr.instant("suspect", machine=m, silent_for=delta)

    def live_members(self) -> list[int]:
        return [m for m in range(self.num_members)
                if self.clock - self.last_beat[m] < self.threshold(m)]

    def coordinator(self) -> int:
        """The sticky leader; on its death, the lowest-ranked live
        member takes over.  Raises if the whole group is dead."""
        live = self.live_members()
        if not live:
            raise RuntimeError("no live GlobalIndex machines")
        if self.leader not in live:
            self.leader = live[0]
        return self.leader

    def clone(self) -> "CoordinatorGroup":
        """Deep-enough copy for look-ahead simulation (the fused engine
        path probes future suspicion edges without mutating the live
        heartbeat table)."""
        g = CoordinatorGroup(self.num_members, self.heartbeat_timeout,
                             adaptive=self.adaptive, k_sigma=self.k_sigma,
                             window=self.window,
                             last_beat=dict(self.last_beat),
                             clock=self.clock, leader=self.leader)
        g._gaps = {m: deque(d, maxlen=self.window)
                   for m, d in self._gaps.items()}
        return g
