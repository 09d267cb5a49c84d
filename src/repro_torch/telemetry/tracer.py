"""Tracer: nested spans, counters and instants over the streaming
stack, with a zero-overhead disabled path.

Span taxonomy (DESIGN.md §9): the control-plane timeline carries
``tick``, ``fused_window`` (with ``fused_window_compile`` /
``fused_window_dispatch`` children from the JAX plane), ``round_close``
→ ``plan_round`` / ``apply_plan``, ``failover`` and ``heartbeat_scan``
spans plus instants for FSM transitions, rebalances, membership events
and heartbeat misses; each machine owns a track of per-tick spans and
queue/utilization counters.

The zero-overhead contract: when telemetry is off the engine holds the
:data:`NOOP` singleton, every instrumentation site is guarded by a
single ``if tr.enabled`` attribute test (~30 ns), and the fused window
performs **no** ``block_until_ready`` host sync it wouldn't otherwise
do.  The enabled path buffers plain tuples in Python lists — no I/O
until :meth:`Tracer.export`.

Spans carry ``(tick, seq, parent)`` ordering metadata alongside wall
times, so :meth:`Tracer.signature` can render the structural span tree
with wall-clock stripped — the object the determinism tests compare
across runs and data planes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

# Track id for control-plane events; machine tracks use the machine id.
CONTROL = -1


@dataclass(frozen=True)
class TelemetryConfig:
    """Engine-facing switch (``EngineConfig.telemetry``).  ``None``
    (the default) keeps the no-op singleton; an instance turns the
    tracer on.  ``trace_dir`` makes ``experiments.run`` export JSONL +
    Perfetto files after the run; ``jax_profiler_dir`` additionally
    wraps the run in a ``jax.profiler.trace`` capture (device-level
    detail beyond our spans)."""

    enabled: bool = True
    trace_dir: str | None = None
    tick_spans: bool = True      # per-machine per-tick spans + counters
    jax_profiler_dir: str | None = None

    def __str__(self):  # keeps Experiment labels compact & stable
        parts = [] if self.enabled else ["off"]
        if self.trace_dir:
            parts.append("trace")
        if not self.tick_spans:
            parts.append("nospans")
        if self.jax_profiler_dir:
            parts.append("jaxprof")
        return "telemetry(" + ",".join(parts or ["on"]) + ")"


@dataclass
class TraceEvent:
    """One buffered event.  ``kind``: "span" | "instant" | "counter".
    ``track`` is :data:`CONTROL` or a machine id; ``t0``/``dur`` are
    perf_counter_ns relative to the tracer epoch (counter events store
    the value in ``dur``)."""

    kind: str
    name: str
    track: int
    tick: int
    seq: int
    parent: int          # seq of enclosing span, -1 at top level
    t0: int
    dur: int
    args: dict = field(default_factory=dict)


class _Span:
    """Handle returned by :meth:`Tracer.span` — a context manager that
    closes the span and lets instrumentation attach results via
    :meth:`set` before exit."""

    __slots__ = ("_tr", "_ev")

    def __init__(self, tr, ev):
        self._tr = tr
        self._ev = ev

    def set(self, **kw):
        self._ev.args.update(kw)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tr._close(self._ev)
        return False


class _NullSpan:
    """Shared do-nothing span for the disabled tracer."""

    __slots__ = ()

    def set(self, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Buffering tracer.  All mutating methods are cheap appends; use
    :meth:`export` (or ``telemetry.export.write_trace``) to persist."""

    enabled = True

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self.events: list[TraceEvent] = []
        self.decisions: list = []        # (tick, DecisionRecord)
        self._epoch = time.perf_counter_ns()
        self._seq = 0
        self._stack: list[TraceEvent] = []
        self._counters: dict[tuple, float] = {}

    # -- time ---------------------------------------------------------
    def now(self) -> int:
        """ns since tracer epoch (monotonic)."""
        return time.perf_counter_ns() - self._epoch

    # -- spans --------------------------------------------------------
    def span(self, name: str, *, machine: int = CONTROL, tick: int = -1,
             **args) -> _Span:
        """Open a nested span; close it by exiting the context (or use
        :meth:`emit_span` for already-measured intervals)."""
        parent = self._stack[-1].seq if self._stack else -1
        ev = TraceEvent("span", name, machine, tick, self._seq, parent,
                        self.now(), -1, dict(args) if args else {})
        self._seq += 1
        self._stack.append(ev)
        return _Span(self, ev)

    def _close(self, ev: TraceEvent):
        ev.dur = self.now() - ev.t0
        # tolerate out-of-order exits (exceptions unwinding)
        if self._stack and self._stack[-1] is ev:
            self._stack.pop()
        elif ev in self._stack:
            self._stack.remove(ev)
        self.events.append(ev)

    def emit_span(self, name: str, t0: int, t1: int, *,
                  machine: int = CONTROL, tick: int = -1, **args):
        """Record a span from explicit ``now()`` bounds — used for the
        synthetic per-machine tick spans where the work for all
        machines happens in one vectorized host step."""
        parent = self._stack[-1].seq if self._stack else -1
        self.events.append(TraceEvent(
            "span", name, machine, tick, self._seq, parent, t0,
            max(t1 - t0, 0), dict(args) if args else {}))
        self._seq += 1

    # -- instants & counters -----------------------------------------
    def instant(self, name: str, *, machine: int = CONTROL, tick: int = -1,
                t0: int | None = None, **args):
        self.events.append(TraceEvent(
            "instant", name, machine, tick, self._seq, -1,
            self.now() if t0 is None else t0, 0,
            dict(args) if args else {}))
        self._seq += 1

    def counter(self, name: str, value, *, machine: int = CONTROL,
                tick: int = -1, t0: int | None = None):
        v = float(value)
        self._counters[(name, machine)] = v
        self.events.append(TraceEvent(
            "counter", name, machine, tick, self._seq, -1,
            self.now() if t0 is None else t0, 0, {"value": v}))
        self._seq += 1

    def gauge(self, name: str, machine: int = CONTROL) -> float | None:
        """Last value a counter was set to (None if never set)."""
        return self._counters.get((name, machine))

    def counter_series(self, name: str, machine: int = CONTROL):
        """(ticks, values) of one counter — the example's UoW timeline
        reads this instead of scraping Metrics."""
        ticks, vals = [], []
        for ev in self.events:
            if ev.kind == "counter" and ev.name == name \
                    and ev.track == machine:
                ticks.append(ev.tick)
                vals.append(ev.args["value"])
        return ticks, vals

    # -- flight recorder ---------------------------------------------
    def record_decision(self, rec, tick: int = -1):
        self.decisions.append((tick, rec))

    # -- structural views --------------------------------------------
    def signature(self) -> list:
        """Wall-clock-free view of the event stream: ``(kind, name,
        track, tick, parent-name)`` per event, in order, with counter
        values included (they are deterministic metrics, not wall
        time).  Two same-seed runs must produce equal signatures."""
        by_seq = {e.seq: e for e in self.events}
        sig = []
        for e in self.events:
            parent = by_seq.get(e.parent)
            row = (e.kind, e.name, e.track, e.tick,
                   parent.name if parent is not None else None)
            if e.kind == "counter":
                row = row + (round(e.args["value"], 6),)
            sig.append(row)
        return sig

    def span_names(self) -> list[str]:
        return [e.name for e in self.events if e.kind == "span"]

    # -- export -------------------------------------------------------
    def export(self, directory: str, name: str) -> tuple[str, str]:
        """Write ``<name>.jsonl`` + ``<name>.trace.json`` under
        ``directory``; returns both paths."""
        from .export import write_trace
        return write_trace(self, directory, name)


class _NoopTracer:
    """Disabled singleton.  Every method is a constant-time no-op; hot
    paths should still guard with ``if tr.enabled`` so argument
    construction is skipped too."""

    enabled = False
    config = TelemetryConfig(enabled=False)
    events: list = []
    decisions: list = []

    def now(self):
        return 0

    def span(self, name, *, machine=CONTROL, tick=-1, **args):
        return _NULL_SPAN

    def emit_span(self, name, t0, t1, *, machine=CONTROL, tick=-1, **args):
        pass

    def instant(self, name, *, machine=CONTROL, tick=-1, t0=None, **args):
        pass

    def counter(self, name, value, *, machine=CONTROL, tick=-1, t0=None):
        pass

    def gauge(self, name, machine=CONTROL):
        return None

    def counter_series(self, name, machine=CONTROL):
        return [], []

    def record_decision(self, rec, tick=-1):
        pass

    def signature(self):
        return []

    def span_names(self):
        return []

    def export(self, directory, name):
        raise RuntimeError("cannot export from the disabled tracer")


NOOP = _NoopTracer()

# Module-global active tracer: the engine activates its tracer for the
# duration of a run so deep layers (core.protocol, ft.coordinator,
# streaming.planes) reach it without signature changes.
_active = NOOP


def current():
    """The tracer instrumentation sites should talk to (NOOP unless a
    run activated one)."""
    return _active


class activate:
    """``with activate(tracer): ...`` — scoped tracer activation.
    Tiny ``__slots__`` class (not a generator contextmanager): it sits
    on the per-tick path of every engine run."""

    __slots__ = ("_tr", "_prev")

    def __init__(self, tracer):
        self._tr = tracer

    def __enter__(self):
        global _active
        self._prev = _active
        _active = self._tr
        return self._tr

    def __exit__(self, *exc):
        global _active
        _active = self._prev
        return False
