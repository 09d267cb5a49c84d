"""The traced run's readings: the program's tracer spans over the whole
window, and ``torch.profiler`` over whole replay cycles of it, reduced in
memory (nothing is written) to the cell's cards' busy time, their
operations and the host span under each stretch in which no card of the
cell is busy.

The profiler's raw events are read (``key_averages`` takes minutes over
hundreds of thousands of events).  The tracer's clock and the
profiler's are tied by a ``record_function`` marker taken at the same
instant as a tracer reading."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

MARK = "bench_mark"


@dataclass
class Trace:
    """What the per-layer readers read.  ``spans``: the tracer's span
    events of the window.  The rest covers the profiled cycles only:
    ``window_s``, ``busy_s`` (the mean over the cell's cards of each
    card's busy seconds), ``kernels`` (device operation name → durations
    in seconds on every card, in launch order) and ``closes`` (the live
    partitions of each round close, in order)."""

    spans: list
    grid: int
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)
    closes: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Profiler:
    """``torch.profiler`` over whole replay cycles of the window, on the
    cell's ``cards`` (CUDA device indices; none on the host)."""

    def __init__(self, tracer, cards: tuple):
        self.tracer = tracer
        self.cards = tuple(cards)
        self.prof = None

    def _mark(self) -> int:
        import torch
        with torch.profiler.record_function(MARK):
            return self.tracer.now()

    def _sync(self) -> None:
        import torch
        for k in self.cards:
            torch.cuda.synchronize(k)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cards:
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = self._mark()
        self.wall0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = self._mark()
        self.wall = time.perf_counter() - self.wall0
        self.prof.__exit__(None, None, None)

    def reduce(self, trace: Trace) -> None:
        """Fill ``trace``'s device fields from the profiled cycles."""
        from torch.autograd import DeviceType
        marks, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", lambda: False)():
                    dev.append((e.device_index(), e.start_ns(),
                                e.duration_ns(), e.name()))
            elif e.name() == MARK:
                marks.append(e.start_ns())
        if len(marks) < 2:
            raise RuntimeError("profiler: the window's markers are missing")
        offset = min(marks) - self.t0        # tracer ns → profiler ns
        spans = [(e.t0 + offset, e.t0 + e.dur + offset, e.name)
                 for e in trace.spans]
        (trace.window_s, trace.busy_s, trace.kernels, trace.device_ops,
         trace.idle_gaps) = device_readings(dev, marks, self.cards, spans)
        trace.closes = [e.args.get("live", 0) for e in trace.spans
                        if e.name == "stats_close"
                        and self.t0 <= e.t0 < self.t1]


def device_readings(events, marks, cards, spans):
    """The device readings of the profiled cycles, from the profiler's
    device events ``(card, start_ns, duration_ns, name)``, its window
    markers (start ns) and the host spans ``(start_ns, end_ns, name)``
    on the profiler's clock.  Only events on the cell's ``cards`` that
    start between the first and last marker count.

    Returns ``(window_s, busy_s, kernels, device_ops, idle_gaps)``:
    ``busy_s`` is the mean over ``cards`` of each card's busy seconds
    (its events' union), so that 1 − busy / window is the cell's idle
    share; ``kernels`` and ``device_ops`` take every card's events;
    ``idle_gaps`` are the stretches where no card is busy, by the host
    span under each (:func:`_attribute`)."""
    lo, hi = min(marks), max(marks)
    busy = dict.fromkeys(cards, 0)       # ns each card is busy
    end = dict.fromkeys(cards, lo)       # where each card's work ends
    dev = sorted((s, d, n, k) for k, s, d, n in events
                 if k in busy and lo <= s < hi)
    gaps, last = [], lo                  # `last`: where any card's ends
    for s, d, _, k in dev:
        busy[k] += max(0, s + d - max(s, end[k]))
        end[k] = max(end[k], s + d)
        if s > last:
            gaps.append((last, s))
        last = max(last, s + d)
    if hi > last:
        gaps.append((last, hi))
    kernels = {}
    for s, d, n, _ in dev:
        kernels.setdefault(n, []).append(d / 1e9)
    device_ops = sorted(([n[:80], sum(v)] for n, v in kernels.items()),
                        key=lambda kv: -kv[1])[:10]
    busy_s = sum(busy.values()) / (max(len(busy), 1) * 1e9)
    return ((hi - lo) / 1e9, busy_s, kernels, device_ops,
            _attribute(gaps, spans))


def _attribute(gaps, spans) -> list:
    """Idle seconds by the innermost host span open at each gap's middle
    (spans nest), the ten largest."""
    ev = [(a, 0, i) for i, (a, _, _) in enumerate(spans)]
    ev += [(b, 2, i) for i, (_, b, _) in enumerate(spans)]
    ev += [((a + b) // 2, 1, j) for j, (a, b) in enumerate(gaps)]
    ev.sort()
    stack, by = [], {}
    for _, kind, i in ev:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            if i in stack:
                stack.remove(i)
        else:
            a, b = gaps[i]
            name = spans[stack[-1]][2] if stack else "outside the engine's spans"
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:10]
