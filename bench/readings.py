"""The traced run's readings: the program's tracer spans over the whole
window, and ``torch.profiler`` over whole replay cycles of it, reduced in
memory (nothing is written) to the device's busy time, its operations
and the host span under each idle gap.

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
    ``busy_s`` and ``window_s``, ``kernels`` (device operation name →
    durations in seconds, in launch order) and ``closes`` (the live
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
    """``torch.profiler`` over whole replay cycles of the window."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.prof = None

    def _mark(self) -> int:
        import torch
        with torch.profiler.record_function(MARK):
            return self.tracer.now()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = self._mark()
        self.wall0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
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
                    dev.append((e.start_ns(), e.duration_ns(), e.name()))
            elif e.name() == MARK:
                marks.append(e.start_ns())
        marks.sort()
        if len(marks) < 2:
            raise RuntimeError("profiler: the window's markers are missing")
        lo, hi = marks[0], marks[-1]
        offset = lo - self.t0            # tracer ns → profiler ns
        dev = sorted((s, d, n) for s, d, n in dev if lo <= s < hi)
        busy, gaps, end = 0, [], lo
        for s, d, _ in dev:
            if s > end:
                gaps.append((end, s))
            busy += max(0, s + d - max(s, end))
            end = max(end, s + d)
        if hi > end:
            gaps.append((end, hi))
        trace.window_s = (hi - lo) / 1e9
        trace.busy_s = busy / 1e9
        for s, d, n in dev:
            trace.kernels.setdefault(n, []).append(d / 1e9)
        trace.device_ops = sorted(
            ([n[:80], sum(v)] for n, v in trace.kernels.items()),
            key=lambda kv: -kv[1])[:10]
        spans = [(e.t0 + offset, e.t0 + e.dur + offset, e.name)
                 for e in trace.spans]
        trace.closes = [e.args.get("live", 0) for e in trace.spans
                        if e.name == "stats_close"
                        and self.t0 <= e.t0 < self.t1]
        trace.idle_gaps = _attribute(gaps, spans)


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
