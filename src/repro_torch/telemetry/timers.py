"""Shared wall-clock timers — the one implementation every benchmark
reports from (replaces the hand-rolled ``_time`` loops that
``benchmarks/overheads.py`` and ``engine_throughput.py`` each carried).
"""
from __future__ import annotations

import time


class Stopwatch:
    """``with Stopwatch() as sw: ...`` then read ``sw.s`` / ``sw.us``.
    Also usable unscoped via :meth:`start`/:meth:`stop`."""

    __slots__ = ("t0", "elapsed_ns")

    def __init__(self):
        self.t0 = 0
        self.elapsed_ns = 0

    def start(self) -> "Stopwatch":
        self.t0 = time.perf_counter_ns()
        return self

    def stop(self) -> "Stopwatch":
        self.elapsed_ns = time.perf_counter_ns() - self.t0
        return self

    @property
    def s(self) -> float:
        return self.elapsed_ns / 1e9

    @property
    def us(self) -> float:
        return self.elapsed_ns / 1e3

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def time_us(fn, n: int = 20, warmup: int = 1) -> float:
    """Mean wall time of ``fn()`` in µs over ``n`` timed calls after
    ``warmup`` untimed ones (jit compilation, cache fill)."""
    for _ in range(warmup):
        fn()
    sw = Stopwatch().start()
    for _ in range(n):
        fn()
    sw.stop()
    return sw.us / n


def time_once_us(fn) -> tuple[float, object]:
    """(µs, result) of a single call — for compile-vs-dispatch splits
    where the first call must be measured alone."""
    sw = Stopwatch().start()
    out = fn()
    sw.stop()
    return sw.us, out
