"""The router query index's readers (``reindex_pair_ns``,
``reindex_pivot_ms``) on hand-made spans, and the readers that were
there before them reading the same with the program's own spans nested
inside theirs."""
import importlib

import _bench_tiny  # noqa: F401  (puts the benchmark's folder on the path)
from readings import Trace
from tracer_events import span


def _read(name, trace):
    return importlib.import_module(f"metrics.{name}").read(trace)


def _round(keyword):
    """A tick whose round re-indexes twice (a wrapper span around each
    call, as the benchmark puts it), then an accepted and a declined
    fused window."""
    spans = [span(0, "tick", 0, 100_000_000),
             span(1, "round_close", 1e6, 2_000_000, parent=0),
             span(2, "reindex_queries", 4e6, 30_000_000, parent=0),
             span(3, "reindex_queries", 40e6, 50_000_000, parent=0),
             span(10, "fused_window", 200e6, 8_000_000, ok=True, declined=0),
             span(11, "fused_window_dispatch", 201e6, 5_000_000, parent=10),
             span(12, "fused_window", 300e6, 9_000_000, ok=False, declined=1),
             span(13, "fused_window_dispatch", 301e6, 1_000_000, parent=12)]
    inner = [span(4, "query_reindex", 5e6, 20_000_000, parent=2,
                  queries=1000, live=10, pairs=10_000, chunks=2),
             span(5, "reindex_cells", 5e6, 1_000_000, parent=4),
             span(6, "reindex_overlap", 6e6, 4_000_000, parent=4),
             span(7, "query_reindex", 41e6, 40_000_000, parent=3,
                   queries=1000, live=30, pairs=30_000, chunks=2),
             span(14, "window_stage", 200e6, 1_000_000, parent=10),
             span(15, "state_refresh", 201e6, 1_000_000, parent=10),
             span(16, "window_replay", 302e6, 6_000_000, parent=12),
             span(17, "collectors_drain", 400e6, 500_000, bytes=4096)]
    if keyword:
        inner += [span(8, "reindex_pivots", 10e6, 3_000_000, parent=4),
                  span(9, "reindex_pivots", 50e6, 5_000_000, parent=7)]
    return spans, inner


def test_reindex_pair_ns():
    spans, inner = _round(keyword=False)
    assert _read("reindex_pair_ns", Trace(spans + inner, 16)) == 1500.0
    assert _read("reindex_pair_ns", Trace(spans, 16)) is None


def test_reindex_pivot_ms():
    spans, inner = _round(keyword=True)
    assert _read("reindex_pivot_ms", Trace(spans + inner, 16)) == 4.0
    spans, inner = _round(keyword=False)
    assert _read("reindex_pivot_ms", Trace(spans + inner, 16)) is None
    assert _read("reindex_pivot_ms", Trace(spans, 16)) is None


def test_old_readers_read_the_same_with_the_new_spans_nested():
    spans, inner = _round(keyword=True)
    bare, nested = Trace(spans, 16), Trace(spans + inner, 16)
    want = {"tick_ms": 18.0, "reindex_ms": 40.0, "staging_ms": 3.0,
            "declined_window_ms": 8.0}
    for name, value in want.items():
        assert _read(name, bare) == value, name
        assert _read(name, nested) == value, name
