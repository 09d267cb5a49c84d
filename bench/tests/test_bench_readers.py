"""The per-layer readers on hand-made spans and device readings."""
import importlib

import _bench_tiny  # noqa: F401  (puts the benchmark's folder on the path)
from readings import Trace, _attribute
from tracer_events import span


def _read(name, trace):
    return importlib.import_module(f"metrics.{name}").read(trace)


def test_span_readers():
    spans = [span(0, "tick", 0, 10_000_000), span(1, "round_close", 1e6,
                                                  2_000_000, parent=0),
             span(2, "reindex_queries", 4e6, 3_000_000, parent=0),
             span(3, "fused_window", 20e6, 8_000_000, ok=True),
             span(4, "fused_window_dispatch", 21e6, 5_000_000, parent=3),
             span(5, "fused_window", 30e6, 9_000_000, ok=False),
             span(6, "fused_window_dispatch", 31e6, 1_000_000, parent=5)]
    t = Trace(spans, 16)
    assert _read("tick_ms", t) == 5.0
    assert _read("round_close_ms", t) == 2.0
    assert _read("reindex_ms", t) == 3.0
    assert _read("staging_ms", t) == 3.0
    assert _read("declined_window_ms", t) == 8.0
    assert _read("window_dispatch_ms", t) == 3.0
    assert _read("k1_roofline", t) is None
    assert _read("device_idle_share", t) is None


def test_device_readers():
    from peaks import k1_link_bound_s
    t = Trace([], 512, window_s=2.0, busy_s=0.5,
              kernels={"stats_update_live_kernel(x)": [1e-4, 1e-4]},
              closes=[66, 66])
    assert _read("device_idle_share", t) == 75.0
    share = _read("k1_roofline", t)
    assert abs(share - 100 * k1_link_bound_s(66, 512) / 1e-4) < 1e-9
    assert 0 < share < 100
    t.closes = [66]                   # launches and closes must pair
    assert _read("k1_roofline", t) is None


def test_idle_gaps_go_to_the_innermost_span():
    spans = [(0, 100, "round_close"), (10, 40, "stats_close"),
             (200, 300, "tick")]
    gaps = [(20, 30), (50, 90), (120, 180), (250, 260)]
    got = dict(_attribute(gaps, spans))
    assert got == {"stats_close": 10e-9, "round_close": 40e-9,
                   "outside the engine's spans": 60e-9, "tick": 10e-9}
