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


def _one_card_before(dev, marks, spans):
    """The reduction as it read one card before it took several: every
    device event on one timeline."""
    marks = sorted(marks)
    lo, hi = marks[0], marks[-1]
    dev = sorted((s, d, n) for s, d, n in dev if lo <= s < hi)
    busy, gaps, end = 0, [], lo
    for s, d, _ in dev:
        if s > end:
            gaps.append((end, s))
        busy += max(0, s + d - max(s, end))
        end = max(end, s + d)
    if hi > end:
        gaps.append((end, hi))
    kernels = {}
    for s, d, n in dev:
        kernels.setdefault(n, []).append(d / 1e9)
    ops = sorted(([n[:80], sum(v)] for n, v in kernels.items()),
                 key=lambda kv: -kv[1])[:10]
    return (hi - lo) / 1e9, busy / 1e9, kernels, ops, _attribute(gaps, spans)


def test_one_card_reads_as_before():
    import numpy as np

    from readings import device_readings
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(1, 300))
        starts = rng.integers(0, 10**9, n).tolist()
        durs = rng.integers(0, 10**7, n).tolist()
        names = [f"k{int(i)}" for i in rng.integers(0, 14, n)]
        dev = list(zip(starts, durs, names))
        marks = sorted(rng.integers(0, 10**9, 3).tolist())
        spans = [(0, 4 * 10**8, "tick"), (10**8, 2 * 10**8, "round_close"),
                 (5 * 10**8, 9 * 10**8, "fused_window")]
        got = device_readings([(0, s, d, nm) for s, d, nm in dev], marks,
                              (0,), spans)
        assert got == _one_card_before(dev, marks, spans)


def test_two_cards_average_their_busy_time():
    from readings import device_readings
    ms = 10**6
    events = [(0, 0, 500 * ms, "a"),              # card 0 busy 0.5 s
              (1, 700 * ms, 100 * ms, "b"),       # card 1 busy 0.1 s
              (1, 450 * ms, 0, "b"),
              (2, 500 * ms, 300 * ms, "c"),       # not a card of the cell
              (0, 1000 * ms, 50 * ms, "a")]       # after the window
    spans = [(0, 1000 * ms, "tick"), (720 * ms, 780 * ms, "round_close")]
    window, busy, kernels, ops, gaps = device_readings(
        events, [0, 1000 * ms], (0, 1), spans)
    assert window == 1.0
    assert busy == 0.3
    t = Trace([], 512, window_s=window, busy_s=busy, kernels=kernels)
    assert abs(_read("device_idle_share", t) - 70.0) < 1e-9
    assert kernels == {"a": [0.5], "b": [0.0, 0.1]}
    assert ops == [["a", 0.5], ["b", 0.1]]
    # idle only where neither card is busy: 0.5–0.7 s and 0.8–1.0 s,
    # not under round_close, where card 0 idles while card 1 works
    got = dict(gaps)
    assert set(got) == {"tick"}
    assert abs(got["tick"] - 0.4) < 1e-12
