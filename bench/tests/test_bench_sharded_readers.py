"""The sharded data plane window's readers (``sharded_window_ms``,
``shard_ingest_ms``, ``shard_exchange_ms``) on hand-made spans, silent
where their spans are absent, and finite on a traced run of the tiny
``range-sharded-4chip`` cell: four shards on the host standing in for
four cards, 16 machines, 4 a shard."""
import importlib
import math

import pytest

from _bench_tiny import tiny_cell
from readings import Trace
from tracer_events import span

NEW = ("sharded_window_ms", "shard_ingest_ms", "shard_exchange_ms")


def _read(name, trace):
    return importlib.import_module(f"metrics.{name}").read(trace)


def _windows(children=True):
    """Two sharded windows of 10 and 20 ms over two shards; with
    ``children`` each holds its ingest, an exchange and a pricing span a
    shard, and its scan."""
    spans = [span(0, "fused_window", 0, 30_000_000),
             span(1, "sharded_window_dispatch", 1e6, 10_000_000, parent=0),
             span(10, "fused_window", 100e6, 40_000_000),
             span(11, "sharded_window_dispatch", 101e6, 20_000_000,
                  parent=10)]
    if children:
        for w, scale in ((1, 1), (11, 2)):
            t = 1e6 if w == 1 else 101e6
            spans += [
                span(w + 1, "shard_ingest", t, 2_000_000 * scale, parent=w,
                     tuples=1024, bytes=8192),
                span(w + 2, "shard_exchange", t + 2e6, 1_000_000 * scale,
                     parent=w, shard=0, bytes=64),
                span(w + 3, "shard_price", t + 3e6, 500_000, parent=w,
                     shard=0),
                span(w + 4, "shard_exchange", t + 4e6, 500_000 * scale,
                     parent=w, shard=1, bytes=64),
                span(w + 5, "shard_price", t + 5e6, 500_000, parent=w,
                     shard=1),
                span(w + 6, "shard_scan", t + 6e6, 1_000_000, parent=w)]
    return spans


def test_sharded_window_ms():
    assert _read("sharded_window_ms", Trace(_windows(), 16)) == 15.0
    assert _read("sharded_window_ms", Trace(_windows(False), 16)) == 15.0
    one_chip = [span(0, "fused_window_dispatch", 0, 5_000_000)]
    assert _read("sharded_window_ms", Trace(one_chip, 16)) is None


def test_shard_ingest_ms():
    # (2 + 4) ms of ingest over two windows
    assert _read("shard_ingest_ms", Trace(_windows(), 16)) == 3.0
    assert _read("shard_ingest_ms", Trace(_windows(False), 16)) is None
    orphan = [span(0, "shard_ingest", 0, 1_000_000)]
    assert _read("shard_ingest_ms", Trace(orphan, 16)) is None


def test_shard_exchange_ms():
    # (1 + 0.5) + (2 + 1) ms of exchange over two windows
    assert _read("shard_exchange_ms", Trace(_windows(), 16)) == 2.25
    assert _read("shard_exchange_ms", Trace(_windows(False), 16)) is None
    orphan = [span(0, "shard_exchange", 0, 1_000_000)]
    assert _read("shard_exchange_ms", Trace(orphan, 16)) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_on_an_empty_trace(name):
    assert _read(name, Trace([], 16)) is None


def test_traced_tiny_four_shard_run(monkeypatch):
    import readings
    from harness import run_cell
    traces = []

    class Kept(readings.Trace):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            traces.append(self)

    monkeypatch.setattr(readings, "Trace", Kept)
    cell = tiny_cell("range-sharded-4chip")
    assert cell.chips == 4
    cell.system.update(machines=16, lambda_max=4 * 2048)
    out = run_cell(cell, 2**31 + 3, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    for name in NEW:
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    (tr,) = traces
    window = out["metrics"]["sharded_window_ms"]["value"]
    assert (out["metrics"]["shard_ingest_ms"]["value"]
            + out["metrics"]["shard_exchange_ms"]["value"]) < window
    assert any(e.name == "reshard_transfers" for e in tr.spans)
