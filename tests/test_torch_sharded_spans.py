"""The sharded data plane's spans (``repro_torch.streaming.sharded``) on
four host shards (``ShardedTorchPlane(4, "cpu")``), at the shape of the
benchmark's ``swarm-range-4chip`` deployment shrunk to the host: 16
machines, 4 a shard, a 32-cell grid, 4 × 2048 tuples a tick.

Inside ``sharded_window_dispatch``: ``shard_ingest``, one
``shard_exchange`` and one ``shard_price`` a destination shard, and
``shard_scan``; ``reshard_transfers`` around a round's payload copies.
Their byte arguments against the plane's running totals and the billed
migration bytes, the disabled tracer's silence and bit-for-bit outputs,
same-seed signatures, and the shrunk ``range-sharded-4chip`` cell through
the benchmark's harness against its plain references."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.streaming as T  # noqa: E402
from repro_torch.streaming import ShardedTorchPlane  # noqa: E402
from repro_torch.telemetry import NOOP  # noqa: E402

D, M, G, LAMBDA = 4, 16, 32, 4 * 2048
WINDOW_SPANS = ("shard_ingest", "shard_exchange", "shard_price",
                "shard_scan")
NEW_SPANS = WINDOW_SPANS + ("reshard_transfers",)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(*, keyword=False, traced=True, seed=0):
    """SWARM over four host shards: a hotspot with a query burst (range)
    or two trending terms (spatial-keyword), a round every four ticks,
    fused windows of eight, capacity far above the load."""
    if keyword:
        wl = T.WorkloadSpec(query_model="spatial_keyword", term_buckets=8)
        scen = T.ScenarioSpec("hot_hashtags", ticks=24, preload_queries=2000,
                              query_burst=100, hot_terms=2, term_peak=0.4)
    else:
        wl = T.WorkloadSpec()
        scen = T.ScenarioSpec("uniform_normal", ticks=24,
                              preload_queries=3000, query_burst=200,
                              peak=0.6)
    cfg = T.EngineConfig(
        num_machines=M, cap_units=1e12, lambda_max=LAMBDA,
        mem_queries=10**8, round_every=4, fused_window=8,
        telemetry=T.TelemetryConfig(tick_spans=False) if traced else None)
    router = T.RouterSpec("swarm", grid_size=G, beta=2).build(
        num_machines=M, workload=wl, data_plane=ShardedTorchPlane(D, "cpu"),
        seed=seed)
    eng = T.StreamingEngine(router, scen.build(seed=seed, workload=wl), cfg)
    router.ingest(eng.stream.preload(scen.preload_queries))
    return eng


def _spans(tracer, name):
    return [e for e in tracer.events if e.kind == "span" and e.name == name]


def _children(tracer, parent, name):
    return [e for e in _spans(tracer, name) if e.parent == parent.seq]


def _window_rises(eng) -> list:
    """Each fused window's rise in the plane's ``exchange_bytes_total``,
    in call order."""
    plane = eng.router.swarm.plane
    rises, real = [], plane.run_window

    def run_window(*args, **kw):
        before = plane.exchange_bytes_total
        out = real(*args, **kw)
        rises.append(plane.exchange_bytes_total - before)
        return out

    plane.run_window = run_window
    return rises


@pytest.mark.parametrize("keyword", [False, True])
def test_window_spans_nest_under_the_dispatch(keyword):
    eng = _engine(keyword=keyword)
    eng.run(24)
    tr = eng.tracer
    wins = _spans(tr, "sharded_window_dispatch")
    assert wins
    for w in wins:
        ingest = _children(tr, w, "shard_ingest")
        assert len(ingest) == 1
        b = w.args["batch"]
        assert ingest[0].args["tuples"] == w.args["ticks"] * b == \
            w.args["ticks"] * LAMBDA
        assert ingest[0].args["bytes"] >= 8 * ingest[0].args["tuples"]
        ex = _children(tr, w, "shard_exchange")
        price = _children(tr, w, "shard_price")
        assert [e.args["shard"] for e in ex] == list(range(D))
        assert [e.args["shard"] for e in price] == list(range(D))
        assert len(_children(tr, w, "shard_scan")) == 1
    for name in WINDOW_SPANS:
        assert len(_spans(tr, name)) == len(wins) * (
            D if name in ("shard_exchange", "shard_price") else 1), name


@pytest.mark.parametrize("keyword", [False, True])
def test_exchange_bytes_are_the_windows_rise(keyword):
    eng = _engine(keyword=keyword)
    rises = _window_rises(eng)
    eng.run(24)
    tr = eng.tracer
    wins = sorted(_spans(tr, "sharded_window_dispatch"), key=lambda e: e.t0)
    assert len(wins) == len(rises)
    got = [sum(e.args["bytes"] for e in _children(tr, w, "shard_exchange"))
           for w in wins]
    assert got == rises
    assert sum(got) == eng.router.swarm.plane.exchange_bytes_total > 0
    # every cell's float32 column reaches its owner's shard from the
    # D − 1 others, once more a term bucket for spatial-keyword windows
    state = eng._fused["state"]
    t1 = state.qres_kw[0].shape[1] if keyword else 0
    assert got == [(D - 1) * w.args["ticks"] * G * G * 4 * (1 + t1)
                   for w in wins]


def test_reshard_span_bytes_are_the_billed_bytes():
    eng = _engine()
    m = eng.run(24).asarrays()
    plane = eng.router.swarm.plane
    spans = sorted(_spans(eng.tracer, "reshard_transfers"),
                   key=lambda e: e.t0)
    moved = np.flatnonzero(m["transfers"])
    assert len(spans) == len(moved) > 0, \
        "the timeline moved nothing; the check is vacuous"
    assert [e.args["transfers"] for e in spans] == \
        m["transfers"][moved].astype(int).tolist()
    assert [e.args["bytes"] for e in spans] == \
        m["migration_bytes"][moved].astype(int).tolist()
    assert sum(e.args["bytes"] for e in spans) == \
        plane.reshard_bytes_total == int(m["migration_bytes"].sum()) > 0
    # the counter track still carries the same bytes
    counted = sum(e.args["value"] for e in eng.tracer.events
                  if e.kind == "counter" and e.name == "reshard_bytes")
    assert counted == plane.reshard_bytes_total


@pytest.mark.parametrize("keyword", [False, True])
def test_tracer_off_records_nothing_and_changes_nothing(keyword,
                                                        monkeypatch):
    asked = []
    real_span = type(NOOP).span

    def span(self, name, **kw):
        asked.append(name)
        return real_span(self, name, **kw)

    monkeypatch.setattr(type(NOOP), "span", span)
    off = _engine(keyword=keyword, traced=False)
    m_off = off.run(24).asarrays()
    on = _engine(keyword=keyword)
    m_on = on.run(24).asarrays()
    assert off.tracer is NOOP
    assert NOOP.events == [] and NOOP.signature() == []
    assert not set(asked) & set(NEW_SPANS)
    assert set(NEW_SPANS) - {"reshard_transfers"} <= set(
        on.tracer.span_names())
    for name in m_off:
        np.testing.assert_array_equal(m_off[name], m_on[name], err_msg=name)
    p_off, p_on = off.router.swarm.plane, on.router.swarm.plane
    for a, b in zip(p_off.collector_banks(off._fused["state"]),
                    p_on.collector_banks(on._fused["state"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(off.router.index.cell_to_partition,
                                  on.router.index.cell_to_partition)
    np.testing.assert_array_equal(off.router.index.parts.owner,
                                  on.router.index.parts.owner)
    np.testing.assert_array_equal(off.router.qres, on.router.qres)
    assert p_off.exchange_bytes_total == p_on.exchange_bytes_total
    assert p_off.reshard_bytes_total == p_on.reshard_bytes_total


@pytest.mark.parametrize("keyword", [False, True])
def test_same_seed_runs_give_equal_signatures(keyword):
    a = _engine(keyword=keyword, seed=3)
    a.run(24)
    b = _engine(keyword=keyword, seed=3)
    b.run(24)
    sig = a.tracer.signature()
    assert sig == b.tracer.signature()
    names = {row[1] for row in sig}
    assert set(WINDOW_SPANS) <= names
    assert {row[4] for row in sig if row[1] in WINDOW_SPANS} == \
        {"sharded_window_dispatch"}


def test_shrunk_cell_through_the_harness_is_correct():
    """The benchmark's ``range-sharded-4chip`` cell, shrunk, through
    ``harness.run_cell`` on the host, held against the plain references
    ``bench/reference/swarm_ref.py`` and ``round_ref.py``."""
    sys.path[:0] = [p for p in (os.path.join(ROOT, "src"),
                                os.path.join(ROOT, "bench"),
                                os.path.join(ROOT, "bench", "tests"))
                    if p not in sys.path]
    from _bench_tiny import tiny_cell
    from check import LIMITS
    from harness import run_cell
    cell = tiny_cell("range-sharded-4chip")
    assert cell.chips == D
    cell.system.update(machines=M, lambda_max=LAMBDA)
    out = run_cell(cell, 2**31 + 17, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    for k in LIMITS:
        c = out["checks"][k]
        assert c["value"] <= c["limit"], (k, c)
    assert out["checks"]["rounds_checked"]["value"] == 6
    assert set(out["metrics"]) == {"round_p95_ms", "setup_s"}
