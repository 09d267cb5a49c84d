"""The port's tracer inside a SWARM round, on the CPU (``TorchPlane("cpu")``):
the query re-index's spans and counts (``query_reindex`` →
``reindex_cells`` / ``reindex_overlap`` / ``reindex_pivots``), the fused
window's children (``window_stage``, ``state_refresh``,
``throttled_window_dispatch``)
and the collector drain, their nesting under ``tick`` and under a
wrapper span around the re-index, the disabled tracer's silence, same-seed
signatures, and the ``torch.profiler`` capture's anchors."""
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.streaming as T  # noqa: E402
from repro_torch.streaming.baselines import force_rebalance_round  # noqa: E402
from repro_torch.streaming.engine import PROFILER_ANCHOR  # noqa: E402
from repro_torch.telemetry import NOOP, Tracer, activate  # noqa: E402

M = 8
# capacity (range, keyword) at which the rebalancing timeline's fused
# windows are partly accepted and partly declined (backpressure engages
# mid-run)
MIXED_CAP = {False: 1e4, True: 5e3}
NEW_SPANS = ("query_reindex", "reindex_cells", "reindex_overlap",
             "reindex_pivots", "window_stage", "state_refresh",
             "throttled_window_dispatch", "collectors_drain")


def _engine(*, keyword=False, window=0, cap=1e9, traced=True, seed=0,
            telemetry=None):
    """SWARM on the CPU plane over a rebalancing timeline (a hotspot
    with a query burst, a round every two ticks) with 3000 standing
    queries preloaded."""
    scen = T.ScenarioSpec("uniform_normal", ticks=24, preload_queries=3000,
                          query_burst=200, peak=0.6)
    wl = (T.WorkloadSpec(query_model="spatial_keyword", term_buckets=8)
          if keyword else T.WorkloadSpec())
    if telemetry is None and traced:
        telemetry = T.TelemetryConfig(tick_spans=False)
    cfg = T.EngineConfig(num_machines=M, cap_units=cap, lambda_max=2000,
                         mem_queries=10**8, round_every=2,
                         fused_window=window, telemetry=telemetry)
    router = T.RouterSpec("swarm", beta=2).build(
        num_machines=M, workload=wl, data_plane=T.TorchPlane("cpu"),
        seed=seed)
    eng = T.StreamingEngine(router, scen.build(seed=seed, workload=wl), cfg)
    router.ingest(eng.stream.preload(scen.preload_queries))
    return eng


def _spans(tracer, name):
    return [e for e in tracer.events if e.kind == "span" and e.name == name]


def _parents(tracer, name):
    by_seq = {e.seq: e for e in tracer.events}
    return {by_seq[e.parent].name if e.parent in by_seq else None
            for e in _spans(tracer, name)}


def _children(tracer, parent, name):
    return [e for e in _spans(tracer, name) if e.parent == parent.seq]


def _span_reindex(eng):
    """The benchmark's wrapper span around the router's re-index (an
    instance attribute over the method, as ``bench/harness.py`` puts it)."""
    router, tr = eng.router, eng.tracer
    real = router.reindex_all_queries

    def reindex_all_queries():
        with tr.span("reindex_queries", queries=router.q_total):
            real()

    router.reindex_all_queries = reindex_all_queries


@pytest.mark.parametrize("keyword", [False, True])
def test_query_reindex_counts(keyword):
    """Three calls after a few rounds: nothing changed since the last;
    after a forced round that splits (only its halves are counted);
    after the standing set was replaced (the cells rebuilt, every live
    partition counted)."""
    eng = _engine(keyword=keyword)
    eng.run(6)
    router = eng.router
    q = len(router.query_rects)
    tr = Tracer()
    with activate(tr):
        router.reindex_all_queries()
        hits_before = int(router.qres.sum())
        rep = force_rebalance_round(router.swarm)
        router.reindex_all_queries()
        hits_after_round = int(router.qres.sum())
        router.query_rects = router.query_rects.copy()
        router.reindex_all_queries()
    idle, rnd, full = _spans(tr, "query_reindex")
    live = len(router.index.parts.live_ids())
    born, gone = len(rep.new_pids), len(rep.moved_pids)
    assert idle.args == {"queries": q, "live": live - born + gone,
                         "pairs": 0, "hits": hits_before, "counted": 0,
                         "inherited": 0, "dropped": 0, "full": 0}
    assert [t.action for t in rep.transfers] == ["split"]
    counted = born
    assert rnd.args == {"queries": q, "live": live, "pairs": q * counted,
                        "hits": hits_after_round, "counted": counted,
                        "inherited": 0, "dropped": gone, "full": 0}
    assert full.args == {"queries": q, "live": live, "pairs": q * live,
                         "hits": int(router.qres.sum()), "counted": live,
                         "inherited": 0, "dropped": 0, "full": 1}
    assert full.args["hits"] == hits_after_round > 0
    assert [len(_children(tr, sp, "reindex_cells"))
            for sp in (idle, rnd, full)] == [0, 0, 1]
    assert [len(_children(tr, sp, "reindex_overlap"))
            for sp in (idle, rnd, full)] == [0, counted, live]
    assert [len(_children(tr, sp, "reindex_pivots"))
            for sp in (idle, rnd, full)] == (
        [0, counted, live] if keyword else [0, 0, 0])
    if keyword:                      # the pivot histogram holds every hit
        assert router.qres_kw.sum() == full.args["hits"]


def test_reindex_nests_under_tick_and_the_wrapper():
    eng = _engine()
    eng.run(24)
    assert _spans(eng.tracer, "query_reindex")
    assert _parents(eng.tracer, "query_reindex") == {"tick"}

    wrapped = _engine()
    _span_reindex(wrapped)
    wrapped.run(24)
    tr = wrapped.tracer
    assert _parents(tr, "reindex_queries") == {"tick"}
    assert _parents(tr, "query_reindex") == {"reindex_queries"}
    assert (len(_spans(tr, "query_reindex"))
            == len(_spans(tr, "reindex_queries"))
            == len(_spans(eng.tracer, "query_reindex")))
    # the cells were kept from the registration: no call rebuilds them
    assert {e.args["full"] for e in _spans(tr, "query_reindex")} == {0}
    assert not _spans(tr, "reindex_cells")
    assert _parents(tr, "reindex_overlap") == {"query_reindex"}


@pytest.mark.parametrize("keyword", [False, True])
def test_fused_window_children(keyword):
    eng = _engine(keyword=keyword, window=8, cap=MIXED_CAP[keyword])
    eng.run(24)
    tr = eng.tracer
    wins = _spans(tr, "fused_window")
    declined = [e for e in wins if e.args["ok"] is False]
    assert declined and len(declined) < len(wins)
    assert eng.declined_windows == len(declined)
    # the running count, in the order the windows closed
    ok = [e.args["ok"] for e in sorted(wins, key=lambda e: e.seq)]
    counts = [e.args["declined"] for e in sorted(wins, key=lambda e: e.seq)]
    assert counts == np.cumsum([not o for o in ok]).tolist()
    for w in wins:
        assert len(_children(tr, w, "window_stage")) == 1
        assert len(_children(tr, w, "state_refresh")) == 1
        # one full-batch dispatch unless the carry throttled tick 0
        assert len(_children(tr, w, "fused_window_dispatch")) == (
            not w.args["skipped"])
        assert len(_children(tr, w, "throttled_window_dispatch")) == (
            not w.args["ok"])
    drains = _spans(tr, "collectors_drain")
    assert drains
    assert all(e.args["bytes"] > 0 for e in drains)
    assert _spans(tr, "query_reindex")


@pytest.mark.parametrize("window", [0, 8])
def test_tracer_off_records_nothing_and_changes_nothing(window, monkeypatch):
    asked = []
    real_span = type(NOOP).span

    def span(self, name, **kw):
        asked.append(name)
        return real_span(self, name, **kw)

    monkeypatch.setattr(type(NOOP), "span", span)
    off = _engine(keyword=True, window=window, cap=MIXED_CAP[True],
                  traced=False)
    off.run(24)
    on = _engine(keyword=True, window=window, cap=MIXED_CAP[True])
    on.run(24)
    assert off.tracer is NOOP
    assert NOOP.events == [] and NOOP.signature() == []
    assert not set(asked) & set(NEW_SPANS)
    assert _spans(on.tracer, "query_reindex")
    np.testing.assert_array_equal(off.router.qres, on.router.qres)
    np.testing.assert_array_equal(off.router.qres_kw, on.router.qres_kw)
    assert off.declined_windows == on.declined_windows
    for name in ("injected", "throughput", "transfers"):
        np.testing.assert_array_equal(off.metrics.asarrays()[name],
                                      on.metrics.asarrays()[name])


def test_same_seed_runs_give_equal_signatures():
    a = _engine(keyword=True, window=8, cap=MIXED_CAP[True])
    a.run(24)
    b = _engine(keyword=True, window=8, cap=MIXED_CAP[True])
    b.run(24)
    sig = a.tracer.signature()
    assert sig == b.tracer.signature()
    names = {row[1] for row in sig}
    # the cells are kept from the registration: no rebuild in the run
    assert set(NEW_SPANS) - {"reindex_cells"} <= names
    assert "reindex_cells" not in names


def test_profiler_capture_is_anchored_to_the_tracer(tmp_path):
    prof_dir, trace_dir = tmp_path / "prof", tmp_path / "trace"
    tcfg = T.TelemetryConfig(tick_spans=False, profiler_dir=str(prof_dir),
                             trace_dir=str(trace_dir))
    assert str(tcfg) == "telemetry(trace,nospans,prof)"
    eng = _engine(telemetry=tcfg)
    eng.run(4)
    anchors = [e for e in eng.tracer.events if e.name == PROFILER_ANCHOR]
    assert [(e.kind, e.args["at"]) for e in anchors] == [
        ("instant", "start"), ("instant", "end")]
    assert anchors[0].t0 <= anchors[1].t0
    (dump,) = glob.glob(os.path.join(prof_dir, "*.json"))
    with open(dump) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count(PROFILER_ANCHOR) == 2
    _, chrome = eng.tracer.export(str(trace_dir), "run")
    with open(chrome) as f:
        exported = [e for e in json.load(f)["traceEvents"]
                    if e.get("name") == PROFILER_ANCHOR]
    assert [(e["ph"], e["args"]["at"]) for e in exported] == [
        ("i", "start"), ("i", "end")]
