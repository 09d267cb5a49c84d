"""The router's query index kept between rounds, on the CPU
(``TorchPlane("cpu")``): after every plan change ``reindex_all_queries``
counts only the partitions minted since the last call — a subset move's
pid takes its parent's rows, a split's halves and a merge are tested,
retired pids are zeroed — and ``qres`` / ``qres_kw`` must equal a count
from scratch, written plainly below, on the range and keyword routers.
Cases: the rounds of a rebalancing timeline, a machine's failure, a
merge, a late registration between rounds, and a checkpoint round trip
(the first call after the restore rebuilds in full, the next do not)."""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.streaming as T  # noqa: E402
from repro_torch.checkpoint import restore_stream, save_stream  # noqa: E402
from repro_torch.streaming.baselines import force_rebalance_round  # noqa: E402
from repro_torch.telemetry import Tracer, activate  # noqa: E402

M = 8
SCEN = T.ScenarioSpec("uniform_normal", ticks=40, preload_queries=3000,
                      query_burst=200, peak=0.6)


def _workload(keyword):
    return (T.WorkloadSpec(query_model="spatial_keyword", term_buckets=8)
            if keyword else T.WorkloadSpec())


def _engine(keyword, *, telemetry=None):
    """SWARM on the CPU plane over a hotspot with a query burst, a round
    every two ticks, 3000 standing queries preloaded (in bulk batches of
    500, so registration takes the bulk path as well as the per-rect
    one)."""
    wl = _workload(keyword)
    cfg = T.EngineConfig(num_machines=M, cap_units=1e9, lambda_max=2000,
                         mem_queries=10**8, round_every=2,
                         telemetry=telemetry or T.TelemetryConfig(
                             tick_spans=False))
    router = T.RouterSpec("swarm", beta=2).build(
        num_machines=M, workload=wl, data_plane=T.TorchPlane("cpu"), seed=0)
    router.BULK_INDEX_MIN = 500
    router._BULK_CHUNK = 700
    eng = T.StreamingEngine(router, SCEN.build(seed=0, workload=wl), cfg)
    router.ingest(eng.stream.preload(SCEN.preload_queries))
    return eng


def _from_scratch(router):
    """Every standing query tested against every live partition's box,
    one partition at a time; retired and unused rows hold 0."""
    g = router.index.grid_size
    rects = router.query_rects

    def cell(v):
        return np.clip((v * g).astype(np.int32), 0, g - 1)

    c0, r0 = cell(rects[:, 0]), cell(rects[:, 1])
    c1 = np.maximum(cell(rects[:, 2]), c0)
    r1 = np.maximum(cell(rects[:, 3]), r0)
    p = router.index.parts
    qres = np.zeros(len(router.qres), np.int64)
    kw = (None if router.qres_kw is None
          else np.zeros(router.qres_kw.shape, np.float64))
    for pid in range(p.n_alloc):
        if not p.alive[pid]:
            continue
        hit = ((r0 <= p.r1[pid]) & (r1 >= p.r0[pid])
               & (c0 <= p.c1[pid]) & (c1 >= p.c0[pid]))
        qres[pid] = hit.sum()
        if kw is not None:
            for b in router.sub_pivots[hit]:
                kw[pid, b] += 1.0
    return qres, kw


def _check(router):
    qres, kw = _from_scratch(router)
    assert router.qres.dtype == np.int64
    np.testing.assert_array_equal(router.qres, qres)
    if kw is not None:
        assert router.qres_kw.dtype == np.float64
        np.testing.assert_array_equal(router.qres_kw, kw)


def _checked_rounds(eng):
    """Check the counts after each of the engine's rounds."""
    router = eng.router
    real = router.on_round

    def on_round(tick):
        out = real(tick)
        _check(router)
        return out

    router.on_round = on_round


def _calls(tracer):
    return [e for e in tracer.events
            if e.kind == "span" and e.name == "query_reindex"]


def _bounded(tracer):
    """Every call tested at most queries × live pairs; returns the calls."""
    calls = _calls(tracer)
    for e in calls:
        a = e.args
        assert a["pairs"] == a["queries"] * a["counted"]
        assert a["pairs"] <= a["queries"] * a["live"]
    return calls


@pytest.mark.parametrize("keyword", [False, True])
def test_rounds_keep_exact_counts(keyword):
    eng = _engine(keyword)
    _checked_rounds(eng)
    eng.run(40)
    calls = _bounded(eng.tracer)
    assert len(calls) >= 3
    assert all(e.args["full"] == 0 for e in calls)
    # the rounds split partitions: each call tests only the halves,
    # fewer pids than are live
    assert sum(e.args["counted"] for e in calls) > 0
    assert all(e.args["counted"] < e.args["live"] for e in calls)
    assert sum(e.args["dropped"] for e in calls) > 0


@pytest.mark.parametrize("keyword", [False, True])
def test_forced_rounds_and_a_machine_failure(keyword):
    eng = _engine(keyword)
    _checked_rounds(eng)
    eng.run(12)
    router = eng.router
    with activate(Tracer()) as tr:
        for _ in range(3):
            force_rebalance_round(router.swarm)
            router.reindex_all_queries()
            _check(router)
        out = router.ingest(T.MachineFailure(3, eng.tick_no))
        assert out is not None and out.transfers
        _check(router)
    calls = _bounded(tr)
    # the evacuation moves whole partitions: their new pids take their
    # parents' rows and are not tested
    last = calls[-1].args
    assert last["inherited"] > 0 and last["full"] == 0
    assert last["dropped"] >= last["inherited"]
    eng.run(8)
    _check(router)


@pytest.mark.parametrize("keyword", [False, True])
def test_merge_then_reindex(keyword):
    eng = _engine(keyword)
    _checked_rounds(eng)
    eng.run(20)
    router = eng.router
    sw = router.swarm
    # give a machine's partitions to one owner so that some pair of
    # neighbours forms a rectangle, then merge them
    p = sw.index.parts
    p.owner[p.live_ids()] = 0
    assert sw.merge_adjacent() > 0
    with activate(Tracer()) as tr:
        router.reindex_all_queries()
    _check(router)
    (call,) = _bounded(tr)
    assert call.args["counted"] > 0 and call.args["full"] == 0
    assert call.args["dropped"] >= 2


@pytest.mark.parametrize("keyword", [False, True])
def test_late_registration_between_rounds(keyword):
    eng = _engine(keyword)
    _checked_rounds(eng)
    eng.run(10)
    router = eng.router
    rng = np.random.default_rng(5)
    wl = _workload(keyword)

    def batch(n):
        lo = rng.uniform(0, 0.9, (n, 2))
        rects = np.concatenate(
            [lo, lo + rng.uniform(0.001, 0.1, (n, 2))], 1).astype(np.float32)
        terms = (rng.integers(0, 50, (n, wl.sub_terms)).astype(np.int64)
                 if keyword else None)
        return T.QueryBatch(rects, eng.tick_no, terms)

    for n in (37, 900):               # the per-rect path, then the bulk one
        # a plan change whose new pids meet the batch before their count
        force_rebalance_round(router.swarm)
        router.ingest(batch(n))
        router.reindex_all_queries()
        _check(router)
        eng.run(6)
    _check(router)
    # whole partitions moved, then a batch before the re-index: the moved
    # pids' parents were counted, but not over the grown set
    assert router.swarm.recover_machine(2).transfers
    router.ingest(batch(300))
    with activate(Tracer()) as tr:
        router.reindex_all_queries()
    _check(router)
    (call,) = _bounded(tr)
    assert call.args["inherited"] == 0 and call.args["counted"] > 0


@pytest.mark.parametrize("keyword", [False, True])
def test_checkpoint_round_trip_rebuilds_once(keyword):
    half = _engine(keyword)
    half.run(20)
    with tempfile.TemporaryDirectory() as d:
        save_stream(d, half)
        fresh = _engine(keyword)
        assert restore_stream(d, fresh) == 20
    _check(fresh.router)
    _checked_rounds(fresh)
    fresh.run(20)
    calls = _bounded(fresh.tracer)
    assert len(calls) >= 2
    assert [e.args["full"] for e in calls] == [1] + [0] * (len(calls) - 1)
    first = calls[0].args
    assert first["counted"] == first["live"] and first["inherited"] == 0
