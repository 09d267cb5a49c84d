"""``TorchPlane.run_window_throttled`` on the CPU (``TorchPlane("cpu")``):
a fused window under backpressure against the engine's per-tick replay of
the same staged batches from the same carry (``StreamingEngine.
_window_reference``), for range and keyword workloads, throttled from
the first tick, from a later tick or never, over windows of 1, 3 and 8
ticks; the never-throttled window against ``run_window``; and a
throttled SWARM run, fused against per-tick, end to end."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.streaming as T  # noqa: E402
from repro_torch.core import statistics as S  # noqa: E402

M, LAMBDA = 8, 2000
# capacity (units a machine and tick) and the carry's λ of each case: the
# batch of a tick overfills the machines at this capacity, so a window
# that starts full is throttled from its second tick on
CASES = {"tick0": (4e3, 1200.0), "mid": (4e3, float(LAMBDA)),
         "never": (1e12, float(LAMBDA))}


def _engine(keyword: bool, cap: float, *, window: int = 0, seed: int = 0,
            telemetry=None, plane=None, sanitize=False):
    """SWARM on the CPU plane over a hotspot with a query burst (range)
    or two trending terms (keyword), 2000 standing queries preloaded."""
    if keyword:
        wl = T.WorkloadSpec(query_model="spatial_keyword", term_buckets=8)
        scen = T.ScenarioSpec("hot_hashtags", ticks=24, preload_queries=2000,
                              query_burst=100, hot_terms=2, term_peak=0.4)
    else:
        wl = T.WorkloadSpec()
        scen = T.ScenarioSpec("uniform_normal", ticks=24,
                              preload_queries=2000, query_burst=200,
                              peak=0.6)
    cfg = T.EngineConfig(num_machines=M, cap_units=cap, lambda_max=LAMBDA,
                         mem_queries=10**8, round_every=2,
                         fused_window=window, telemetry=telemetry,
                         sanitize=sanitize)
    router = T.RouterSpec("swarm", beta=2).build(
        num_machines=M, workload=wl, data_plane=plane or T.TorchPlane("cpu"),
        seed=seed)
    eng = T.StreamingEngine(router, scen.build(seed=seed, workload=wl), cfg)
    router.ingest(eng.stream.preload(scen.preload_queries))
    return eng


def _window(eng, w: int, lam: float):
    """A window of ``w`` staged batches after four per-tick ticks (the
    plan has split, queues are loaded), the carry's λ set to ``lam``:
    the plane's arguments."""
    eng.run(4)
    eng.lam_bp = lam
    batches = [eng.stream.tuples(LAMBDA, eng.tick_no + i) for i in range(w)]
    xy = np.stack([bt.xy for bt in batches])
    kw = (np.stack([bt.buckets for bt in batches])
          if batches[0].buckets is not None else None)
    router, cfg = eng.router, eng.cfg
    host = router.fused_host_state()
    fp = T.FusedParams(cap_units=cfg.cap_units, lambda_max=cfg.lambda_max,
                       bp_high=cfg.bp_high, bp_dec=cfg.bp_dec,
                       bp_inc=cfg.bp_inc, alive=eng._eff_alive(),
                       track_stats=True, n_alloc=host.n_alloc)
    carry = T.EngineCarry(eng.queue_units.copy(), eng.queue_tuples.copy(),
                          eng.lam_bp)
    state = router.plane.make_state(host)
    state = state._replace(cn_rows=state.cn_rows + 1.0)   # prior deposits
    return state, router._cost_params(), fp, carry, xy, kw


def _close(got, want, rtol=1e-9, name="", scaled=False):
    """``got`` within ``rtol`` of ``want``, each element; ``scaled``: of
    the largest ``|want|`` (float32 sums leave residues near 0)."""
    want = np.asarray(want, np.float64)
    atol = rtol * float(np.abs(want).max(initial=0.0)) if scaled else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("keyword", [False, True])
def test_throttled_window_equals_the_per_tick_replay(keyword, case, w):
    cap, lam = CASES[case]
    eng = _engine(keyword, cap)
    state, cp, fp, carry, xy, kw = _window(eng, w, lam)
    plane = eng.router.plane
    before = [t.clone() if t is not None else None for t in state]
    new, got_carry, got, ok = plane.run_window_throttled(
        state, cp, fp, carry, xy, kw_stack=kw)
    assert ok is True
    stats = eng.router.swarm.stats
    n0 = (stats.rows[S.C_N].copy(), stats.cols[S.C_N].copy())
    want, _ = eng._window_reference(xy, kw)

    np.testing.assert_array_equal(got.injected, want.injected)
    if case == "tick0":
        assert want.injected[0] < LAMBDA
    elif case == "mid":
        assert want.injected[0] == LAMBDA
        assert w == 1 or want.injected[-1] < LAMBDA
    else:
        assert (want.injected == LAMBDA).all()
    # the N′ collector deltas, count for count
    p = new.cn_rows.shape[0]
    for dev, prior, bank, start in (
            (new.cn_rows, state.cn_rows, stats.rows, n0[0]),
            (new.cn_cols, state.cn_cols, stats.cols, n0[1])):
        np.testing.assert_array_equal((dev - prior).numpy(),
                                      (bank[S.C_N] - start)[:p])
        assert float((dev - prior).sum()) == float(want.injected.sum())
    for name in ("throughput", "latency", "utilization"):
        _close(getattr(got, name), getattr(want, name), name=name)
    if keyword:
        _close(got.deliveries, want.deliveries, name="deliveries")
        assert want.deliveries.sum() > 0
    else:
        assert got.deliveries is None
    _close(got_carry.queue_units, eng.queue_units, name="queue_units")
    _close(got_carry.queue_tuples, eng.queue_tuples, name="queue_tuples")
    assert got_carry.lam_bp == pytest.approx(eng.lam_bp, rel=1e-12)
    # the input state is never mutated
    for name, a, b in zip(state._fields, state, before):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)

    if case == "never":
        full_state, full_carry, full, full_ok = plane.run_window(
            state, cp, fp, carry, xy, kw_stack=kw)
        assert full_ok
        np.testing.assert_array_equal(got.injected, full.injected)
        torch.testing.assert_close(new.cn_rows, full_state.cn_rows,
                                   rtol=0, atol=0)
        torch.testing.assert_close(new.cn_cols, full_state.cn_cols,
                                   rtol=0, atol=0)
        for name in ("throughput", "latency", "utilization", "deliveries"):
            if getattr(full, name) is not None:
                _close(getattr(got, name), getattr(full, name), rtol=1e-5,
                       name=name, scaled=True)
        # float32 queues leave residues of the work a tick brings
        work = (float(full.utilization.max()) * fp.cap_units,
                float(full.throughput.max()))
        for a, b, scale in zip(got_carry[:2], full_carry[:2], work):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)


class _ReplayPlane(T.TorchPlane):
    """The CPU plane without a throttled window: the engine replays a
    declined window per tick on the host."""

    run_window_throttled = None


@pytest.mark.parametrize("keyword", [False, True])
def test_throttled_run_fused_equals_per_tick(keyword):
    """A SWARM run under backpressure, sanitized: every declined window
    runs on the plane, throttled.  The run injects what the per-tick loop
    does, and leaves the statistics and metrics of the fused run that
    replays its declined windows on the host (the per-tick loop draws a
    throttled tick's ``n`` tuples, a window stages ``λmax`` and takes
    their first ``n``: other tuples, so other statistics)."""
    cap = 3e3
    tick = _engine(keyword, cap)
    tick.run(24)
    replay = _engine(keyword, cap, window=8, plane=_ReplayPlane("cpu"))
    replay.run(24)
    eng = _engine(keyword, cap, window=8,
                  telemetry=T.TelemetryConfig(tick_spans=False),
                  sanitize=True)
    eng.run(24)
    # the sanitizer held each drain to the deposits the windows counted
    assert eng.san.stats["collector_drains"] > 0
    a, r, b = (e.metrics.asarrays() for e in (tick, replay, eng))
    assert min(a["injected"]) < LAMBDA           # throttling engaged
    for ref in (a, r):
        np.testing.assert_array_equal(b["injected"], ref["injected"])
        np.testing.assert_array_equal(b["transfers"], ref["transfers"])
    for bank in ("rows", "cols"):
        _close(getattr(eng.router.swarm.stats, bank),
               getattr(replay.router.swarm.stats, bank), rtol=1e-6,
               name=bank)
    for name in ("throughput", "latency", "utilization", "deliveries",
                 "units_of_work"):
        _close(b[name], r[name], rtol=1e-6, name=name, scaled=True)
    assert replay.declined_windows == eng.declined_windows
    assert replay.throttled_windows == 0
    wins = [e for e in eng.tracer.events
            if e.kind == "span" and e.name == "fused_window"]
    declined = [e for e in wins if e.args["ok"] is False]
    assert declined
    assert eng.throttled_windows == eng.declined_windows == len(declined)
    assert max(e.args["throttled"] for e in wins) == len(declined)
    assert any(e.args["skipped"] for e in declined)
    assert not any(e.args["skipped"] for e in wins if e.args["ok"])
