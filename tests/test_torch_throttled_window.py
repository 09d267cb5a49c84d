"""``run_window`` on the CPU torch planes (``TorchPlane("cpu")`` and
``ShardedTorchPlane(4, "cpu")``) under backpressure: a fused window
against the reference plane's window (``NumpyPlane.run_window``) on the
same staged batches from the same carry, for range and keyword
workloads, throttled from the first tick, from a later tick or never,
over windows of 1, 3 and 8 ticks; the throttled body of a never-throttled
window against the full-batch body; and a throttled SWARM run, fused
against per-tick and against the fused reference plane, end to end."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.streaming as T  # noqa: E402

M, LAMBDA = 8, 2000
# capacity (units a machine and tick) and the carry's λ of each case: the
# batch of a tick overfills the machines at this capacity, so a window
# that starts full is throttled from its second tick on
CASES = {"tick0": (4e3, 1200.0), "mid": (4e3, float(LAMBDA)),
         "never": (1e12, float(LAMBDA))}
PLANES = {"torch-cpu": lambda: T.TorchPlane("cpu"),
          "sharded-cpu": lambda: T.ShardedTorchPlane(4, "cpu")}


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
    the plane's arguments, and the host snapshot of its state."""
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
    state = _prior(router.plane.make_state(host))
    return state, router._cost_params(), fp, carry, xy, kw, host


def _prior(state):
    """``state`` with one prior deposit in every collector slot."""
    if isinstance(state.cn_rows, tuple):             # the sharded banks
        return state._replace(cn_rows=tuple(b + 1.0 for b in state.cn_rows))
    return state._replace(cn_rows=state.cn_rows + 1.0)


def _leaves(x) -> list:
    """The tensors and arrays of a (nested) plane state."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


def _snapshot(state) -> list:
    return [a.clone() if isinstance(a, torch.Tensor) else a.copy()
            for a in _leaves(state)]


def _assert_untouched(state, before):
    after = _leaves(state)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def _deltas(plane, new, old):
    """The N′ collector deltas of a window, (P, G+1) rows and columns in
    partition order."""
    return [a - b for a, b in zip(plane.collector_banks(new),
                                  plane.collector_banks(old))]


def _close(got, want, rtol=1e-9, name="", scaled=False):
    """``got`` within ``rtol`` of ``want``, each element; ``scaled``: of
    the largest ``|want|`` (float32 sums leave residues near 0)."""
    want = np.asarray(want, np.float64)
    atol = rtol * float(np.abs(want).max(initial=0.0)) if scaled else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("plane_name", list(PLANES))
@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("keyword", [False, True])
def test_throttled_window_equals_the_per_tick_replay(keyword, case, w,
                                                     plane_name):
    cap, lam = CASES[case]
    eng = _engine(keyword, cap, plane=PLANES[plane_name]())
    state, cp, fp, carry, xy, kw, host = _window(eng, w, lam)
    plane = eng.router.plane
    before = _snapshot(state)
    new, got_carry, got, ok = plane.run_window(state, cp, fp, carry, xy,
                                               kw_stack=kw)
    ref = T.NumpyPlane()
    ref_state = _prior(ref.make_state(host))
    ref_prior = [a.copy() for a in (ref_state.cn_rows, ref_state.cn_cols)]
    ref_state, want_carry, want, _ = ref.run_window(
        ref_state, cp, fp, carry, xy, kw_stack=kw)

    np.testing.assert_array_equal(got.injected, want.injected)
    assert ok == bool((want.injected == LAMBDA).all())  # the full batch held
    if case == "tick0":
        assert want.injected[0] < LAMBDA
    elif case == "mid":
        assert want.injected[0] == LAMBDA
        assert w == 1 or want.injected[-1] < LAMBDA
    else:
        assert (want.injected == LAMBDA).all()
    # the N′ collector deltas, count for count
    p = len(host.owner)
    for delta, bank, prior in zip(
            _deltas(plane, new, state),
            (ref_state.cn_rows, ref_state.cn_cols), ref_prior):
        np.testing.assert_array_equal(delta, (bank - prior)[:p])
        assert float(delta.sum()) == float(want.injected.sum())
    for name in ("throughput", "latency", "utilization"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-5,
               name=name, scaled=True)
    if keyword:
        _close(got.deliveries, want.deliveries, rtol=1e-5,
               name="deliveries", scaled=True)
        assert want.deliveries.sum() > 0
    else:
        assert got.deliveries is None
    # the carry within 1e-5 of its largest value, or of the work a tick
    # brings where the queues drained (float32 queues leave residues)
    work = (float(want.utilization.max()) * fp.cap_units,
            float(want.throughput.max()))
    for name, scale in zip(("queue_units", "queue_tuples"), work):
        a, b = getattr(got_carry, name), getattr(want_carry, name)
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5 * max(scale, np.abs(b).max()),
            err_msg=name)
    assert got_carry.lam_bp == pytest.approx(want_carry.lam_bp, rel=1e-5)
    # the input state is never mutated
    _assert_untouched(state, before)

    if case == "never":
        # the throttled body where the full batch holds: what the
        # full-batch body (``run_window`` above) returned
        thr_state, thr_carry, thr, thr_ok = plane._throttled_window(
            state, cp, fp, carry, xy, kw_stack=kw)
        assert ok and not thr_ok
        np.testing.assert_array_equal(thr.injected, got.injected)
        for a, b in zip(plane.collector_banks(thr_state),
                        plane.collector_banks(new)):
            np.testing.assert_array_equal(a, b)
        for name in ("throughput", "latency", "utilization", "deliveries"):
            if getattr(got, name) is not None:
                _close(getattr(thr, name), getattr(got, name), rtol=1e-5,
                       name=name, scaled=True)
        # float32 queues leave residues of the work a tick brings
        work = (float(got.utilization.max()) * fp.cap_units,
                float(got.throughput.max()))
        for a, b, scale in zip(thr_carry[:2], got_carry[:2], work):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
        _assert_untouched(state, before)


@pytest.mark.parametrize("keyword", [False, True])
def test_throttled_run_fused_equals_per_tick(keyword):
    """A SWARM run under backpressure, sanitized: every declined window
    runs on the plane, throttled.  The run injects what the per-tick loop
    does, and leaves the statistics and metrics of the same fused run on
    the reference plane (the per-tick loop draws a throttled tick's ``n``
    tuples, a window stages ``λmax`` and takes their first ``n``: other
    tuples, so other statistics)."""
    cap = 3e3
    tick = _engine(keyword, cap)
    tick.run(24)
    ref = _engine(keyword, cap, window=8, plane=T.NumpyPlane())
    ref.run(24)
    eng = _engine(keyword, cap, window=8,
                  telemetry=T.TelemetryConfig(tick_spans=False),
                  sanitize=True)
    eng.run(24)
    # the sanitizer held each drain to the deposits the windows counted
    assert eng.san.stats["collector_drains"] > 0
    a, r, b = (e.metrics.asarrays() for e in (tick, ref, eng))
    assert min(a["injected"]) < LAMBDA           # throttling engaged
    for want in (a, r):
        np.testing.assert_array_equal(b["injected"], want["injected"])
        np.testing.assert_array_equal(b["transfers"], want["transfers"])
    for bank in ("rows", "cols"):
        _close(getattr(eng.router.swarm.stats, bank),
               getattr(ref.router.swarm.stats, bank), rtol=1e-6,
               name=bank)
    for name in ("throughput", "latency", "utilization", "deliveries",
                 "units_of_work"):
        _close(b[name], r[name], rtol=1e-6, name=name, scaled=True)
    wins = [e for e in eng.tracer.events
            if e.kind == "span" and e.name == "fused_window"]
    declined = [e for e in wins if e.args["ok"] is False]
    assert declined
    assert eng.declined_windows == len(declined)
    assert max(e.args["declined"] for e in wins) == len(declined)
    assert any(e.args["skipped"] for e in declined)
    assert not any(e.args["skipped"] for e in wins if e.args["ok"])
