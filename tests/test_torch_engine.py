"""The PyTorch port's streaming main path end to end
(``repro_torch.streaming.run`` → ``StreamingEngine`` → ``SwarmRouter``
→ ``TorchPlane``) against the JAX package on the ``tests/test_fused.py``
timeline: per-tick and fused runs against ``data_plane="jax"``, fused ≡
per-tick on the port, the backpressure decline-and-replay path (and the
rule that a declined window leaves the resident state untouched),
window-size invariance, a machine failure at a window boundary, and one
sanitized run.  The torch side runs on the CPU (``"torch-cpu"``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.streaming as J  # noqa: E402
import repro_torch.streaming as T  # noqa: E402
from repro_torch.kernels import stats_update as SU  # noqa: E402

G, M = 64, 8


def _cfg(mod, **kw):
    # capacity high enough that backpressure stays idle (the fused
    # window's staging semantics; see tests/test_fused.py)
    base = dict(num_machines=M, cap_units=1e9, lambda_max=2000,
                mem_queries=10**8, round_every=3)
    base.update(kw)
    return mod.EngineConfig(**base)


# ticks=12 ⇒ hotspot query burst at ticks 4–7 (arrival boundaries) and
# rounds at 3, 6, 9 — rounds inside scan windows (no plan change yet);
# the "rebalancing" timeline is longer, with a stronger hotspot and a
# livelier FSM, so rounds do move partitions
TIMELINES = {
    "fused": (dict(ticks=12, preload_queries=500, query_burst=200), 4, {}),
    "rebalancing": (dict(ticks=24, preload_queries=500, query_burst=200,
                         peak=0.6), 2, dict(round_every=2)),
}


def _run(mod, plane, *, window=0, seed=0, timeline="fused", **cfg):
    scen, beta, extra = TIMELINES[timeline]
    c = _cfg(mod, **{**extra, **cfg})
    if window:
        c = dataclasses.replace(c, fused_window=window)
    return mod.run(mod.Experiment(
        router=mod.RouterSpec("swarm", beta=beta),
        scenario=mod.ScenarioSpec("uniform_normal", **scen), engine=c,
        data_plane=plane, seed=seed))


EXACT = ("injected", "q_total", "transfers")
CLOSE = ("units_of_work", "throughput", "latency", "utilization",
         "wire_bytes", "migration_bytes")


def _assert_parity(ref, got, rtol=1e-3):
    for name in EXACT:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in CLOSE:
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(ref[name], np.float64),
                                   rtol=rtol, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# End to end against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timeline", ["fused", "rebalancing"])
@pytest.mark.parametrize("window", [0, 8])
def test_end_to_end_matches_jax_plane(window, timeline):
    ref = _run(J, "jax", window=window, timeline=timeline)
    got = _run(T, "torch-cpu", window=window, timeline=timeline)
    a, b = ref.metrics.asarrays(), got.metrics.asarrays()
    _assert_parity(a, b)
    if timeline == "rebalancing":
        assert sum(b["transfers"]) > 0            # rounds moved partitions
    # both systems closed the same rounds with the same decisions
    assert [r.decision for r in got.router.swarm.reports] == \
        [r.decision for r in ref.router.swarm.reports]
    np.testing.assert_array_equal(got.router.index.cell_to_partition,
                                  ref.router.index.cell_to_partition)


def test_round_closes_go_through_the_kernel_wrapper(monkeypatch):
    calls, lives = [], []
    real = SU.close_round_inputs
    real_close = T.TorchPlane.close_round

    def spy(bank6, decay=0.5):
        calls.append(tuple(bank6.shape))
        return real(bank6, decay)

    def close_spy(self, stats, decay, live):
        lives.append(len(live))
        return real_close(self, stats, decay, live)

    monkeypatch.setattr(SU, "close_round_inputs", spy)
    monkeypatch.setattr(T.TorchPlane, "close_round", close_spy)
    res = _run(T, "torch-cpu", window=8, timeline="rebalancing")
    rounds = res.router.swarm.round_no
    assert rounds > 0 and len(calls) == rounds
    # rows and cols of the live partitions stacked, no padding rows:
    # (6, 2·live, G+1)
    assert calls == [(6, 2 * n, G + 1) for n in lives]


def test_sweep_defaults_to_the_card():
    specs = T.sweep(seeds=(0, 1))
    assert specs and all(e.data_plane == "torch" for e in specs)
    assert T.Experiment().data_plane == "torch"
    host = T.sweep(data_planes=("torch-cpu", "numpy"))
    assert [e.data_plane for e in host] == ["torch-cpu", "numpy"]
    if not torch.cuda.is_available():
        # the host planes are chosen explicitly, never by falling back
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            T.run(specs[0])


def test_numpy_plane_of_the_port_matches_the_jax_package_numpy_plane():
    a = _run(J, "numpy", window=8).metrics.asarrays()
    b = _run(T, "numpy", window=8).metrics.asarrays()
    for name in a:
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)


@pytest.mark.parametrize("seed", [0, 2])
def test_fused_matches_per_tick_on_the_port(seed):
    a = _run(T, "torch-cpu", seed=seed).metrics.asarrays()
    b = _run(T, "torch-cpu", window=8, seed=seed).metrics.asarrays()
    _assert_parity(a, b)


def test_keyword_workload_fused_matches_jax_plane():
    wl = dict(query_model="spatial_keyword", term_buckets=8)
    out = {}
    for mod, plane in ((J, "jax"), (T, "torch-cpu")):
        c = dataclasses.replace(_cfg(mod), fused_window=8)
        out[plane] = mod.run(mod.Experiment(
            router=mod.RouterSpec("swarm", beta=4),
            scenario=mod.ScenarioSpec("hot_hashtags", ticks=12,
                                      preload_queries=400, query_burst=100),
            workload=mod.WorkloadSpec(**wl), engine=c, data_plane=plane,
            seed=1)).metrics.asarrays()
    _assert_parity(out["jax"], out["torch-cpu"])
    np.testing.assert_allclose(out["torch-cpu"]["deliveries"],
                               out["jax"]["deliveries"], rtol=1e-3, atol=1e-6)
    assert np.asarray(out["torch-cpu"]["deliveries"]).sum() > 0


# ---------------------------------------------------------------------------
# Backpressure: the window declines and the engine replays it
# ---------------------------------------------------------------------------

def test_backpressure_declines_and_replays():
    # tiny capacity: backpressure throttles injection mid-run, the
    # optimistic window declines (ok=False) and the engine replays the
    # staged batches through StreamingEngine._window_reference
    ref = _run(T, "torch-cpu", cap_units=3e3).metrics.asarrays()
    fused = _run(T, "torch-cpu", window=8, cap_units=3e3).metrics.asarrays()
    jx = _run(J, "jax", window=8, cap_units=3e3).metrics.asarrays()
    assert min(ref["injected"]) < 2000          # throttling engaged
    np.testing.assert_array_equal(fused["injected"], ref["injected"])
    np.testing.assert_array_equal(fused["q_total"], ref["q_total"])
    _assert_parity(jx, fused)
    for name in ("units_of_work", "throughput", "latency"):
        arr = np.asarray(fused[name], np.float64)
        assert np.isfinite(arr).all() and arr.shape == ref[name].shape
        np.testing.assert_allclose(arr.sum(), ref[name].sum(), rtol=0.2)


def test_declined_window_leaves_the_state_untouched():
    plane = T.get_plane("torch-cpu")
    router = T.SwarmRouter(G, M, beta=4, data_plane=plane)
    host = router.fused_host_state()
    state = plane.make_state(host)
    state = state._replace(cn_rows=state.cn_rows + 1.0)   # prior deposits
    before = [t.clone() if t is not None else None for t in state]
    xy = np.random.default_rng(0).uniform(0, 1, (4, 500, 2)).astype(
        np.float32)
    fp = T.FusedParams(cap_units=10.0, lambda_max=500.0, bp_high=2.0,
                       bp_dec=0.6, bp_inc=0.04, alive=np.ones(M),
                       track_stats=True, n_alloc=host.n_alloc)
    carry = T.EngineCarry(np.zeros(M), np.zeros(M), 500.0)
    new, _, outs, ok = plane.run_window(state, router._cost_params(), fp,
                                        carry, xy)
    assert not ok                                # throttled: declined
    assert outs.injected[0] == 500 and outs.injected[-1] < 500
    for name, a, b in zip(state._fields, state, before):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    # the declined window's deposits live only in the discarded state
    assert float(new.cn_rows.sum() - state.cn_rows.sum()) == xy.shape[0] * 500


# ---------------------------------------------------------------------------
# Window-size invariance and a failure at a window boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_window_size_invariance(seed):
    """W is an execution-granularity knob, not a semantics knob (float32
    aggregation tolerance, as on the JAX plane)."""
    a = _run(T, "torch-cpu", window=1, seed=seed,
             timeline="rebalancing").metrics.asarrays()
    b = _run(T, "torch-cpu", window=32, seed=seed,
             timeline="rebalancing").metrics.asarrays()
    for name in a:
        np.testing.assert_allclose(np.asarray(a[name], np.float64),
                                   np.asarray(b[name], np.float64),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_machine_failure_at_window_boundary():
    def drive(mod, plane, fused: bool):
        src = mod.scenario("none", horizon=40, seed=2)
        r = mod.SwarmRouter(G, M, beta=4, data_plane=plane)
        eng = mod.StreamingEngine(r, src, _cfg(mod))
        eng.preload_queries(src.sample_queries(400))
        go = (lambda t: eng.run_fused(t, window=8)) if fused else eng.run
        go(8)
        eng.fail_machine(3)
        go(8)
        return eng

    a, b = drive(T, "torch-cpu", False), drive(T, "torch-cpu", True)
    j = drive(J, "jax", True)
    assert len(b.router.swarm.index.machine_partitions(3)) == 0
    ka, kb, kj = (e.metrics.asarrays() for e in (a, b, j))
    np.testing.assert_array_equal(ka["injected"], kb["injected"])
    for ref in (ka, kj):
        for name in ("units_of_work", "throughput", "utilization"):
            np.testing.assert_allclose(np.asarray(kb[name], np.float64),
                                       np.asarray(ref[name], np.float64),
                                       rtol=1e-3, atol=1e-6, err_msg=name)
    # the dead machine takes no further work
    assert np.asarray(kb["utilization"])[-4:, 3].max() == 0.0


def test_sanitized_run(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    res = _run(T, "torch-cpu", window=8)
    san = res.sanitizer_stats
    assert san is not None
    assert san["collector_drains"] > 0 and san["rounds"] > 0
    assert san["ticks"] > 0 and san["covers"] > 0


# ---------------------------------------------------------------------------
# Elastic membership and the geo fault model (the tests/test_elasticity.py
# and tests/test_faults.py timelines), fused, against the JAX plane
# ---------------------------------------------------------------------------

def _membership_exp(mod, plane):
    timeline = (mod.MembershipEvent(9, "fail", 3),
                mod.MembershipEvent(17, "join", 9),
                mod.MembershipEvent(23, "slow", 5, 0.5))
    cfg = mod.EngineConfig(num_machines=10, cap_units=1e9, lambda_max=2000,
                           mem_queries=10**8, round_every=3,
                           standby_machines=1, fused_window=8)
    return mod.Experiment(
        router=mod.RouterSpec("swarm", beta=4),
        scenario=mod.ScenarioSpec("uniform_normal", ticks=30,
                                  preload_queries=400, query_burst=150,
                                  membership=timeline),
        engine=cfg, data_plane=plane)


def _geo_exp(mod, ft, plane):
    m = 8
    chaos = ft.ChaosSpec(seed=2, ticks=60, drop_beats=0.05, delay_beats=0.1,
                         partitions=1, partition_len=4, interrupts=2)
    links = ft.two_region(m, inter_ms=25.0, jitter_ms=10.0, tick_ms=10.0,
                          seed=1)
    return mod.Experiment(
        router=mod.RouterSpec("swarm", link_aware=True, trend_window=6),
        scenario=mod.ScenarioSpec("two_overlapping", ticks=60,
                                  preload_queries=1500, chaos=chaos),
        engine=mod.EngineConfig(num_machines=m, links=links,
                                adaptive_detector=True, fused_window=8),
        data_plane=plane)


@pytest.mark.parametrize("timeline", ["membership", "geo"])
def test_elastic_and_geo_timelines_match_jax_plane(timeline):
    import repro.ft as jft
    import repro_torch.ft as tft
    if timeline == "membership":
        ref = J.run(_membership_exp(J, "jax"))
        got = T.run(_membership_exp(T, "torch-cpu"))
    else:
        ref = J.run(_geo_exp(J, jft, "jax"))
        got = T.run(_geo_exp(T, tft, "torch-cpu"))
    a, b = ref.metrics.asarrays(), got.metrics.asarrays()
    _assert_parity(a, b)
    for name in ("alive", "cap_factor", "retried_transfers",
                 "aborted_transfers", "false_suspicions"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    assert sum(b["transfers"]) > 0
