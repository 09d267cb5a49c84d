"""The PyTorch port on a CUDA card: kernels K1–K4 against their plain
versions (exact; K1's in-place entry on page-locked host banks too), one
K1 launch per round close, each bank array page-locked once, exact
window counts with TF32 enabled (ROADMAP F2), the exact-match API and
the main path on ``TorchPlane("cuda")`` against the port's own NumPy
reference plane, and the sharded plane's four shards on the card
against the CPU port;
kernels K5 and K6 against their plain versions (counts exact, attention
at the JAX package's tolerances) and the LM serving path through them
(smoke models against the CPU, jamba's and xlstm's recurrent mixers
included, qwen2-moe-a2.7b at full width with two layers against its
plain path); training through them: K6's backward
against the reference's attention twin, every attention weight's
gradient against the CPU's (F6), a train step against the CPU's, and a
stream checkpoint resumed on the card.  Every test here needs the card and
skips without one; the file imports nothing of JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.streaming as T  # noqa: E402
from repro_torch.core import statistics as S  # noqa: E402
from repro_torch.core.geometry import points_to_cells  # noqa: E402
from repro_torch.kernels import keyword_match as KM  # noqa: E402
from repro_torch.kernels import knn_match as KN  # noqa: E402
from repro_torch.kernels import spatial_match as SM  # noqa: E402
from repro_torch.kernels import stats_update as SU  # noqa: E402
from repro_torch.queries import TermHasher, bucket_masks  # noqa: E402

pytestmark = pytest.mark.cuda

# exact for the dyadic decays; rtol 1e-6 for 0.9 (one float32 rounding
# of N·decay + cumN, see tests/test_torch_stats_update.py)
DECAYS = [(1.0, 0.0), (0.5, 0.0), (0.9, 1e-6)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda")


def _bank6(seed, p, g1, device):
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 64, (6, p, g1)).astype(np.float32)
    bank[:3] += rng.uniform(0, 1, (3, p, g1)).astype(np.float32)
    return torch.from_numpy(bank).to(device)


@pytest.mark.parametrize("p,g1", [(256, 513), (2048, 1025), (3, 1),
                                  (130, 1000)])
@pytest.mark.parametrize("decay,rtol", DECAYS)
def test_kernel_matches_plain_version(cuda_device, p, g1, decay, rtol):
    bank6 = _bank6(p + g1, p, g1, cuda_device)
    before = SU.ops.launches
    got = SU.close_round_inputs(bank6, decay)
    torch.cuda.synchronize()
    assert SU.ops.launches == before + 1
    want = SU.close_round_inputs_ref(bank6, decay)
    torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)


def test_kernel_rejects_a_strided_bank(cuda_device):
    bank6 = _bank6(0, 8, 40, cuda_device)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        SU.close_round_inputs(bank6)


def test_round_close_launches_the_kernel_once(cuda_device):
    rng = np.random.default_rng(4)
    cap, g = 37, 24
    live = np.sort(rng.choice(cap, 17, replace=False))
    ref = S.StatsState.zeros(cap, g)
    ref.rows[:, live] = rng.integers(0, 50, (8, 17, g + 1)).astype(
        np.float32)
    ref.cols[:, live] = rng.integers(0, 50, (8, 17, g + 1)).astype(
        np.float32)
    got = ref.copy()
    before = SU.ops.launches
    T.TorchPlane("cuda").close_round(got, 0.5, live)
    assert SU.ops.launches == before + 1
    S.close_round(ref, 0.5)
    np.testing.assert_array_equal(got.rows[:, live], ref.rows[:, live])
    np.testing.assert_array_equal(got.cols[:, live], ref.cols[:, live])


def _host_banks(seed, cap, g1, n_live):
    """Both (8, cap, g1) banks filled everywhere, integer collectors with
    negative C_SPAN entries, and unsorted live ids."""
    rng = np.random.default_rng(seed)
    banks = []
    for _ in range(2):
        bank = rng.integers(0, 50, (8, cap, g1)).astype(np.float32)
        bank[:S.C_N] += rng.uniform(0, 1, (S.C_N, cap, g1)).astype(
            np.float32)
        bank[S.C_SPAN] -= 25.0
        banks.append(bank)
    return banks[0], banks[1], rng.permutation(cap)[:n_live]


def _pinned(arr):
    t = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
    t.copy_(torch.from_numpy(arr))
    return t


@pytest.mark.parametrize("cap,g1,n_live", [(256, 513, 66), (40, 1025, 17),
                                           (5, 1, 5), (300, 2100, 1)])
@pytest.mark.parametrize("decay", [0.5, 0.9, 1.0])
def test_in_place_entry_equals_close_live_ref(cuda_device, cap, g1, n_live,
                                              decay):
    # both sides round N·decay, then the sum, in float32: bit for bit
    rows, cols, live = _host_banks(cap + g1, cap, g1, n_live)
    got = [_pinned(rows), _pinned(cols)]
    before = SU.ops.launches
    SU.close_live(*got, live, decay, cuda_device)
    torch.cuda.synchronize()
    assert SU.ops.launches == before + 1
    want = [torch.from_numpy(rows), torch.from_numpy(cols)]
    SU.close_live_ref(*want, live, decay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_in_place_entry_refuses_pageable_banks(cuda_device):
    rows, cols, live = _host_banks(0, 8, 40, 3)
    with pytest.raises(ValueError, match="page-locked"):
        SU.close_live(torch.from_numpy(rows), torch.from_numpy(cols), live,
                      0.5, cuda_device)


def test_round_close_re_homes_each_bank_array_once(cuda_device):
    """The port's protocol on the card beside the same protocol on the
    CPU plane: one K1 launch a round close, equal banks before and after
    a growth that replaces the arrays, and each array page-locked once."""
    from repro_torch.core.protocol import Swarm
    rng = np.random.default_rng(6)
    card = Swarm(16, 4, data_plane=T.TorchPlane("cuda"))
    host = Swarm(16, 4, data_plane=T.TorchPlane("cpu"))

    def close_and_compare(rehomed):
        live = card.index.parts.live_ids()
        for bank in ("rows", "cols"):
            adds = rng.integers(-3, 9, (3, len(live), 17)).astype(np.float32)
            for sw in (card, host):
                getattr(sw.stats, bank)[S.C_N:, live] += adds
        before = SU.ops.launches
        for sw in (card, host):
            sw._close_stats()
        assert SU.ops.launches == before + 1
        assert card.plane.rehomed == rehomed
        for bank in ("rows", "cols"):
            arr = getattr(card.stats, bank)
            assert torch.from_numpy(arr).is_pinned()
            np.testing.assert_array_equal(arr, getattr(host.stats, bank))

    close_and_compare(2)
    close_and_compare(2)
    for sw in (card, host):
        sw.index.parts._grow()
        sw._sync_capacity()
    assert not torch.from_numpy(card.stats.rows).is_pinned()
    close_and_compare(4)
    close_and_compare(4)


def test_window_counts_exact_above_2048_with_tf32(cuda_device):
    g, m, w, b = 64, 8, 2, 6000
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 1, (w, b, 2)).astype(np.float32)
    xy[:, :2500] = rng.uniform(0.5, 0.5 + 0.9 / g, (w, 2500, 2))
    row, col = points_to_cells(xy[0], g)
    assert np.bincount(row * g + col).max() > 2048
    router = T.SwarmRouter(g, m, beta=4)
    host = router.fused_host_state()
    fp = T.FusedParams(cap_units=1e12, lambda_max=float(b), bp_high=2.0,
                       bp_dec=0.6, bp_inc=0.04, alive=np.ones(m),
                       track_stats=True, n_alloc=host.n_alloc)
    banks = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for plane in (T.TorchPlane("cuda"), T.get_plane("numpy")):
            carry = T.EngineCarry(np.zeros(m), np.zeros(m), float(b))
            st, _, _, ok = plane.run_window(plane.make_state(host),
                                            router._cost_params(), fp,
                                            carry, xy)
            assert ok
            banks.append(plane.collector_banks(st))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, c in zip(*banks):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("window", [0, 8])
def test_main_path_matches_the_numpy_plane(cuda_device, window):
    cfg = T.EngineConfig(num_machines=8, cap_units=1e9, lambda_max=2000,
                         mem_queries=10**8, round_every=2,
                         fused_window=window)
    out = {}
    for plane in ("numpy", "torch"):
        out[plane] = T.run(T.Experiment(
            router=T.RouterSpec("swarm", beta=2),
            scenario=T.ScenarioSpec("uniform_normal", ticks=24,
                                    preload_queries=500, query_burst=200,
                                    peak=0.6),
            engine=cfg, data_plane=plane)).metrics.asarrays()
    ref, got = out["numpy"], out["torch"]
    for name in ("injected", "q_total", "transfers"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    assert sum(got["transfers"]) > 0
    for name in ("units_of_work", "throughput", "latency", "utilization"):
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(ref[name], np.float64),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def test_declined_window_leaves_the_state_untouched(cuda_device):
    plane = T.TorchPlane("cuda")
    router = T.SwarmRouter(64, 8, beta=4)
    host = router.fused_host_state()
    state = plane.make_state(host)
    before = [t.clone() if t is not None else None for t in state]
    xy = np.random.default_rng(0).uniform(0, 1, (4, 500, 2)).astype(
        np.float32)
    fp = T.FusedParams(cap_units=10.0, lambda_max=500.0, bp_high=2.0,
                       bp_dec=0.6, bp_inc=0.04, alive=np.ones(8),
                       track_stats=True, n_alloc=host.n_alloc)
    carry = T.EngineCarry(np.zeros(8), np.zeros(8), 500.0)
    new, _, outs, ok = plane.run_window(state, router._cost_params(), fp,
                                        carry, xy)
    assert not ok
    for a, b in zip(state, before):
        if a is not None:
            assert torch.equal(a, b)
    # the throttled window's deposits live only in the returned banks
    for bank in (new.cn_rows, new.cn_cols):
        assert float(bank.sum()) == float(outs.injected.sum())


class _PricedOn(T.NumpyPlane):
    """The reference plane's per-tick window with each batch routed and
    priced by ``plane``'s per-call API, as the router prices a per-tick
    batch: the window's own arithmetic stays float64 on the host."""

    def __init__(self, plane):
        self._plane = plane

    def tuple_costs(self, *args):
        return self._plane.tuple_costs(*args)

    def keyword_costs(self, *args):
        return self._plane.keyword_costs(*args)


@pytest.mark.parametrize("lam", [1200.0, 2000.0])
@pytest.mark.parametrize("keyword", [False, True])
def test_throttled_window_equals_the_per_tick_replay(cuda_device, keyword,
                                                     lam):
    """``run_window`` under backpressure on the card against the
    reference plane's per-tick window, each batch priced on the card, of
    the same eight staged batches from the same carry (throttled from the
    first tick, or from the second): the same injected counts and N′
    collector deltas, count for count; the metrics and the carry within
    1e-9."""
    if keyword:
        wl = T.WorkloadSpec(query_model="spatial_keyword", term_buckets=8)
        scen = T.ScenarioSpec("hot_hashtags", ticks=24, preload_queries=2000,
                              query_burst=100, hot_terms=2, term_peak=0.4)
    else:
        wl = T.WorkloadSpec()
        scen = T.ScenarioSpec("uniform_normal", ticks=24,
                              preload_queries=2000, query_burst=200,
                              peak=0.6)
    cfg = T.EngineConfig(num_machines=8, cap_units=4e3, lambda_max=2000,
                         mem_queries=10**8, round_every=2)
    router = T.RouterSpec("swarm", beta=2).build(
        num_machines=8, workload=wl, data_plane=T.TorchPlane("cuda"))
    eng = T.StreamingEngine(router, scen.build(seed=0, workload=wl), cfg)
    router.ingest(eng.stream.preload(scen.preload_queries))
    eng.run(4)
    eng.lam_bp = lam
    batches = [eng.stream.tuples(2000, eng.tick_no + i) for i in range(8)]
    xy = np.stack([bt.xy for bt in batches])
    kw = np.stack([bt.buckets for bt in batches]) if keyword else None
    host = router.fused_host_state()
    fp = T.FusedParams(cap_units=cfg.cap_units, lambda_max=cfg.lambda_max,
                       bp_high=cfg.bp_high, bp_dec=cfg.bp_dec,
                       bp_inc=cfg.bp_inc, alive=eng._eff_alive(),
                       track_stats=True, n_alloc=host.n_alloc)
    carry = T.EngineCarry(eng.queue_units.copy(), eng.queue_tuples.copy(),
                          eng.lam_bp)
    cp = router._cost_params()
    new, got_carry, got, ok = router.plane.run_window(
        router.plane.make_state(host), cp, fp, carry, xy, kw_stack=kw)
    assert not ok
    ref = _PricedOn(router.plane)
    ref_state, want_carry, want, _ = ref.run_window(
        ref.make_state(host), cp, fp, carry, xy, kw_stack=kw)
    np.testing.assert_array_equal(got.injected, want.injected)
    assert want.injected[-1] < 2000
    p = new.cn_rows.shape[0]
    for dev, bank in ((new.cn_rows, ref_state.cn_rows),
                      (new.cn_cols, ref_state.cn_cols)):
        np.testing.assert_array_equal(dev.cpu().numpy(), bank[:p])
    names = ("throughput", "latency", "utilization") + (
        ("deliveries",) if keyword else ())
    for name, a, b in [(n, getattr(got, n), getattr(want, n)) for n in names
                       ] + [(n, getattr(got_carry, n), getattr(want_carry, n))
                            for n in ("queue_units", "queue_tuples",
                                      "lam_bp")]:
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=name)


# tests/test_sharded.py's timelines, built from either package (the
# port's, or the JAX package's in tests/test_torch_sharded.py, which
# imports these helpers): low capacity so backpressure engages, rounds
# inside the fused window cadence and a kill/join pair mid-run (a
# rebalance transfer, a membership recovery and several window
# boundaries); "rebalance-idle" the same with backpressure idle; the
# keyword timeline at the pub/sub grid's cadence with backpressure idle
SHARD_G, SHARD_M = 16, 8
EXACT = ("injected", "q_total", "transfers", "migration_bytes",
         "moved_tuples", "wire_bytes")


def _timeline(pkg, name: str, devices: int = 0):
    if name.startswith("rebalance"):
        cap = 1e9 if name == "rebalance-idle" else 3e3
        cfg = pkg.EngineConfig(num_machines=SHARD_M, cap_units=cap,
                               lambda_max=2000, mem_queries=10**8,
                               round_every=8, fused_window=8,
                               devices=devices)
        scen = pkg.ScenarioSpec(
            "normal_normal", ticks=48, preload_queries=800, query_burst=200,
            peak=0.6, membership=(pkg.MembershipEvent(20, "fail", 3),
                                  pkg.MembershipEvent(34, "join", 3)))
        return scen, cfg, None
    cfg = pkg.EngineConfig(num_machines=SHARD_M, cap_units=1e9,
                           lambda_max=2000, mem_queries=10**8,
                           round_every=8, fused_window=8, devices=devices)
    scen = pkg.ScenarioSpec("hot_hashtags", ticks=24, preload_queries=400,
                            query_burst=100, hot_terms=2, term_peak=0.4)
    return scen, cfg, pkg.WorkloadSpec(query_model="spatial_keyword")


def _drive(pkg, plane, name="rebalance"):
    """The timeline through ``StreamingEngine`` with a given plane
    instance (as ``tests/test_sharded.py``'s reshard test drives it)."""
    scen, cfg, wl = _timeline(pkg, name)
    src = scen.build(seed=0, workload=wl)
    router = pkg.RouterSpec("swarm", grid_size=SHARD_G, beta=4).build(
        num_machines=SHARD_M, workload=wl, data_plane=plane, seed=0)
    eng = pkg.StreamingEngine(router, src, cfg)
    preload = eng.stream.preload(scen.preload_queries)
    if preload is not None:
        router.ingest(preload)
    return eng.run(scen.ticks).asarrays()


def _banks(x) -> np.ndarray:
    """(D, S, G+1) banks from either package's state."""
    if isinstance(x, tuple):
        return np.stack([t.cpu().numpy() for t in x])
    return np.asarray(x)


def _record(plane, log: list) -> None:
    """Log the slot layout and both bank stacks after every accepted
    window of ``plane`` (a fresh instance: the hook is an attribute)."""
    run_window = plane.run_window

    def recorded(*args, **kw):
        out = run_window(*args, **kw)
        if out[3]:
            st = out[0]
            log.append((np.asarray(st.slot_pid), _banks(st.cn_rows),
                        _banks(st.cn_cols)))
        return out

    plane.run_window = recorded


def _assert_parity(ref: dict, got: dict, rtol=1e-3):
    for name in ref:
        a = np.asarray(ref[name], np.float64)
        b = np.asarray(got[name], np.float64)
        if name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6,
                                       err_msg=name)


# "rebalance" declines every window (backpressure, replayed per tick);
# "rebalance-idle" keeps backpressure idle, so its windows carry the
# slot banks
@pytest.mark.parametrize("name", ["rebalance", "rebalance-idle"])
def test_four_shards_on_the_card_match_the_cpu_port(cuda_device, name):
    card = T.ShardedTorchPlane(4, "cuda", colocate=True)
    cpu = T.ShardedTorchPlane(4, "cpu")
    got_log, ref_log = [], []
    _record(card, got_log)
    _record(cpu, ref_log)
    got, ref = _drive(T, card, name), _drive(T, cpu, name)
    _assert_parity(ref, got)
    billed = int(sum(got["migration_bytes"]))
    assert card.reshard_bytes_total == cpu.reshard_bytes_total == billed > 0
    assert len(got_log) == len(ref_log) == (0 if name == "rebalance" else 9)
    for g_, r in zip(got_log, ref_log):
        for a, b in zip(g_, r):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K2–K4 and the exact-match API
# ---------------------------------------------------------------------------

def _points_rects(seed, n, q):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    c = rng.uniform(0, 0.9, (q, 2))
    rects = np.concatenate([c, c + rng.uniform(0.005, 0.2, (q, 2))],
                           1).astype(np.float32)
    pts[: min(n, q)] = rects[: min(n, q), :2]      # points on rect borders
    return pts, rects


def _masks(seed, n, q, t):
    rng = np.random.default_rng(seed)
    pm = (rng.random((n, t)) < 0.5).astype(np.float32)
    sm = (rng.random((q, t)) < 2.0 / t).astype(np.float32)
    sm[::7] = 0.0                                  # wildcard subscriptions
    return pm, sm


def _dev(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("n,q", [(1, 1), (7, 130), (513, 256), (4096, 1000),
                                 (20000, 70000)])
def test_spatial_match_kernel_equals_plain_version(cuda_device, n, q):
    pts, rects = _dev(cuda_device, *_points_rects(n + q, n, q))
    before = SM.ops.launches
    got = SM.spatial_match(pts, rects)
    torch.cuda.synchronize()
    assert SM.ops.launches == before + 1
    for a, b in zip(got, SM.spatial_match_ref(pts, rects)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("t", [1, 11, 32, 33, 100])
@pytest.mark.parametrize("n,q", [(300, 2000), (5000, 3000)])
def test_keyword_match_kernel_equals_plain_version_with_tf32(cuda_device, n,
                                                            q, t):
    pts, rects = _points_rects(n + t, n, q)
    pm, sm = _masks(t, n, q, t)
    args = _dev(cuda_device, pts, pm, rects, sm)
    before = KM.ops.launches
    got = KM.keyword_match(*args)
    torch.cuda.synchronize()
    assert KM.ops.launches == before + 1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        want = KM.keyword_match_ref(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    spatial = SM.spatial_match(args[0], args[2])[0]
    assert bool((got[0] <= spatial).all()) and int(got[0].sum()) > 0


def _edge_inputs(seed, n, q, t):
    """Points on every edge and corner of the first rects, signed zeros
    on both sides, rects with upper edges at +inf and empty rects (lo >
    hi); masks of t buckets, every fourth subscription a wildcard."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 1.0, (n, 2)).astype(np.float32)
    c = rng.uniform(-0.1, 0.9, (q, 2))
    rects = np.concatenate([c, c + rng.uniform(0.05, 0.5, (q, 2))],
                           1).astype(np.float32)
    k = np.arange(min(n, q))
    pts[k, 0] = np.where(k % 2 == 0, rects[k, 0], rects[k, 2])
    pts[k, 1] = np.where(k % 4 < 2, rects[k, 1], rects[k, 3])
    pts[5::11, 0], pts[6::11, 1] = -0.0, 0.0
    rects[4::9, 0], rects[5::9, 3] = 0.0, -0.0
    rects[2::7, 2:] = np.inf
    rects[3::7, 0] = rects[3::7, 2] + 0.1
    pm = (rng.random((n, t)) < min(0.5, 8.0 / t)).astype(np.float32)
    sm = (rng.random((q, t)) < 2.0 / t).astype(np.float32)
    sm[::4] = 0.0
    return pts, pm, rects, sm


K3_EDGE_N = [1, 255, 257,
             KM.ops.THREADS * KM.ops.MULTI_WORD_TUPLES_PER_THREAD + 1,
             KM.ops.THREADS * KM.ops.TUPLES_PER_THREAD + 1]
K3_EDGE_Q = [1, 31, 33, KM.ops.CHUNK + 1]


@pytest.mark.parametrize("t", [1, 31, 32, 33, 4096])
@pytest.mark.parametrize("q", K3_EDGE_Q)
@pytest.mark.parametrize("n", K3_EDGE_N)
def test_keyword_match_kernel_at_its_edges(cuda_device, n, q, t):
    """K3 equals its plain version at the edges of a tile (n = 1, 255,
    257, 256·R + 1 for the R of one mask word and of more) and of a chunk (q = 1, 31, 33, one
    chunk + 1), on borders, signed zeros, +inf upper edges (padding must
    not count) and empty rects, at T = 1 … 4096; all-zero subscription
    masks give K2."""
    pts, pm, rects, sm = _dev(cuda_device, *_edge_inputs(n + q + t, n, q, t))
    before = KM.ops.launches
    got = KM.keyword_match(pts, pm, rects, sm)
    torch.cuda.synchronize()
    assert KM.ops.launches == before + 1
    for a, b in zip(got, KM.keyword_match_ref(pts, pm, rects, sm)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    wild = KM.keyword_match(pts, pm, rects, torch.zeros_like(sm))
    for a, b, c in zip(wild, SM.spatial_match(pts, rects),
                       SM.spatial_match_ref(pts, rects)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(wild[0].sum()) > 0


@pytest.mark.parametrize("target", [1, 7, KM.ops.TARGET_BLOCKS])
@pytest.mark.parametrize("t", [32, 100])
def test_keyword_match_kernel_walks_chunks_in_groups(cuda_device, t,
                                                     target):
    """The shipped build at its R for one mask word and for four, over
    several tiles (9000 tuples) and 40 chunks of subscriptions, its grid
    aimed at one block (each block walks all 40 chunks through the
    cp.async ring), at 7 (groups of 20 chunks) and at the shipped target
    (one chunk a block): equal to the plain version."""
    pts, pm, rects, sm = _dev(cuda_device,
                              *_edge_inputs(t + target, 9000, 20000, t))
    r = KM.ops.tuples_per_thread(t)
    tiles, groups, per = KM.ops.geometry(9000, 20000, r, target)
    assert groups * per >= 40 and (target > 7 or per >= 20)
    got = KM.ops.launch(KM.ops.build(), r, target, pts, pm, rects, sm)
    for a, b in zip(got, KM.keyword_match_ref(pts, pm, rects, sm)):
        assert torch.equal(a, b)
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 12, 16, 17, 24, 32])
@pytest.mark.parametrize("n,q", [(16, 5), (40, 5), (3000, 700),
                                 (50000, 20000)])
def test_knn_match_kernel_equals_plain_version(cuda_device, n, q, k):
    """Bit for bit at every list length (past 16 the lists are 24 or 32
    long and the first k are kept), with N below one tile and one
    split, and at shapes the launch splits over the points (scratch)."""
    if k > n:
        pytest.skip(f"k={k} needs N >= k")
    rng = np.random.default_rng(n + q + k)
    pts, foci = _dev(cuda_device, rng.uniform(0, 1, (n, 2)).astype(np.float32),
                     rng.uniform(0, 1, (q, 2)).astype(np.float32))
    pts[: n // 3] = pts[n // 3: 2 * (n // 3)]       # duplicate points
    split = KN.ops.build()[1](n, q, k) > 0
    assert split == (n >= 3000)
    before, by_kernel = KN.ops.launches, dict(KN.ops.launches_by_kernel)
    got = KN.knn_match(pts, foci, k=k)
    torch.cuda.synchronize()
    assert KN.ops.launches == before + 1 + split
    assert {name: c - by_kernel[name] for name, c in
            KN.ops.launches_by_kernel.items()} == {
        "knn_match_kernel": 1, "knn_merge_kernel": int(split)}
    assert torch.equal(got, KN.knn_match_ref(pts, foci, k))


def test_knn_match_rejects_k_above_its_range_on_the_card(cuda_device):
    pts = torch.zeros((40, 2), device=cuda_device)
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        KN.knn_match(pts, pts, k=33)
    with pytest.raises(ValueError, match="batch of 5"):
        KN.knn_match(pts[:5], pts, k=8)


def test_kernels_take_offset_views(cuda_device):
    """A view that starts between vector-width rows is realigned by the
    wrappers, not read misaligned by the kernels."""
    pts, rects = _points_rects(3, 300, 200)
    flat = torch.from_numpy(np.concatenate([[0.0], pts.ravel()]).astype(
        np.float32)).to(cuda_device)
    view = flat[1:].view(300, 2)
    rect_t = _dev(cuda_device, rects)[0]
    for a, b in zip(SM.spatial_match(view, rect_t),
                    SM.spatial_match_ref(view, rect_t)):
        assert torch.equal(a, b)
    assert torch.equal(KN.knn_match(view, view[:50], k=4),
                       KN.knn_match_ref(view, view[:50], 4))


def test_exact_match_api_on_the_card_matches_the_numpy_plane(cuda_device):
    rng = np.random.default_rng(3)
    pts, rects = _points_rects(3, 4000, 1500)
    h = TermHasher(32)
    pm = bucket_masks(h.buckets(rng.integers(0, 60, (4000, 3))), 32)
    sm = h.sub_masks(rng.integers(0, 60, (1500, 2)))
    foci = rng.uniform(0, 1, (300, 2)).astype(np.float32)
    card, ref = T.TorchPlane("cuda"), T.NumpyPlane()
    knn_calls = KN.ops.launches_by_kernel               # one a call
    before = (SM.ops.launches, KM.ops.launches,
              knn_calls["knn_match_kernel"])
    for a, b in zip(card.match_counts(pts, rects),
                    ref.match_counts(pts, rects)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(card.keyword_match_counts(pts, pm, rects, sm),
                    ref.keyword_match_counts(pts, pm, rects, sm)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(card.knn_distances(pts, foci, k=8),
                                  ref.knn_distances(pts, foci, k=8))
    assert (SM.ops.launches, KM.ops.launches,
            knn_calls["knn_match_kernel"]) == tuple(x + 1 for x in before)


# ---------------------------------------------------------------------------
# K5 moe_histogram and K6 flash_attention against their plain versions
# ---------------------------------------------------------------------------

def _assignments(seed, t, k, e, device, pad=0.1):
    """(t, k) expert ids with a share ``pad`` of −1 padding, and gates."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, e, (t, k)).astype(np.int32)
    idx[rng.random((t, k)) < pad] = -1
    gates = rng.uniform(0, 1, (t, k)).astype(np.float32)
    return _dev(device, idx, gates)


@pytest.mark.parametrize("t,k,e", [(1, 1, 4), (256, 4, 60), (300, 4, 60),
                                   (65536, 4, 60), (65536, 6, 64),
                                   (4097, 2, 300), (5000, 8, 4096)])
def test_moe_histogram_kernel_equals_plain_version(cuda_device, t, k, e):
    """Counts exact; load within rtol 1e-5 (another summation order) and
    identical across two launches."""
    from repro_torch.kernels import moe_histogram as MH
    idx, gates = _assignments(t + e, t, k, e, cuda_device)
    before = MH.ops.launches
    counts, load = MH.moe_histogram(idx, gates, num_experts=e)
    again = MH.moe_histogram(idx, gates, num_experts=e)[1]
    torch.cuda.synchronize()
    assert MH.ops.launches == before + 2
    want_c, want_l = MH.moe_histogram_ref(idx, gates, e)
    assert torch.equal(counts, want_c)
    assert float(counts.sum()) == int((idx >= 0).sum())
    torch.testing.assert_close(load, want_l, rtol=1e-5, atol=1e-5)
    assert torch.equal(load, again)


def _order(idx, gates, e):
    from repro_torch.kernels.moe_histogram.order import moe_histogram_order
    return [torch.from_numpy(a).to(idx.device) for a in
            moe_histogram_order(idx.cpu().numpy(), gates.cpu().numpy(), e)]


def _hist_chunk(e):
    """The most assignments one block takes at E = e (one step a warp)."""
    from repro_torch.kernels import moe_histogram as MH
    return MH.ops.geometry(1 << 20, e)[0] * 32


@pytest.mark.parametrize("e", [1, 60, 64, 256, 257, 4096])
@pytest.mark.parametrize("n", [1, 200, 204_800, "chunk+1"])
def test_moe_histogram_kernel_at_its_edges(cuda_device, n, e):
    """One launch a call at n = 1, 200 (a decode call), 204 800 (a
    prefill) and one block's chunk + 1 (the smallest ticket pass), E = 1
    … 4096: counts equal the plain version's, the load is within rtol
    1e-5 of it and equal bit for bit to the kernel's written-out order
    (order.py), ten launches give the same bits."""
    from repro_torch.kernels import moe_histogram as MH
    n = _hist_chunk(e) + 1 if n == "chunk+1" else n
    k = 4 if n % 4 == 0 else 1
    idx, gates = _assignments(n + e, n // k, k, e, cuda_device)
    before = MH.ops.launches
    outs = [MH.moe_histogram(idx, gates, num_experts=e) for _ in range(10)]
    torch.cuda.synchronize()
    assert MH.ops.launches == before + 10
    want_c, want_l = MH.moe_histogram_ref(idx, gates, e)
    order_c, order_l = _order(idx, gates, e)
    counts, load = outs[0]
    assert torch.equal(counts, want_c) and torch.equal(counts, order_c)
    torch.testing.assert_close(load, want_l, rtol=1e-5, atol=1e-5)
    assert torch.equal(load, order_l)
    for c, ld in outs[1:]:
        assert torch.equal(c, counts) and torch.equal(ld, load)


@pytest.mark.parametrize("e", [1, 60, 4096])
def test_moe_histogram_all_padding_and_one_expert(cuda_device, e):
    from repro_torch.kernels import moe_histogram as MH
    n = 2 * _hist_chunk(e) + 3
    idx, gates = _assignments(e, n, 1, e, cuda_device)
    none = MH.moe_histogram(torch.full_like(idx, -1), gates, num_experts=e)
    assert all(not bool(x.any()) for x in none)
    one = torch.full_like(idx, e - 1)
    counts, load = MH.moe_histogram(one, gates, num_experts=e)
    assert float(counts[e - 1]) == n and float(counts.sum()) == n
    assert torch.equal(load, _order(one, gates, e)[1])


def test_moe_histogram_on_two_streams(cuda_device):
    """Launches on two streams at once keep apart: each stream has its
    own scratch rows and ticket, and each result is the written-out
    order's, bit for bit."""
    from repro_torch.kernels import moe_histogram as MH
    e = 60
    inputs = [_assignments(s, 51200, 4, e, cuda_device) for s in (1, 2)]
    want = [_order(*x, e) for x in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(8):
        for st, x in zip(streams, inputs):
            with torch.cuda.stream(st):
                outs.append(MH.moe_histogram(*x, num_experts=e))
    torch.cuda.synchronize()
    for i, (c, ld) in enumerate(outs):
        assert torch.equal(c, want[i % 2][0]) and torch.equal(ld,
                                                              want[i % 2][1])
    keys = {(cuda_device.index or 0, st.cuda_stream, e) for st in streams}
    assert keys <= set(MH.ops._scratch)


def test_moe_histogram_rejects_too_many_experts_on_the_card(cuda_device):
    from repro_torch.kernels import moe_histogram as MH
    idx, gates = _assignments(0, 8, 2, 4, cuda_device)
    with pytest.raises(ValueError, match="4096 experts"):
        MH.moe_histogram(idx, gates, num_experts=MH.MAX_EXPERTS + 1)


def _qkv(seed, b, h, hkv, s, skv, d, dtype, device):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    return [t.to(dtype) for t in _dev(device, q, k, v)]


# the JAX package's tolerances (tests/test_kernels.py): float32 2e-5,
# bfloat16 3e-2 (one bfloat16 rounding of an output of order 1)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _launched(FA, fn):
    """``fn()``'s result and the K6 kernels it launched, by kernel (the
    total count moves by as many)."""
    before, by_kernel = FA.ops.launches, dict(FA.ops.launches_by_kernel)
    out = fn()
    got = {name: c - by_kernel[name]
           for name, c in FA.ops.launches_by_kernel.items()
           if c != by_kernel[name]}
    assert FA.ops.launches - before == sum(got.values())
    return out, got


def _kernels_for(FA, q, k, **kw):
    """The K6 kernels one call on q, k launches: the tensor-core or tile
    kernel past ROW_MAX rows, else the decode kernel and, where the
    library cuts the keys into chunks, the merge."""
    if q.shape[2] > FA.ops.ROW_MAX:
        return {"flash_mma" if q.dtype == torch.bfloat16 else "flash_tile": 1}
    chunks = FA.ops.decode_chunks(FA.ops.build(), q, k, **kw)
    return {"flash_decode": 1, **({"flash_merge": 1} if chunks > 1 else {})}


def _calls(FA):
    """K6 calls that launched: every launch but a decode step's merge."""
    return FA.ops.launches - FA.ops.launches_by_kernel["flash_merge"]


def _within_bf16_steps(got, want):
    """Each bfloat16 output within two bfloat16 steps at its plain value
    plus the float32 tolerance: K6 and its plain version both sum in
    float32 and round once, so a bound that scales with the output
    holds, and small outputs are held as tightly as large ones."""
    w = want.float()
    _, e = torch.frexp(w)
    step = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 8))
    return bool(((got.float() - w).abs()
                 <= 2 * step + ATTN_TOL[torch.float32]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,skv,d,causal,window,q_offset", [
    (1, 2, 1, 64, 64, 16, True, None, 0),
    (2, 4, 2, 130, 130, 80, True, None, 0),
    (1, 8, 2, 256, 256, 128, True, None, 0),
    (1, 2, 2, 128, 128, 16, True, 16, 0),
    (1, 2, 2, 128, 128, 128, True, 100, 0),
    (2, 4, 2, 1, 96, 16, True, None, 95),
    (3, 16, 16, 1, 1056, 128, True, None, 1055),
    (3, 16, 16, 1, 1056, 128, True, None, 600),
    (2, 4, 2, 3, 70, 80, True, 20, 60),
    (2, 4, 2, 5, 70, 80, True, None, 60),
    (1, 4, 4, 200, 300, 256, True, None, 100),
    (2, 6, 2, 40, 40, 16, True, None, 0),
    (2, 4, 4, 77, 77, 80, False, None, 0),
    (1, 4, 1, 1, 50, 128, False, None, 0),
    # the bf16 tensor-core kernel's edges: S and Skv off the 64-row and
    # 32-key tiles, S = 5 (the first past the row kernel), GQA group 8, a
    # window inside one kv tile, non-causal with Skv > S, every D
    (1, 4, 2, 65, 65, 128, True, None, 0),
    (1, 4, 4, 127, 127, 256, True, None, 0),
    (1, 2, 1, 1000, 1000, 16, True, None, 0),
    (1, 4, 2, 1000, 1000, 80, True, None, 0),
    (2, 4, 4, 5, 5, 128, True, None, 0),
    (1, 16, 2, 300, 300, 128, True, None, 0),
    (1, 8, 1, 200, 200, 80, True, 10, 0),
    (1, 4, 2, 100, 333, 16, False, None, 0),
    (1, 4, 2, 65, 1000, 256, True, 7, 900),
])
def test_flash_attention_kernel_equals_plain_version(
        cuda_device, dtype, b, h, hkv, s, skv, d, causal, window, q_offset):
    from repro_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(s + skv + d, b, h, hkv, s, skv, d, dtype, cuda_device)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got, launched = _launched(FA, lambda: FA.flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    assert launched == _kernels_for(FA, q, k, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    want = FA.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        assert _within_bf16_steps(got, want)


def test_flash_attention_reads_strided_views_in_place(cuda_device):
    """A (B, S, H, D) projection seen as (B, H, S, D) and the first Skv
    rows of a longer cache give what their contiguous copies give."""
    from repro_torch.kernels import flash_attention as FA
    b, s, h, d, cap = 2, 70, 4, 128, 160
    q, _, _ = _qkv(1, b, s, h, h, 1, d, torch.bfloat16, cuda_device)
    kc, vc = _qkv(2, b, h, h, 1, cap, d, torch.bfloat16, cuda_device)[1:]
    qv = q.transpose(1, 2)
    for skv, s_q, off in ((s, s, 0), (100, 1, 99)):
        args = (qv[:, :, :s_q], kc[:, :, :skv], vc[:, :, :skv])
        got = FA.flash_attention(*args, q_offset=off)
        want = FA.flash_attention(*(t.contiguous() for t in args),
                                  q_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_flash_attention_rejects_misaligned_bf16_rows(cuda_device):
    """The tensor-core kernel copies 16-byte row chunks: a bf16 view whose
    rows do not start on 16 bytes raises (no copy, no other kernel); the
    same views still run where they take the row kernel (S <= 4)."""
    from repro_torch.kernels import flash_attention as FA
    b, h, s, d = 1, 2, 70, 128
    wide = _qkv(7, b, h, h, s, s, d + 8, torch.bfloat16, cuda_device)
    q, k, v = (t[..., :d] for t in wide)        # row stride D + 8: aligned
    FA.flash_attention(q, k, v)
    shifted = wide[0][..., 1:d + 1]              # rows start 2 bytes in
    padded = _qkv(8, b, h, h, s, s, d + 4, torch.bfloat16,
                  cuda_device)[0][..., :d]       # row stride D + 4
    for bad in (shifted, padded):
        before = FA.ops.launches
        with pytest.raises(ValueError, match="16 bytes"):
            FA.flash_attention(bad, k, v)
        with pytest.raises(ValueError, match="16 bytes"):
            FA.flash_attention(q, bad, v)
        assert FA.ops.launches == before
        got = FA.flash_attention(bad[:, :, :1], k, v, q_offset=s - 1)
        want = FA.attention_ref(bad[:, :, :1], k, v, q_offset=s - 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [12, 32, 64])
def test_flash_attention_pads_an_unbuilt_head_dim(cuda_device, d):
    """A D the kernels are not built for is no longer refused (ROADMAP
    F5): it is zero-padded to the next built width at the true scale
    and matches the plain version, prefill and decode, both types; only
    D past 256 raises."""
    from repro_torch.kernels import flash_attention as FA
    for dtype in (torch.float32, torch.bfloat16):
        for s, skv, off in ((40, 40, 0), (1, 40, 39), (3, 40, 30)):
            q, k, v = _qkv(d + s, 2, 4, 2, s, skv, d, dtype, cuda_device)
            got = FA.flash_attention(q, k, v, q_offset=off)
            want = FA.attention_ref(q, k, v, q_offset=off)
            torch.cuda.synchronize()
            assert got.shape == q.shape and got.stride() == q.stride()
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=ATTN_TOL[dtype])
            if dtype == torch.bfloat16:
                assert _within_bf16_steps(got, want)
    q, k, v = _qkv(0, 1, 2, 2, 8, 8, 264, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="D up to 256"):
        FA.flash_attention(q, k, v)


# (b, h, hkv, s, skv, d, window, q_offset, chunked): the decode kernel
# at the serve path's batch (50) and phase k6's small ones (1, 4), GQA
# group 4, a window, mid-cache offsets, S = 1, 2 and 4, at the library's
# own chunk count: one where the rows see at most 64 keys (False), many
# for few (b, kv head) blocks (True), the card's occupancy's choice at
# the serve input (None)
DECODE_CASES = [
    (50, 16, 16, 1, 1056, 128, None, 1054, None),
    (50, 16, 16, 1, 1056, 128, None, 527, None),
    (50, 16, 16, 1, 64, 128, None, 63, False),
    (4, 32, 8, 1, 8192, 80, 4096, 8191, True),
    (4, 32, 8, 1, 8192, 80, 64, 5000, False),
    (4, 16, 4, 4, 300, 128, 60, 150, False),
    (4, 16, 4, 4, 300, 128, 100, 150, True),
    (1, 4, 1, 4, 2000, 256, None, 1996, True),
    (1, 4, 1, 1, 2000, 256, None, 700, True),
    (4, 8, 2, 1, 600, 16, None, 300, True),
    (1, 32, 8, 2, 64, 80, 10, 62, False),
    (4, 16, 16, 4, 70, 128, None, 66, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,skv,d,window,q_offset,chunked",
                         DECODE_CASES)
def test_flash_decode_kernel_equals_plain_version(
        cuda_device, dtype, b, h, hkv, s, skv, d, window, q_offset, chunked):
    """The flash-decoding kernel (S <= 4) against the plain version at
    the JAX package's tolerances, at chunk counts of one and many (the
    merge launched only for many), and the same bits on a second call
    (the chunks merge in a fixed order)."""
    from repro_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(s + skv + d, b, h, hkv, s, skv, d, dtype, cuda_device)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    chunks = FA.ops.decode_chunks(FA.ops.build(), q, k, **kw)
    assert chunked is None or (chunks > 1) == chunked
    got, launched = _launched(FA, lambda: FA.flash_attention(q, k, v, **kw))
    again = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launched == _kernels_for(FA, q, k, **kw)
    assert ("flash_merge" in launched) == (chunks > 1)
    assert torch.equal(got, again)
    want = FA.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        assert _within_bf16_steps(got, want)


def test_flash_decode_copies_misaligned_kv_rows(cuda_device):
    """A decode step's k and v views whose rows are off 16 bytes are
    copied for the kernel's 16-byte loads, and give the plain result."""
    from repro_torch.kernels import flash_attention as FA
    wide = _qkv(9, 2, 4, 2, 1, 50, 130, torch.bfloat16, cuda_device)
    q = wide[0][..., 1:129]
    k, v = (t[..., 1:129] for t in wide[1:])
    got = FA.flash_attention(q, k, v, q_offset=49)
    want = FA.attention_ref(q, k, v, q_offset=49)
    torch.cuda.synchronize()
    assert _within_bf16_steps(got, want)


# ---------------------------------------------------------------------------
# the LM serving path on the card
# ---------------------------------------------------------------------------

def _to(params, device):
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, device) for v in params]
    return params.to(device)


# starcoder2's smoke config has head dim 12: K6 pads it to 16
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "h2o_danube_1_8b",
                                  "gemma_7b", "qwen2_moe_a2_7b",
                                  "deepseek_moe_16b", "starcoder2_7b",
                                  "jamba_v0_1_52b", "xlstm_1_3b"])
def test_smoke_model_on_the_card_matches_the_cpu_in_float32(cuda_device,
                                                              arch):
    """Prefill and two decode steps through K5 and K6 on the card give
    the CPU's logits (the plain versions) on the same weights, within
    the float32 parity tolerance of tests/test_torch_models.py: one K6
    call per attention layer and one K5 launch per MoE layer and call
    (jamba: one and four; xlstm: none), and every cache tensor within
    1e-4 of the CPU's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.model import layer_kinds
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    cpu = init_params(cfg, 0, device="cpu")
    card = _to(cpu, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    before = (_calls(FA), MH.ops.launches)
    outs, caches = [], []
    for params, dev in ((cpu, "cpu"), (card, cuda_device)):
        logits, cache, _ = prefill(params, cfg, token_ids=toks[:, :18].to(dev),
                                   max_seq=20)
        got = [logits]
        for t in (18, 19):
            logits, cache, _ = decode_step(params, cfg, cache,
                                           toks[:, t:t + 1].to(dev))
            got.append(logits)
        outs.append(got)
        caches.append(cache)
    torch.cuda.synchronize()
    kinds = layer_kinds(cfg)
    n_attn = sum(mixer == "attn" for mixer, _, _ in kinds)
    n_moe = sum(ffn == "moe" for _, ffn, _ in kinds)
    assert (_calls(FA), MH.ops.launches) == (
        before[0] + 3 * n_attn, before[1] + 3 * n_moe)
    for a, b in zip(*outs):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)
    for name, want in caches[0].items():
        if name != "offset":
            torch.testing.assert_close(caches[1][name].cpu(), want, rtol=0,
                                       atol=1e-4)


def test_two_layer_full_width_prefill_and_decode_on_the_card(cuda_device):
    """qwen2-moe-a2.7b at full width, two layers, bfloat16: one K5 and
    one K6 launch per layer and call, finite logits, and the kernel path
    within 4 bfloat16 steps (at the largest logit) of the plain path on
    the same weights and tokens."""
    import dataclasses
    import math
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cfg = dataclasses.replace(configs.get_config("qwen2_moe_a2_7b"),
                              num_layers=2)
    params = init_params(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 66), dtype=torch.int32,
                         device=cuda_device)

    def run():
        logits, cache, _ = prefill(params, cfg, token_ids=toks[:, :64],
                                   max_seq=66)
        outs = [logits]
        for t in (64, 65):
            logits, cache, _ = decode_step(params, cfg, cache,
                                           toks[:, t:t + 1])
            outs.append(logits)
        return outs

    before = (_calls(FA), MH.ops.launches)
    kern = run()
    torch.cuda.synchronize()
    assert (_calls(FA), MH.ops.launches) == (before[0] + 6, before[1] + 6)
    saved = L.flash_attention, MOE.moe_histogram
    L.flash_attention = FA.attention_ref
    MOE.moe_histogram = lambda i, g, *, num_experts: MH.moe_histogram_ref(
        i, g, num_experts)
    try:
        plain = run()
    finally:
        L.flash_attention, MOE.moe_histogram = saved
    largest = max(float(p.float().abs().max()) for p in plain)
    tol = 4 * 2.0 ** (math.floor(math.log2(largest)) - 7)
    for a, b in zip(kern, plain):
        assert a.shape == (2, 1, cfg.vocab_size)
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# training on the card: K6 under autograd (F6), a train step, checkpoints
# ---------------------------------------------------------------------------

def _bf16_step(x):
    import math
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def _grad_tol(want):
    """K6's backward against the recompute's own autograd: bfloat16
    within 4 bf16 steps at the largest |gradient| (the chunks' dk and dv
    are summed in float32 by K6's backward, in bfloat16 by autograd);
    float32 within 1e-5 of it."""
    top = float(want.float().abs().max())
    return 4 * _bf16_step(top) if want.dtype == torch.bfloat16 else 1e-5 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (2, 4, 2, 1536, 128, None),     # chunked, GQA
    (1, 4, 4, 1536, 80, 300),       # chunked, windowed, a padded-free D
    (2, 4, 2, 300, 16, None),       # direct
    (1, 4, 1, 200, 12, 50),         # direct, D padded to 16 by K6
])
def test_flash_attention_backward_on_the_card(cuda_device, dtype, b, h, hkv,
                                              s, d, window):
    """With grad enabled K6 returns through ``FlashAttentionFn``: one
    kernel launch forward, its output the grad-free call's, and dq, dk,
    dv equal to autograd through the reference's attention twin
    (``_sdpa_chunked`` past SDPA_DIRECT_MAX, else ``_sdpa_direct``) on
    the card."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(7, b, h, hkv, s, s, d, dtype, cuda_device))
    g = torch.randn(b, h, s, d, device=cuda_device).to(dtype)
    out, launched = _launched(FA, lambda: FA.flash_attention(
        q, k, v, causal=True, window=window))
    assert launched == {"flash_mma" if dtype == torch.bfloat16
                        else "flash_tile": 1}
    assert out.grad_fn is not None
    with torch.no_grad():
        torch.testing.assert_close(out, FA.flash_attention(
            q, k, v, causal=True, window=window), rtol=0, atol=0)
    got = torch.autograd.grad(out, (q, k, v), g)
    fn = (L._sdpa_direct if s <= L.SDPA_DIRECT_MAX else L._sdpa_chunked)
    ref = fn(*(t.transpose(1, 2) for t in (q, k, v)), causal=True,
             window=window, q_offset=0).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == w.dtype == dtype
        err = float((a.float() - w.float()).abs().max())
        assert err <= _grad_tol(w), (name, err, _grad_tol(w))


def _smoke_grads(arch, device, params_cpu):
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import make_batch_iterator
    from repro_torch.train import make_grad_fn
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    batch = next(make_batch_iterator(cfg, 2, 64, seed=3))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return make_grad_fn(cfg)(_to(params_cpu, device), batch)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "h2o_danube_1_8b",
                                  "qwen2_moe_a2_7b"])
def test_attention_weights_get_their_gradient_on_the_card(cuda_device,
                                                          arch):
    """F6's pin: through K6 on the card every layer's wq, wk, wv and wo
    gets a non-zero gradient equal to the CPU's (float32, rtol 1e-3,
    atol 1e-5).  Before F6 was repaired the kernel's output had no
    history, and wq, wk, wv got zeros on the card."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    (l_cpu, _), g_cpu = _smoke_grads(arch, "cpu", cpu)
    (l_card, _), g_card = _smoke_grads(arch, cuda_device, cpu)
    assert abs(float(l_card) - float(l_cpu)) < 1e-4
    for i, (a, c) in enumerate(zip(g_cpu["layers"], g_card["layers"])):
        for w in ("wq", "wk", "wv", "wo"):
            got = c["attn"][w].cpu()
            assert float(got.abs().max()) > 0, (i, w)
            torch.testing.assert_close(got, a["attn"][w], rtol=1e-3,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_moe_a2_7b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """One train step (remat dots_no_batch) on the card and on the CPU
    from the same float32 params and batch: loss within 1e-4, grad norm
    within 1e-3 relative, expert counts exact; K6 launches its float32
    kernel twice a layer (forward and the backward's recompute), K5
    twice a MoE layer."""
    import dataclasses
    from repro_torch import configs
    from repro_torch import tree as TR
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    batch = next(make_batch_iterator(cfg, 4, 64, seed=1))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=4))
    out = []
    for dev in ("cpu", cuda_device):
        params = _to(cpu, dev) if dev != "cpu" else TR.map(torch.clone, cpu)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = (dict(FA.ops.launches_by_kernel), MH.ops.launches)
        _, _, m = step(params, init_opt_state(params), b)
        torch.cuda.synchronize()
        launched = ({n: c - before[0][n]
                     for n, c in FA.ops.launches_by_kernel.items()},
                    MH.ops.launches - before[1])
        out.append((m, launched))
    (m_cpu, none), (m_card, launched) = out
    assert none == ({n: 0 for n in FA.ops.KERNELS}, 0)
    n_moe = cfg.num_layers if cfg.moe else 0
    assert launched == ({"flash_decode": 0, "flash_merge": 0,
                         "flash_tile": 2 * cfg.num_layers, "flash_mma": 0},
                        2 * n_moe)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) < 1e-4
    np.testing.assert_allclose(float(m_card["grad_norm"]),
                               float(m_cpu["grad_norm"]), rtol=1e-3)
    assert torch.equal(m_card["expert_counts"].cpu(), m_cpu["expert_counts"])


@pytest.mark.parametrize("window", [0, 8])
def test_stream_checkpoint_resumes_on_the_card(cuda_device, window):
    """A mid-run snapshot of the streaming engine on plane "torch"
    resumes to the continuous run's metric rows, bit for bit."""
    import tempfile
    from repro_torch.checkpoint import restore_stream, save_stream
    from repro_torch.ft import ChaosSpec, two_region
    from repro_torch.streaming.engine import EngineConfig, StreamingEngine
    from repro_torch.streaming.experiments import (Experiment, RouterSpec,
                                                   ScenarioSpec)
    m = 8
    exp = Experiment(
        scenario=ScenarioSpec(name="two_overlapping", ticks=60,
                              preload_queries=1500,
                              chaos=ChaosSpec(seed=2, ticks=60,
                                              drop_beats=0.05,
                                              delay_beats=0.1, partitions=1,
                                              partition_len=4, interrupts=2)),
        router=RouterSpec(kind="swarm", link_aware=True, trend_window=6),
        engine=EngineConfig(num_machines=m, adaptive_detector=True,
                            fused_window=window,
                            links=two_region(m, inter_ms=25.0,
                                             jitter_ms=10.0, tick_ms=10.0,
                                             seed=1)),
        data_plane="torch")

    def build():
        src = exp.scenario.build(seed=exp.seed, workload=exp.workload)
        router = exp.router.build(num_machines=m, workload=exp.workload,
                                  data_plane=exp.data_plane, seed=exp.seed,
                                  standby=exp.engine.standby_machines)
        eng = StreamingEngine(router, src, exp.engine)
        pre = eng.stream.preload(exp.scenario.preload_queries)
        if pre is not None:
            router.ingest(pre)
        return eng

    cont = build()
    cont.run(40)
    half = build()
    half.run(20)
    with tempfile.TemporaryDirectory() as d:
        save_stream(d, half)
        fresh = build()
        assert restore_stream(d, fresh) == 20
        fresh.run(20)
    a, b = cont.metrics.asarrays(), fresh.metrics.asarrays()
    for k in a:
        assert np.array_equal(a[k][20:], b[k]), k


# ---------------------------------------------------------------------------
# K5 and K6 as torch.library ops; serving on a (1, 1) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,skv,d,q_offset", [
    (2, 4, 2, 130, 130, 80, 0), (2, 4, 2, 1, 96, 16, 95),
    (1, 16, 2, 300, 300, 128, 0)])
def test_attention_op_equals_plain_version(cuda_device, dtype, b, h, hkv, s,
                                           skv, d, q_offset):
    """``torch.ops.repro_torch.flash_attention`` launches the kernels (one
    call as the wrapper counts it) and agrees with the plain version at
    the JAX package's tolerances."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(s + d, b, h, hkv, s, skv, d, dtype, cuda_device)
    got, launched = _launched(FA, lambda: torch.ops.repro_torch.flash_attention(
        q, k, v, True, None, q_offset))
    torch.cuda.synchronize()
    assert launched == _kernels_for(FA, q, k, q_offset=q_offset)
    want = FA.attention_ref(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("t,k,e", [(256, 4, 60), (65536, 2, 16)])
def test_histogram_op_equals_plain_version(cuda_device, t, k, e):
    """``torch.ops.repro_torch.moe_histogram``: one launch, (2, E) — the
    counts exact, the load at rtol 1e-5."""
    from repro_torch.kernels import moe_histogram as MH
    idx, gates = _assignments(t + e, t, k, e, cuda_device)
    before = MH.ops.launches
    got = torch.ops.repro_torch.moe_histogram(idx, gates, e)
    torch.cuda.synchronize()
    assert MH.ops.launches == before + 1 and got.shape == (2, e)
    counts, load = MH.moe_histogram_ref(idx, gates, e)
    assert torch.equal(got[0], counts)
    torch.testing.assert_close(got[1], load, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_fake_output_is_the_kernels(cuda_device, dtype):
    """Under FakeTensorMode the op gives the kernel output's shape, type
    and strides (q's: a (B, S, H, D) projection seen as (B, H, S, D))
    and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(3, 2, 8, 2, 40, 40, 128, dtype, cuda_device)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    real = torch.ops.repro_torch.flash_attention(q, k, v, True, None, 0)
    torch.cuda.synchronize()
    before = FA.ops.launches
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fake = torch.ops.repro_torch.flash_attention(fq, fk, fv, True, None,
                                                     0)
    assert FA.ops.launches == before
    assert (fake.shape, fake.dtype, fake.stride(), fake.device) == (
        real.shape, real.dtype, real.stride(), real.device)


def test_serving_on_a_one_card_mesh_equals_the_unsharded_path(cuda_device):
    """qwen2-moe-a2.7b at full width, two layers, B = 2, on a (1, 1)
    ("data", "model") mesh of a one-rank NCCL group: the weights placed
    by ``param_shardings`` (the same storage, ``DTensor.from_local``),
    the cache by ``cache_shardings``, ``make_constraint`` on — prefill
    and two decode steps give the unsharded path's logits (the same
    kernels on the same shards: bit for bit) and launch K5 and K6 as
    often."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.models import prefill
    from repro_torch.serve.engine import cache_shardings
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    cfg = dataclasses.replace(configs.get_config("qwen2_moe_a2_7b"),
                              num_layers=2)
    params = init_params(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 66), dtype=torch.int32,
                         device=cuda_device)

    def run(params, cache, constraint, place):
        logits, cache, _ = prefill(params, cfg, token_ids=place(toks[:, :64]),
                                   max_seq=66, cache=cache,
                                   constraint=constraint)
        outs = [logits]
        for t in (64, 65):
            logits, cache, _ = decode_step(params, cfg, cache,
                                           place(toks[:, t:t + 1]),
                                           constraint=constraint)
            outs.append(logits)
        return [SH.whole(o) for o in outs]

    before = (_calls(FA), MH.ops.launches)
    plain = run(params, None, None, lambda t: t)
    plain_launches = (_calls(FA) - before[0], MH.ops.launches - before[1])
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        placed = SH.shard_params(params, SH.param_shardings(cfg, mesh))
        cache = SH.shard_params(init_cache(cfg, 2, 66, device=cuda_device),
                                cache_shardings(cfg, mesh, 2, 66))
        before = (_calls(FA), MH.ops.launches)
        with implicit_replication():
            sharded = run(placed, cache, SH.make_constraint(mesh),
                          lambda t: SH.shard_tensor(
                              t, SH.batch_sharding(mesh, 2)))
        torch.cuda.synchronize()
        assert (_calls(FA) - before[0],
                MH.ops.launches - before[1]) == plain_launches
    finally:
        dist.destroy_process_group()
    for a, b in zip(sharded, plain):
        assert torch.equal(a, b)
