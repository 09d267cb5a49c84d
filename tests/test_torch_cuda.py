"""The PyTorch port on a CUDA card: kernels K1–K4 against their plain
versions (exact), one K1 launch per round close, exact window counts
with TF32 enabled (ROADMAP F2), the exact-match API and the main path
on ``TorchPlane("cuda")`` against the port's own NumPy reference plane;
kernels K5 and K6 against their plain versions (counts exact, attention
at the JAX package's tolerances) and the LM serving path through them
(smoke models against the CPU, qwen2-moe-a2.7b at full width with two
layers against its plain path).  Every test here needs the card and
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
    _, _, _, ok = plane.run_window(state, router._cost_params(), fp, carry,
                                   xy)
    assert not ok
    for a, b in zip(state, before):
        if a is not None:
            assert torch.equal(a, b)


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
                                  "deepseek_moe_16b", "starcoder2_7b"])
def test_smoke_model_on_the_card_matches_the_cpu_in_float32(cuda_device,
                                                              arch):
    """Prefill and two decode steps through K5 and K6 on the card give
    the CPU's logits (the plain versions) on the same weights, within
    the float32 parity tolerance of tests/test_torch_models.py."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.models import decode_step, init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    cpu = init_params(cfg, 0, device="cpu")
    card = _to(cpu, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    before = (_calls(FA), MH.ops.launches)
    outs = []
    for params, dev in ((cpu, "cpu"), (card, cuda_device)):
        logits, cache, _ = prefill(params, cfg, token_ids=toks[:, :18].to(dev),
                                   max_seq=20)
        got = [logits]
        for t in (18, 19):
            logits, cache, _ = decode_step(params, cfg, cache,
                                           toks[:, t:t + 1].to(dev))
            got.append(logits)
        outs.append(got)
    torch.cuda.synchronize()
    n_moe = cfg.num_layers if cfg.moe else 0
    assert (_calls(FA), MH.ops.launches) == (
        before[0] + 3 * cfg.num_layers, before[1] + 3 * n_moe)
    for a, b in zip(*outs):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


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
