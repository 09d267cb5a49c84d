"""The PyTorch port on a CUDA card: kernels K1–K4 against their plain
versions (exact), one K1 launch per round close, exact window counts
with TF32 enabled (ROADMAP F2), the exact-match API and the main path
on ``TorchPlane("cuda")`` against the port's own NumPy reference plane.  Every test here needs the card and
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


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("n,q", [(16, 5), (3000, 700), (50000, 20000)])
def test_knn_match_kernel_equals_plain_version(cuda_device, n, q, k):
    rng = np.random.default_rng(n + q + k)
    pts, foci = _dev(cuda_device, rng.uniform(0, 1, (n, 2)).astype(np.float32),
                     rng.uniform(0, 1, (q, 2)).astype(np.float32))
    pts[: n // 3] = pts[n // 3: 2 * (n // 3)]       # duplicate points
    before = KN.ops.launches
    got = KN.knn_match(pts, foci, k=k)
    torch.cuda.synchronize()
    assert KN.ops.launches == before + 1
    assert torch.equal(got, KN.knn_match_ref(pts, foci, k))


def test_knn_match_rejects_k_above_its_range_on_the_card(cuda_device):
    pts = torch.zeros((40, 2), device=cuda_device)
    with pytest.raises(ValueError, match="1 <= k <= 16"):
        KN.knn_match(pts, pts, k=17)
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
    before = (SM.ops.launches, KM.ops.launches, KN.ops.launches)
    for a, b in zip(card.match_counts(pts, rects),
                    ref.match_counts(pts, rects)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(card.keyword_match_counts(pts, pm, rects, sm),
                    ref.keyword_match_counts(pts, pm, rects, sm)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(card.knn_distances(pts, foci, k=8),
                                  ref.knn_distances(pts, foci, k=8))
    assert (SM.ops.launches, KM.ops.launches, KN.ops.launches) == tuple(
        x + 1 for x in before)
