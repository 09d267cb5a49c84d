"""Kernel K1 (the Algorithm-2 round close) in the PyTorch port against
the JAX package: the plain PyTorch version and the CPU path of the
wrapper against the Pallas kernel in interpret mode and the XLA
transfer-minimal fold; and ``TorchPlane``'s live-subset round close
and batched split terms against ``JaxPlane``.  The CUDA kernel itself
is held against its plain version on the card in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import balancer  # noqa: E402
from repro.core import statistics as S  # noqa: E402
from repro.kernels import stats_update as JSU  # noqa: E402
from repro.streaming import get_plane as jax_plane  # noqa: E402
from repro_torch.core import statistics as TS  # noqa: E402
from repro_torch.kernels import stats_update as TSU  # noqa: E402
from repro_torch.streaming import TorchPlane  # noqa: E402

# Decays 1.0 and 0.5 are dyadic: N·decay is exact and the collector sums
# are integers below 2²⁴, so the fold is held to equality.  For 0.9 the
# product rounds; both sides round the product and then the sum in
# float32, and the stated tolerance admits one float32 rounding of the
# result (2⁻²³ ≈ 1.2e-7, held at rtol 1e-6, atol 0).
DECAYS = [(1.0, 0.0), (0.5, 0.0), (0.9, 1e-6)]
SHAPES = [(9, 19), (13, 130), (64, 257)]     # odd sizes exercise padding


def _bank(seed, p, g1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 60, (8, p, g1)).astype(np.float32)


def test_channel_orders_match_the_jax_package():
    assert TSU.IN_CH == JSU.ops.IN_CH and TSU.OUT_CH == JSU.ops.OUT_CH
    assert (TSU.ops.N, TSU.ops.C_N, TSU.ops.NUM_CH) == (S.N, S.C_N, S.NUM_CH)


@pytest.mark.parametrize("p,g1", SHAPES)
@pytest.mark.parametrize("decay,rtol", DECAYS)
def test_ref_matches_pallas_kernel_interpret(p, g1, decay, rtol):
    bank = _bank(p * g1, p, g1)
    want = np.asarray(JSU.close_round(jnp.asarray(bank), decay=decay,
                                      interpret=True))
    got = TSU.close_round_ref(torch.from_numpy(bank), decay).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("p,g1", SHAPES)
@pytest.mark.parametrize("decay,rtol", DECAYS)
def test_wrapper_cpu_path_matches_close_round_inputs(p, g1, decay, rtol):
    bank6 = np.ascontiguousarray(_bank(p + g1, p, g1)[list(TSU.IN_CH)])
    want = np.asarray(JSU.close_round_inputs(jnp.asarray(bank6),
                                             decay=decay))
    before = TSU.ops.launches
    got = TSU.close_round_inputs(torch.from_numpy(bank6), decay).numpy()
    assert TSU.ops.launches == before          # the CPU path launches nothing
    assert got.shape == (5, p, g1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"\(6, P, G1\)"):
        TSU.close_round_inputs(torch.zeros(5, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        TSU.close_round_inputs(torch.zeros(6, 4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="no stats_update kernel"):
        TSU.close_round_inputs(torch.zeros(6, 4, 8, device="meta"))


def _live_bank(seed=4, cap=37, g=24, n_live=17):
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(cap, n_live, replace=False))
    ref = S.StatsState.zeros(cap, g)
    ref.rows[:, live] = rng.integers(0, 50, (8, n_live, g + 1)).astype(
        np.float32)
    ref.cols[:, live] = rng.integers(0, 50, (8, n_live, g + 1)).astype(
        np.float32)
    return ref, live


@pytest.mark.parametrize("decay", [1.0, 0.5, 0.9])
def test_torch_close_round_matches_jax_plane(decay):
    ref, live = _live_bank()
    tp = TS.StatsState(ref.rows.copy(), ref.cols.copy(), ref.grid_size)
    jax_plane("jax").close_round(ref, decay, live)
    TorchPlane("cpu").close_round(tp, decay, live)
    rtol = dict(DECAYS)[decay]
    np.testing.assert_allclose(tp.rows, ref.rows, rtol=rtol, atol=0)
    np.testing.assert_allclose(tp.cols, ref.cols, rtol=rtol, atol=0)
    # dead rows were zero and stay zero; live collectors are reset
    dead = np.setdiff1d(np.arange(tp.rows.shape[1]), live)
    assert not tp.rows[:, dead].any() and not tp.cols[:, dead].any()
    assert not tp.rows[list(S.COLLECTORS)].any()


def test_torch_close_round_empty_live_set_is_a_no_op():
    ref, _ = _live_bank()
    tp = TS.StatsState(ref.rows.copy(), ref.cols.copy(), ref.grid_size)
    TorchPlane("cpu").close_round(tp, 0.5, np.zeros(0, np.int64))
    np.testing.assert_array_equal(tp.rows, ref.rows)


def _random_stats(seed, n_pids=5, g=32):
    rng = np.random.default_rng(seed)
    st = S.StatsState.zeros(n_pids, g)
    boxes = []
    for pid in range(n_pids):
        r0, c0 = rng.integers(0, g // 2, 2)
        r1 = int(rng.integers(r0 + 1, g))
        c1 = int(rng.integers(c0 + 1, g))
        boxes.append((int(r0), int(c0), r1, c1))
        k = 400
        rows = rng.integers(r0, r1 + 1, k)
        cols = rng.integers(c0, c1 + 1, k)
        S.ingest_points(st, np.full(k, pid), rows, cols)
        qr0 = rng.integers(r0, r1 + 1, 30)
        qc0 = rng.integers(c0, c1 + 1, 30)
        qr1 = np.minimum(qr0 + rng.integers(0, 4, 30), r1)
        qc1 = np.minimum(qc0 + rng.integers(0, 4, 30), c1)
        S.ingest_queries(st, np.full(30, pid), qr0, qc0, qr1, qc1)
    S.close_round(st, 1.0)
    return st, tuple(np.array(b, np.int64) for b in zip(*boxes))


@pytest.mark.parametrize("seed", [3, 8])
def test_split_costs_match_jax_plane(seed):
    st, boxes = _random_stats(seed)
    pids = np.arange(len(boxes[0]))
    want = jax_plane("jax").split_costs(st, pids, boxes, 57.0,
                                        balancer.product_cost)
    tst = TS.StatsState(st.rows.copy(), st.cols.copy(), st.grid_size)
    got = TorchPlane("cpu").split_costs(tst, pids, boxes, 57.0,
                                        balancer.product_cost)
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.where(want[2], a, 0.0),
                                   np.where(want[2], b, 0.0), rtol=1e-6)
