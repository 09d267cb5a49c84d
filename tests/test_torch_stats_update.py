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


# -- the in-place round close (``close_live``, ``close_live_ref``) ----------

def _live_banks(seed, cap=41, g=30, n_live=23):
    """Both banks filled everywhere (dead rows too, to see that they stay
    untouched), integer collectors with negative C_SPAN entries (its
    difference form), fractional maintained channels, and unsorted live
    ids."""
    rng = np.random.default_rng(seed)
    banks = []
    for _ in range(2):
        bank = rng.integers(0, 50, (8, cap, g + 1)).astype(np.float32)
        bank[:S.C_N] += rng.uniform(0, 1, (S.C_N, cap, g + 1)).astype(
            np.float32)
        bank[S.C_SPAN] -= 25.0
        banks.append(bank)
    live = rng.permutation(cap)[:n_live]
    assert (np.diff(live) < 0).any()
    return banks[0], banks[1], live


@pytest.mark.parametrize("decay", [0.5, 0.9, 1.0])
def test_close_live_ref_equals_the_jax_package(decay):
    rows, cols, live = _live_banks(int(decay * 10))
    got_rows, got_cols = rows.copy(), cols.copy()
    TSU.close_live_ref(torch.from_numpy(got_rows), torch.from_numpy(got_cols),
                       live, decay)
    # the reference's whole-bank fold, restricted to the live rows: bit for
    # bit at every decay (both round N·decay, then the sum, in float32)
    whole = S.StatsState(rows.copy(), cols.copy(), 30)
    S.close_round(whole, decay)
    np.testing.assert_array_equal(got_rows[:, live], whole.rows[:, live])
    np.testing.assert_array_equal(got_cols[:, live], whole.cols[:, live])
    dead = np.setdiff1d(np.arange(rows.shape[1]), live)
    np.testing.assert_array_equal(got_rows[:, dead], rows[:, dead])
    np.testing.assert_array_equal(got_cols[:, dead], cols[:, dead])
    # JaxPlane's live-subset close: bit for bit at the dyadic decays; at
    # 0.9 its XLA fold may contract N·decay + cumN into one rounding,
    # held to the file's one-rounding tolerance (DECAYS)
    jp = S.StatsState(rows.copy(), cols.copy(), 30)
    jax_plane("jax").close_round(jp, decay, live)
    rtol = dict(DECAYS)[decay]
    np.testing.assert_allclose(got_rows, jp.rows, rtol=rtol, atol=0)
    np.testing.assert_allclose(got_cols, jp.cols, rtol=rtol, atol=0)
    if rtol == 0.0:
        np.testing.assert_array_equal(got_rows, jp.rows)


def test_close_live_on_the_host_is_close_live_ref():
    rows, cols, live = _live_banks(7)
    want_rows, want_cols = rows.copy(), cols.copy()
    TSU.close_live_ref(torch.from_numpy(want_rows),
                       torch.from_numpy(want_cols), live, 0.5)
    before = TSU.ops.launches
    TSU.close_live(torch.from_numpy(rows), torch.from_numpy(cols), live, 0.5)
    assert TSU.ops.launches == before          # the host path launches nothing
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(cols, want_cols)


def _grown_swarms(decay):
    """The port's and the JAX package's protocol, the same collectors
    ingested on both, one round closed, then the partition table grown so
    that ``_sync_capacity`` replaces both banks' arrays (``np.concatenate``)
    and more collectors ingested."""
    from repro.core.protocol import Swarm as JaxSwarm
    from repro_torch.core.protocol import Swarm as TorchSwarm
    rng = np.random.default_rng(5)
    jax_sw = JaxSwarm(16, 4, decay=decay, data_plane=jax_plane("jax"))
    torch_sw = TorchSwarm(16, 4, decay=decay, data_plane=TorchPlane("cpu"))

    def ingest():
        cap = jax_sw.stats.rows.shape[1]
        live = jax_sw.index.parts.live_ids()
        for sw in (jax_sw, torch_sw):
            assert sw.stats.rows.shape[1] == cap
        for bank in ("rows", "cols"):
            adds = rng.integers(-3, 9, (3, len(live), 17)).astype(np.float32)
            for sw in (jax_sw, torch_sw):
                getattr(sw.stats, bank)[S.C_N:, live] += adds

    ingest()
    for sw in (jax_sw, torch_sw):
        sw._close_stats()
    old = (torch_sw.stats.rows, torch_sw.stats.cols)
    for sw in (jax_sw, torch_sw):
        sw.index.parts._grow()
        sw._sync_capacity()
    assert torch_sw.stats.rows is not old[0]
    assert torch_sw.stats.cols is not old[1]
    ingest()
    return jax_sw, torch_sw


@pytest.mark.parametrize("decay", [0.5, 1.0])
def test_torch_close_round_after_a_capacity_growth(decay):
    jax_sw, torch_sw = _grown_swarms(decay)
    for sw in (jax_sw, torch_sw):
        sw._close_stats()
    np.testing.assert_array_equal(torch_sw.stats.rows, jax_sw.stats.rows)
    np.testing.assert_array_equal(torch_sw.stats.cols, jax_sw.stats.cols)
    assert torch_sw.plane.rehomed == 0     # the host plane page-locks none


def test_close_live_rejects_what_the_kernel_does_not_take():
    rows, cols, live = _live_banks(9)
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    with pytest.raises(TypeError, match="float32"):
        TSU.close_live(r.double(), c, live)
    with pytest.raises(ValueError, match="C-contiguous"):
        TSU.close_live(r, c.transpose(1, 2).contiguous().transpose(1, 2),
                       live)
    with pytest.raises(ValueError, match="out of range"):
        TSU.close_live(r, c, np.array([0, rows.shape[1]]))
    with pytest.raises(ValueError, match="out of range"):
        TSU.close_live(r, c, np.array([-1, 3]))
    with pytest.raises(ValueError, match="repeated"):
        TSU.close_live(r, c, np.array([4, 2, 4]))
    with pytest.raises(TypeError, match="integer"):
        TSU.close_live(r, c, np.array([1.0, 2.0]))
    with pytest.raises(ValueError, match=r"\(8, cap, G1\)"):
        TSU.close_live(r[:6], c[:6], live)
    # nothing was folded by a refused call
    np.testing.assert_array_equal(rows, _live_banks(9)[0])
