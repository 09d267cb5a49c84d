"""The PyTorch port's exact-match API (kernels K2–K4: ``spatial_match``,
``keyword_match``, ``knn_match``) against the JAX package: each plain
PyTorch version, and each wrapper on a CPU tensor, against the JAX
kernel in interpret mode and its JAX reference, on the sweeps of
``tests/test_kernels.py``, ``tests/test_pubsub.py`` and
``tests/test_queries.py``; then ``TorchPlane("cpu")`` against
``JaxPlane`` and ``NumpyPlane`` on the cross-plane cases of
``tests/test_api.py`` and ``tests/test_pubsub.py``.  Counts are exact;
kNN distances are within rtol 1e-6 / atol 1e-7, the JAX package's own
tolerance.  Inputs come from NumPy seeds and reach both sides as NumPy
arrays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.streaming as J  # noqa: E402
import repro_torch.streaming as T  # noqa: E402
from repro.kernels.keyword_match import (keyword_match as j_keyword,  # noqa: E402
                                         keyword_match_ref as j_keyword_ref)
from repro.kernels.knn_match import knn_match as j_knn  # noqa: E402
from repro.kernels.knn_match import knn_match_ref as j_knn_ref  # noqa: E402
from repro.kernels.spatial_match import spatial_match as j_spatial  # noqa: E402
from repro.kernels.spatial_match import (  # noqa: E402
    spatial_match_ref as j_spatial_ref)
from repro_torch.kernels import keyword_match as KM  # noqa: E402
from repro_torch.kernels import knn_match as KN  # noqa: E402
from repro_torch.kernels import spatial_match as SM  # noqa: E402
from repro_torch.queries import TermHasher, bucket_masks  # noqa: E402

CPU = T.TorchPlane("cpu")
KNN_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _np(*ts):
    return [np.asarray(t) for t in ts]


def _points_rects(seed, n, q):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    c = rng.uniform(0, 0.9, (q, 2))
    rects = np.concatenate([c, c + rng.uniform(0.01, 0.3, (q, 2))],
                           1).astype(np.float32)
    return pts, rects


def _masks(seed, n, q, t):
    rng = np.random.default_rng(seed)
    pm = (rng.random((n, t)) < 0.3).astype(np.float32)
    sm = (rng.random((q, t)) < 0.2).astype(np.float32)
    return pm, sm


def _assert_counts(got, *wants):
    for want in wants:
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == np.int32 and b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K2: spatial_match
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,q", [(1, 1), (7, 130), (128, 128), (300, 77),
                                 (513, 256)])
def test_spatial_match_matches_the_jax_kernel(n, q):
    pts, rects = _points_rects(n * 1000 + q, n, q)
    want_k = _np(*j_spatial(jnp.asarray(pts), jnp.asarray(rects),
                            interpret=True))
    want_r = _np(*j_spatial_ref(jnp.asarray(pts), jnp.asarray(rects)))
    before = SM.ops.launches
    _assert_counts(_np(*SM.spatial_match(_t(pts), _t(rects))), want_k, want_r)
    _assert_counts(_np(*SM.spatial_match_ref(_t(pts), _t(rects))), want_k)
    assert SM.ops.launches == before     # a CPU tensor never launches


def test_spatial_match_borders_are_inclusive():
    pts = np.array([[0.5, 0.5]], np.float32)
    rects = np.array([[0.5, 0.5, 0.6, 0.6], [0.4, 0.4, 0.5, 0.5],
                      [0.51, 0.51, 0.6, 0.6]], np.float32)
    pc, qc = SM.spatial_match(_t(pts), _t(rects))
    assert pc.tolist() == [2] and qc.tolist() == [1, 1, 0]
    _assert_counts((pc, qc), _np(*j_spatial(jnp.asarray(pts),
                                            jnp.asarray(rects),
                                            interpret=True)))


def test_spatial_match_chunks_the_rect_axis(monkeypatch):
    """Chunking over rects is exact: a tiny block budget gives the same
    counts as one block."""
    pts, rects = _points_rects(9, 300, 257)
    whole = SM.spatial_match_ref(_t(pts), _t(rects))
    monkeypatch.setattr(SM.ref, "CHUNK_ELEMS", 300 * 7)
    _assert_counts(_np(*SM.spatial_match_ref(_t(pts), _t(rects))),
                   _np(*whole))


@pytest.mark.parametrize("bad", [
    lambda p, r: (p[:, :1], r),
    lambda p, r: (p, r[:, :3]),
    lambda p, r: (p.double(), r),
])
def test_spatial_match_rejects_bad_inputs(bad):
    pts, rects = _points_rects(1, 8, 4)
    with pytest.raises((ValueError, TypeError)):
        SM.spatial_match(*bad(_t(pts), _t(rects)))


# ---------------------------------------------------------------------------
# K3: keyword_match
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,q,t", [(1, 1, 4), (37, 53, 8), (200, 131, 32),
                                   (130, 257, 11), (90, 70, 33)])
def test_keyword_match_matches_the_jax_kernel(n, q, t):
    rng = np.random.default_rng(n * 1000 + q)
    pts = rng.random((n, 2)).astype(np.float32)
    lo = rng.random((q, 2)) * 0.7
    rects = np.concatenate([lo, lo + rng.random((q, 2)) * 0.5],
                           1).astype(np.float32)
    pm, sm = _masks(n + q + t, n, q, t)
    args = [jnp.asarray(a) for a in (pts, pm, rects, sm)]
    want_k = _np(*j_keyword(*args, interpret=True))
    want_r = _np(*j_keyword_ref(*args))
    targs = [_t(a) for a in (pts, pm, rects, sm)]
    before = KM.ops.launches
    _assert_counts(_np(*KM.keyword_match(*targs)), want_k, want_r)
    _assert_counts(_np(*KM.keyword_match_ref(*targs)), want_k)
    assert KM.ops.launches == before
    assert np.asarray(want_k[0]).sum() > 0 or n * q < 10


@pytest.mark.parametrize("t", [4, 8, 11, 32, 33])
def test_all_zero_subscription_masks_give_the_spatial_counts(t):
    pts, rects = _points_rects(t, 150, 90)
    pm, _ = _masks(t, 150, 90, t)
    sm = np.zeros((90, t), np.float32)
    got = _np(*KM.keyword_match(_t(pts), _t(pm), _t(rects), _t(sm)))
    _assert_counts(got, _np(*SM.spatial_match(_t(pts), _t(rects))),
                   _np(*j_keyword(*[jnp.asarray(a)
                                    for a in (pts, pm, rects, sm)],
                                  interpret=True)))


def test_keyword_match_chunks_the_subscription_axis(monkeypatch):
    pts, rects = _points_rects(4, 120, 200)
    pm, sm = _masks(4, 120, 200, 16)
    args = [_t(a) for a in (pts, pm, rects, sm)]
    whole = _np(*KM.keyword_match_ref(*args))
    monkeypatch.setattr(SM.ref, "CHUNK_ELEMS", 120 * 9)
    _assert_counts(_np(*KM.keyword_match_ref(*args)), whole)


def test_keyword_match_rejects_mismatched_masks():
    pts, rects = _points_rects(1, 8, 4)
    pm, sm = _masks(1, 8, 4, 8)
    with pytest.raises(ValueError, match="masks"):
        KM.keyword_match(_t(pts), _t(pm), _t(rects), _t(sm[:, :7]))
    with pytest.raises(TypeError):
        KM.keyword_match(_t(pts), _t(pm).double(), _t(rects), _t(sm))


GEOMETRY_SIZES = [1, 31, 32, 33, 20_000, 1_000_000]


@pytest.mark.parametrize("t", [32, 33])
@pytest.mark.parametrize("q", GEOMETRY_SIZES)
@pytest.mark.parametrize("n", GEOMETRY_SIZES)
def test_keyword_match_geometry_covers_every_pair_once(n, q, t):
    """Block (x, y) tests the tuples of tile x (thread i's slot s holds
    tuple x·THREADS·r + s·THREADS + i) against the chunks of group y, at
    the shipped R of one mask word (t = 32) and of two (t = 33); the
    tiles partition [0, n) padded to a tile, the groups partition the
    chunks, so every (tuple, subscription) pair is tested exactly once.
    The launcher's own checks hold too."""
    threads, chunk = KM.ops.THREADS, KM.ops.CHUNK
    r = KM.ops.tuples_per_thread(t)
    assert r == (KM.ops.TUPLES_PER_THREAD if t <= 32
                 else KM.ops.MULTI_WORD_TUPLES_PER_THREAD)
    tiles, groups, per = KM.ops.geometry(n, q, r)
    chunks = -(-q // chunk)
    slots = (np.arange(tiles)[:, None, None] * threads * r
             + np.arange(r)[None, :, None] * threads
             + np.arange(threads)[None, None, :]).ravel()
    np.testing.assert_array_equal(np.sort(slots),
                                  np.arange(tiles * threads * r))
    assert n <= tiles * threads * r < n + threads * r
    owned = np.concatenate([np.arange(y * per, min((y + 1) * per, chunks))
                            for y in range(groups)])
    np.testing.assert_array_equal(owned, np.arange(chunks))
    assert all(y * per < chunks for y in range(groups))   # none empty
    assert q <= chunks * chunk < q + chunk
    assert 1 <= groups <= 65535 and per >= 1
    assert groups * per >= chunks and (groups - 1) * per < chunks


# ---------------------------------------------------------------------------
# K4: knn_match
# ---------------------------------------------------------------------------

KNN_CASES = [(128, 128, 8), (257, 100, 8), (16, 16, 16), (640, 384, 3),
             (300, 77, 8), (513, 256, 4), (64, 10, 16), (8, 5, 8),
             (1000, 300, 12), (50, 20, 2), (40, 9, 1)]


@pytest.mark.parametrize("n,q,k", KNN_CASES)
def test_knn_match_matches_the_jax_kernel(n, q, k):
    rng = np.random.default_rng(n * 7 + q + k)
    pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    foci = rng.uniform(0, 1, (q, 2)).astype(np.float32)
    want_k = np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(foci), k=k,
                              interpret=True))
    want_r = np.asarray(j_knn_ref(jnp.asarray(pts), jnp.asarray(foci), k))
    before = KN.ops.launches
    got = KN.knn_match(_t(pts), _t(foci), k=k).numpy()
    assert KN.ops.launches == before
    assert got.shape == (q, k) and got.dtype == np.float32
    assert (np.diff(got, axis=1) >= 0).all()
    for want in (want_k, want_r):
        np.testing.assert_allclose(got, want, **KNN_TOL)
    # the port's NumPy plane rounds the same products and sum: equal
    np.testing.assert_array_equal(
        got, KN.knn_match_ref(_t(pts), _t(foci), k).numpy())
    np.testing.assert_array_equal(
        got, T.NumpyPlane().knn_distances(pts, foci, k=k))


def test_knn_match_counts_duplicate_points():
    pts = np.array([[0.5, 0.5]] * 3 + [[0.9, 0.9]], np.float32)
    foci = np.array([[0.5, 0.5]], np.float32)
    got = KN.knn_match(_t(pts), _t(foci), k=4).numpy()
    want = np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(foci), k=4,
                            interpret=True))
    np.testing.assert_allclose(got, want, **KNN_TOL)
    np.testing.assert_array_equal(got[0, :3], 0.0)
    np.testing.assert_allclose(got[0, 3], 0.32, rtol=1e-5)


def test_knn_match_exact_neighbors():
    pts = np.array([[0.0, 0.0], [0.3, 0.0], [1.0, 1.0]], np.float32)
    foci = np.array([[0.0, 0.0]], np.float32)
    got = KN.knn_match(_t(pts), _t(foci), k=2).numpy()
    np.testing.assert_allclose(got[0], [0.0, 0.09], atol=1e-6)


def test_knn_match_chunks_the_foci(monkeypatch):
    rng = np.random.default_rng(8)
    pts = _t(rng.uniform(0, 1, (200, 2)))
    foci = _t(rng.uniform(0, 1, (70, 2)))
    whole = KN.knn_match_ref(pts, foci, 5)
    monkeypatch.setattr(SM.ref, "CHUNK_ELEMS", 200 * 3)
    assert torch.equal(KN.knn_match_ref(pts, foci, 5), whole)


@pytest.mark.parametrize("n,k,match", [(20, 17, r"1 <= k <= 16"),
                                       (20, 0, r"1 <= k <= 16"),
                                       (7, 8, "batch of 7")])
def test_knn_match_rejects_k_outside_its_range(n, k, match):
    pts = _t(np.zeros((n, 2)))
    with pytest.raises(ValueError, match=match):
        KN.knn_match(pts, _t(np.zeros((3, 2))), k=k)
    with pytest.raises(ValueError, match=match):
        CPU.knn_distances(np.zeros((n, 2)), np.zeros((3, 2)), k=k)


# ---------------------------------------------------------------------------
# TorchPlane("cpu") against the JAX package's planes
# ---------------------------------------------------------------------------

def test_plane_match_counts_and_knn_agree_with_jax_and_numpy_planes():
    """tests/test_api.py::test_plane_match_counts_and_knn_agree."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (400, 2)).astype(np.float32)
    rects = np.concatenate([c := rng.uniform(0, 0.9, (50, 2)), c + 0.05],
                           axis=1).astype(np.float32)
    foci = rng.uniform(0, 1, (20, 2)).astype(np.float32)
    got = CPU.match_counts(pts, rects)
    for plane in (J.get_plane("numpy"), J.get_plane("jax")):
        _assert_counts(got, [np.asarray(a, np.int32)
                             for a in plane.match_counts(pts, rects)])
        np.testing.assert_allclose(CPU.knn_distances(pts, foci, k=4),
                                   plane.knn_distances(pts, foci, k=4),
                                   **KNN_TOL)
    assert sum(got[0]) > 0


def test_plane_keyword_match_counts_agree_with_jax_and_numpy_planes():
    """tests/test_pubsub.py::test_plane_match_counts_numpy_jax_identical."""
    rng = np.random.default_rng(3)
    h = TermHasher(16)
    pts = rng.random((150, 2)).astype(np.float32)
    lo = rng.random((60, 2)) * 0.6
    rects = np.concatenate([lo, lo + 0.3], 1).astype(np.float32)
    pm = bucket_masks(h.buckets(rng.integers(0, 99, (150, 3))), 16)
    sm = h.sub_masks(rng.integers(0, 99, (60, 2)))
    got = CPU.keyword_match_counts(pts, pm, rects, sm)
    for plane in (J.NumpyPlane(), J.get_plane("jax"), T.NumpyPlane()):
        _assert_counts(got, [np.asarray(a, np.int32) for a in
                             plane.keyword_match_counts(pts, pm, rects, sm)])
    assert got[0].sum() > 0


def test_plane_hashed_matching_bounds_exact_matching():
    """benchmarks/pubsub.py's collision bound on the port's plane: hashed
    bucket matching never drops an exact per-term match, and an injective
    bucket map gives equality."""
    rng = np.random.default_rng(11)
    wl = T.WorkloadSpec(query_model="spatial_keyword")
    n, q = 300, 400
    pts = rng.random((n, 2)).astype(np.float32)
    lo = rng.random((q, 2)) * 0.8
    rects = np.concatenate([lo, np.minimum(lo + 0.2, 1.0)],
                           1).astype(np.float32)
    for hasher, vocab, injective in ((TermHasher(8), 12, False),
                                     (TermHasher(4096), 40, True)):
        terms = rng.integers(0, vocab, (n, wl.tuple_terms))
        sub_terms = rng.integers(0, vocab, (q, wl.sub_terms))
        ins = ((pts[:, None, 0] >= rects[None, :, 0])
               & (pts[:, None, 0] <= rects[None, :, 2])
               & (pts[:, None, 1] >= rects[None, :, 1])
               & (pts[:, None, 1] <= rects[None, :, 3]))
        covered = np.array([[set(s) <= set(t) for s in sub_terms]
                            for t in terms])
        exact = ins & covered
        pc, qc = CPU.keyword_match_counts(
            pts, bucket_masks(hasher.buckets(terms), hasher.n_buckets),
            rects, hasher.sub_masks(sub_terms))
        assert (pc >= exact.sum(1)).all() and (qc >= exact.sum(0)).all()
        if injective:
            used = np.unique(np.concatenate([terms.ravel(),
                                             sub_terms.ravel()]))
            assert len(np.unique(hasher.buckets(used))) == len(used)
            np.testing.assert_array_equal(pc, exact.sum(1))
        else:
            assert pc.sum() > exact.sum()     # collisions do overcount
