"""The frozen generator: one whole cycle from a seed, the same for the
same seed, and every seed offering the same shape of work."""
import numpy as np
import pytest

from _bench_tiny import CELLS, tiny_cell
from traffic import stream


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_cycle(name):
    c = tiny_cell(name)
    a = stream.generate(c.traffic, c.system, 2**31 + 11)
    b = stream.generate(c.traffic, c.system, 2**31 + 11)
    other = stream.generate(c.traffic, c.system, 2**31 + 12)
    assert np.array_equal(a.points, b.points)
    assert np.array_equal(a.queries, b.queries)
    assert sorted(a.burst) == sorted(b.burst)
    for t in a.burst:
        assert np.array_equal(a.burst[t][0], b.burst[t][0])
    if a.terms is not None:
        assert np.array_equal(a.terms, b.terms)
        assert np.array_equal(a.query_terms, b.query_terms)
    assert not np.array_equal(a.points, other.points)


@pytest.mark.parametrize("name", CELLS)
def test_cycle_shape(name):
    c = tiny_cell(name)
    t = stream.generate(c.traffic, c.system, 7)
    cycle, lam = c.traffic["cycle_ticks"], c.system["lambda_max"]
    assert t.points.shape == (cycle, lam, 2)
    assert t.points.dtype == np.float32
    assert ((t.points >= 0) & (t.points < 1)).all()
    assert len(t.queries) == c.system["queries"]
    if c.system["query_model"] == "spatial_keyword":
        assert t.terms.shape == (cycle, lam, c.system["tuple_terms"])
        assert t.query_terms.shape == (len(t.queries), c.system["sub_terms"])
    else:
        assert t.terms is None
        h = c.traffic["hotspots"][0]
        assert sorted(t.burst) == list(range(h["start"],
                                             h["start"] + h["burst_ticks"]))


def test_layout_is_the_mix_not_the_seed():
    """The city map comes from the mix's layout seed: two run seeds draw
    from the same cities, so their per-cell histograms agree closely."""
    c = tiny_cell("range-hotspot")
    g = 8
    hist = []
    for seed in (1, 2):
        pts = stream.generate(c.traffic, c.system, seed).points[0]
        cells = (pts[:, 1] * g).astype(int) * g + (pts[:, 0] * g).astype(int)
        hist.append(np.bincount(cells, minlength=g * g) / len(pts))
    assert np.abs(hist[0] - hist[1]).sum() < 0.15


def test_hot_terms_ride_their_focus():
    c = tiny_cell("pubsub-hashtags")
    t = stream.generate(c.traffic, c.system, 3)
    ht = c.traffic["hot_terms"]
    mid = ht[0]["start"] + ht[0]["duration"] // 2
    share = (t.terms[mid, :, 0] <= 1).mean()
    quiet = (t.terms[0, :, 0] <= 1).mean()
    assert share > quiet + 0.2
