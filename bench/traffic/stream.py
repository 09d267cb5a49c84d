"""The one traffic generator: a traffic mix file's parameters → one whole
replay cycle of tuples, their terms, and the standing and burst queries.

A frozen copy of the semantics of ``repro_torch.streaming.sources`` (the
geotagged-tweet city mixture, the Fig-12 hotspot box with its query
burst, the trending hashtags that travel along a path, the Zipf term
vocabulary), kept here so that the benchmark, and not the program,
owns what it feeds the system.  Two deliberate differences:

* the city layout is drawn from the mix's own ``layout_seed``: the map
  is part of the deployment, and ``--seed`` draws only which tuples,
  queries and terms arrive, so every seed offers the same amount and
  shape of work;
* each tick's batch is shuffled, so the prefix the engine injects when
  backpressure throttles the spout keeps the tick's mix.

Everything is drawn in set-up; nothing here runs in the timed window.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Traffic:
    """One replay cycle.  ``points[t]`` is tick ``t``'s full batch of
    ``lambda_max`` tuples; ``terms[t]`` their vocabulary term ids
    (``None`` for a spatial mix); ``queries`` the standing set with
    ``query_terms``; ``burst`` maps a tick of the first cycle to the
    rects (and terms) that register then."""

    points: np.ndarray                   # (T, B, 2) float32
    terms: np.ndarray | None             # (T, B, K) int64
    queries: np.ndarray                  # (Q, 4) float32
    query_terms: np.ndarray | None       # (Q, Ks) int64
    burst: dict                          # tick → (rects, terms | None)

    @property
    def cycle(self) -> int:
        return self.points.shape[0]


def rects_around(foci: np.ndarray, side: float) -> np.ndarray:
    half = side / 2
    return np.clip(np.concatenate([foci - half, foci + half], axis=1),
                   0.0, 0.999).astype(np.float32)


class _Mixture:
    """The background stream: Gaussian city clusters with heavy-tailed
    sizes over the unit square."""

    def __init__(self, p: dict):
        rng = np.random.default_rng(int(p["layout_seed"]))
        n = int(p["cities"])
        self.centers = rng.uniform(0.05, 0.95, size=(n, 2))
        w = rng.pareto(float(p["size_tail"]), size=n) + 0.05
        self.weights = w / w.sum()
        self.scales = rng.uniform(float(p["scale_min"]),
                                  float(p["scale_max"]), size=n)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.choice(len(self.weights), size=n, p=self.weights)
        pts = (self.centers[idx]
               + rng.normal(0.0, 1.0, size=(n, 2)) * self.scales[idx, None])
        return np.clip(pts, 0.0, 0.999).astype(np.float32)


def _bell(t: int, start: int, duration: int, peak: float,
          temporal: str = "normal") -> float:
    u = t - start
    if u < 0 or u >= duration:
        return 0.0
    if temporal == "step":
        return peak
    mid, sig = duration / 2, duration / 6
    return peak * float(np.exp(-0.5 * ((u - mid) / sig) ** 2))


def _window(spec: dict) -> tuple[int, int]:
    return int(spec["start"]), int(spec["duration"])


def _hotspot_points(rng, h: dict, n: int) -> np.ndarray:
    cx, cy = h["corner"]
    s = float(h["side"])
    if h["spatial"] == "normal":
        pts = rng.normal(0.0, 0.2 * s, size=(n, 2)) + [cx + s / 2, cy + s / 2]
        pts = np.clip(pts, [cx, cy], [cx + s, cy + s])
    else:
        pts = rng.uniform([cx, cy], [cx + s, cy + s], size=(n, 2))
    return pts.astype(np.float32)


def _term_center(ht: dict, t: int, start: int, duration: int) -> np.ndarray:
    u = np.clip((t - start) / max(duration - 1, 1), 0.0, 1.0)
    (x0, y0), (x1, y1) = ht["path"]
    return np.array([x0 + u * (x1 - x0), y0 + u * (y1 - y0)])


def generate(mix: dict, system: dict, seed: int) -> Traffic:
    """One replay cycle of the mix ``mix`` for the deployment ``system``
    (``lambda_max``, ``queries``, ``query_side``, ``tuple_terms``,
    ``sub_terms``), drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    cycle = int(mix["cycle_ticks"])
    b = int(system["lambda_max"])
    side = float(system["query_side"])
    k_tuple = int(system.get("tuple_terms", 0))
    k_sub = int(system.get("sub_terms", 0))
    base = _Mixture(mix["mixture"])
    hotspots = mix.get("hotspots", [])
    hot_terms = mix.get("hot_terms", [])
    vocab = int(mix.get("vocab", 0))
    term_p = None
    if vocab:
        w = 1.0 / np.power(np.arange(vocab, dtype=np.float64) + 1.0,
                           float(mix["zipf"]))
        term_p = w / w.sum()

    points = np.empty((cycle, b, 2), np.float32)
    terms = (np.empty((cycle, b, k_tuple), np.int64)
             if k_tuple and term_p is not None else None)
    for t in range(cycle):
        fr = [_bell(t, *_window(h), float(h["peak_fraction"]),
                    h["temporal"]) for h in hotspots]
        total = min(float(sum(fr)), 0.95)
        counts = ([int(b * f / sum(fr) * total) for f in fr]
                  if total > 0 else [])
        parts = [base.sample(rng, b - sum(counts))]
        parts += [_hotspot_points(rng, h, c)
                  for h, c in zip(hotspots, counts) if c > 0]
        pts = np.concatenate(parts)
        off = 0
        for ht in hot_terms:                 # geo-local trends
            st, du = _window(ht)
            c = int(b * _bell(t, st, du, float(ht["peak_fraction"])))
            if c > 0:
                ctr = _term_center(ht, t, st, du)
                pts[off:off + c] = np.clip(
                    ctr + rng.normal(0.0, float(ht["radius"]), size=(c, 2)),
                    0.0, 0.999)
                off += c
        if terms is not None:
            tt = rng.choice(vocab, size=(b, k_tuple), p=term_p)
            for ht in hot_terms:
                st, du = _window(ht)
                if _bell(t, st, du, float(ht["peak_fraction"])) <= 0:
                    continue
                ctr = _term_center(ht, t, st, du)
                d2 = ((pts.astype(np.float64) - ctr) ** 2).sum(1)
                near = d2 <= (2.5 * float(ht["radius"])) ** 2
                tag = near & (rng.random(b) < float(ht["term_prob"]))
                tt[tag, 0] = int(ht["term"])
        order = rng.permutation(b)
        points[t] = pts[order]
        if terms is not None:
            terms[t] = tt[order]

    def sub_terms(n: int):
        if not k_sub or term_p is None:
            return None
        return rng.choice(vocab, size=(n, k_sub), p=term_p).astype(np.int64)

    queries = rects_around(base.sample(rng, int(system["queries"])), side)
    query_terms = sub_terms(len(queries))
    burst = {}
    for h in hotspots:                      # the first minute of the box
        n = int(h.get("query_burst", 0)) // int(h["burst_ticks"])
        if n <= 0:
            continue
        st, _ = _window(h)
        for t in range(st, st + int(h["burst_ticks"])):
            rects = rects_around(_hotspot_points(rng, h, n), side)
            terms_t = sub_terms(n)
            if t in burst:                  # two boxes open on one tick
                r0, k0 = burst[t]
                rects = np.concatenate([r0, rects])
                terms_t = None if k0 is None else np.concatenate([k0, terms_t])
            burst[t] = (rects, terms_t)
    return Traffic(points, terms, queries, query_terms, burst)
