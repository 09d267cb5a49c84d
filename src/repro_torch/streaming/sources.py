"""Synthetic spatial stream sources (paper §6 experimental setup).

The background stream mimics geotagged tweets: a mixture of Gaussian
"city" clusters over the unit square with heavy skew.  Hotspot scenarios
reproduce Figs 12–16 by redirecting a time-varying fraction of the
stream into a hotspot box (side = 15 % of the space, per the paper),
with uniform or normal spatial distribution inside the box and normal /
step temporal intensity.

Queries are continuous range queries whose focal points follow the data
distribution; side length defaults to 0.16 % of the space (paper: "about
the size of a university campus").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Paper: query side = 0.16 % of the space with 1M–32M queries.  The
# simulation runs ~10³× fewer queries, so the default side is scaled up
# (×12.5) to keep query *density* — and hence match-work per tuple — in
# the same regime.  Benchmarks may override.
QUERY_SIDE = 0.02
HOTSPOT_SIDE = 0.15


@dataclass(frozen=True)
class MembershipEvent:
    """One scheduled cluster-membership change on a scenario timeline.

    ``kind`` is ``"fail"`` (crash-stop), ``"join"`` (a machine slot
    becomes/returns active at ``factor`` × nominal capacity) or
    ``"slow"`` (the slot's capacity factor changes — a straggler when
    < 1, recovery when back to 1).  ``streaming.api.EventStream``
    converts entries into the typed ``MachineFailure`` / ``MachineJoin``
    / ``MachineSlow`` events the engine applies; the schedule is fully
    deterministic, so the fused engine path cuts scan windows at these
    ticks without consuming any RNG."""

    tick: int
    kind: str          # "fail" | "join" | "slow"
    machine: int
    factor: float = 1.0


def rects_around(foci: np.ndarray, side: float) -> np.ndarray:
    """Axis-aligned rects of side ``side`` centered on ``foci``,
    clipped into the unit space — the one home of the query/probe
    rectangle convention."""
    half = side / 2
    return np.clip(np.concatenate([foci - half, foci + half], axis=1),
                   0.0, 0.999).astype(np.float32)


def make_city_mixture(rng: np.random.Generator, n_cities: int = 24):
    """Weights/centers/scales for the Twitter-like background mixture."""
    centers = rng.uniform(0.05, 0.95, size=(n_cities, 2))
    weights = rng.pareto(1.2, size=n_cities) + 0.05  # heavy-tailed city sizes
    weights /= weights.sum()
    scales = rng.uniform(0.005, 0.04, size=n_cities)
    return weights, centers, scales


@dataclass
class TwitterLikeSource:
    """Background stream: skewed, slowly-varying mixture of city clusters."""

    seed: int = 0
    n_cities: int = 24
    drift: float = 0.0  # per-tick weight drift (time-zone effect)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.weights, self.centers, self.scales = make_city_mixture(
            self.rng, self.n_cities)

    def sample_points(self, n: int, tick: int = 0) -> np.ndarray:
        w = self.weights
        if self.drift > 0:  # rotate activity across cities over time
            phase = 2 * np.pi * (np.arange(self.n_cities) / self.n_cities)
            mod = 1.0 + 0.8 * np.sin(self.drift * tick + phase)
            w = w * np.clip(mod, 0.05, None)
            w = w / w.sum()
        idx = self.rng.choice(self.n_cities, size=n, p=w)
        pts = self.centers[idx] + self.rng.normal(
            0.0, 1.0, size=(n, 2)) * self.scales[idx, None]
        return np.clip(pts, 0.0, 0.999).astype(np.float32)

    def sample_queries(self, n: int, side: float = QUERY_SIDE,
                       tick: int = 0) -> np.ndarray:
        return rects_around(self.sample_points(n, tick), side)


@dataclass
class Hotspot:
    """One hotspot: a box, a temporal intensity profile, a spatial law."""

    corner: tuple[float, float]           # lower-left of the hotspot box
    side: float = HOTSPOT_SIDE
    start: int = 0                        # tick the hotspot begins
    duration: int = 200
    peak_fraction: float = 0.4            # max share of spouts redirected
    temporal: str = "normal"              # "normal" | "step"
    spatial: str = "uniform"              # "uniform" | "normal"
    query_burst: int = 0                  # hotspot queries, all in 1st minute

    def fraction(self, tick: int) -> float:
        t = tick - self.start
        if t < 0 or t >= self.duration:
            return 0.0
        if self.temporal == "step":
            return self.peak_fraction
        mid, sig = self.duration / 2, self.duration / 6
        return self.peak_fraction * float(np.exp(-0.5 * ((t - mid) / sig) ** 2))

    def sample_inside(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cx, cy = self.corner
        if self.spatial == "normal":
            var = 0.2 * self.side  # paper: variance 20 % of hotspot side
            pts = rng.normal(0.0, var, size=(n, 2)) + np.array(
                [cx + self.side / 2, cy + self.side / 2])
            pts = np.clip(pts, [cx, cy], [cx + self.side, cy + self.side])
        else:
            pts = rng.uniform([cx, cy], [cx + self.side, cy + self.side], size=(n, 2))
        return pts.astype(np.float32)

    def burst_queries(self, rng: np.random.Generator, tick: int,
                      side: float = QUERY_SIDE) -> np.ndarray:
        """All hotspot queries are instantiated during the first minute
        (= first ~4 ticks at 15 s/tick) of the hotspot."""
        burst_ticks = 4
        t = tick - self.start
        if self.query_burst <= 0 or t < 0 or t >= burst_ticks:
            return np.zeros((0, 4), np.float32)
        n = self.query_burst // burst_ticks
        return rects_around(self.sample_inside(rng, n), side)


@dataclass(frozen=True)
class HotTerm:
    """A trending hashtag that *migrates across the grid*: a term that
    spikes in popularity while its geographic focus travels along
    ``path``.  This decouples textual skew from spatial skew — the
    delivery hot set moves even though the background spatial mixture
    is unchanged, which is exactly the load a spatial-only balancer
    cannot see coming and a cost-driven one (SWARM) can.

    ``term`` should be a low Zipf rank (popular vocabulary id) so
    subscriptions sampled from the same vocabulary actually subscribe
    to it.  ``fraction(tick)`` is the share of the stream redirected to
    the moving focus; redirected tuples carry the term with probability
    ``term_prob``."""

    term: int
    start: int = 0
    duration: int = 200
    peak_fraction: float = 0.4
    path: tuple[tuple[float, float], tuple[float, float]] = (
        (0.1, 0.1), (0.85, 0.85))
    radius: float = 0.06
    term_prob: float = 0.9

    def fraction(self, tick: int) -> float:
        t = tick - self.start
        if t < 0 or t >= self.duration:
            return 0.0
        mid, sig = self.duration / 2, self.duration / 6
        return self.peak_fraction * float(
            np.exp(-0.5 * ((t - mid) / sig) ** 2))

    def center(self, tick: int) -> np.ndarray:
        """Linearly-interpolated focus position at ``tick``."""
        t = np.clip((tick - self.start) / max(self.duration - 1, 1), 0.0, 1.0)
        (x0, y0), (x1, y1) = self.path
        return np.array([x0 + t * (x1 - x0), y0 + t * (y1 - y0)])

    def sample_inside(self, rng: np.random.Generator, n: int,
                      tick: int) -> np.ndarray:
        pts = self.center(tick) + rng.normal(0.0, self.radius, size=(n, 2))
        return np.clip(pts, 0.0, 0.999).astype(np.float32)


@dataclass
class ScenarioSource:
    """Background + hotspots, driving one experiment timeline.

    ``query_side`` sets the rectangle side of every continuous query the
    scenario emits (range queries use the campus-scale default; the kNN
    model routes by a smaller influence region around the focal point).
    Snapshot probes are emitted by ``snapshot_arrivals`` and follow the
    *data* distribution — people ask about where things are happening —
    so probe hotspots track data hotspots, which is what makes
    stored-data workloads stress the balancer.

    Spatial-keyword scenarios add a ``vocab``-sized term vocabulary
    with Zipf-distributed popularity (``sample_terms`` /
    ``sample_subscription_terms``) and optional :class:`HotTerm`
    timelines.  A scenario without hot terms and whose workload never
    asks for terms consumes *exactly* the RNG stream of the
    pure-spatial scenarios — existing goldens are untouched."""

    base: TwitterLikeSource
    hotspots: list[Hotspot] = field(default_factory=list)
    query_side: float = QUERY_SIDE
    membership: tuple[MembershipEvent, ...] = ()
    snapshot_every: int = 1     # probe-arrival period (ticks)
    vocab: int = 2000           # term vocabulary size (keyword workloads)
    hot_terms: tuple[HotTerm, ...] = ()
    # seeded fault injection (ft.chaos.ChaosSpec): carried on the
    # scenario like the membership timeline; the engine compiles it to
    # a concrete schedule (it knows the machine count), entirely on a
    # chaos-seed-derived RNG — the source stream is untouched
    chaos: object | None = None

    def __post_init__(self):
        # Zipf popularity over the vocabulary (deterministic, no RNG)
        ranks = np.arange(max(self.vocab, 1), dtype=np.float64)
        w = 1.0 / np.power(ranks + 1.0, 1.05)
        self._term_p = w / w.sum()

    def sample_points(self, n: int, tick: int) -> np.ndarray:
        rng = self.base.rng
        fracs = np.array([h.fraction(tick) for h in self.hotspots])
        total = float(fracs.sum())
        if total <= 0:
            pts = self.base.sample_points(n, tick)
        else:
            total = min(total, 0.95)
            counts = (n * fracs / max(fracs.sum(), 1e-9) * total).astype(int)
            parts = [self.base.sample_points(n - int(counts.sum()), tick)]
            for h, c in zip(self.hotspots, counts):
                if c > 0:
                    parts.append(h.sample_inside(rng, int(c)))
            pts = np.concatenate(parts, axis=0)
        return self._redirect_hot_terms(pts, tick)

    def _redirect_hot_terms(self, pts: np.ndarray, tick: int) -> np.ndarray:
        """Geo-localize trending terms: move a ``fraction(tick)`` share
        of the batch to each active hot term's travelling focus, so the
        textual spike is also a (moving) spatial concentration — a
        geo-local trend, not a uniform background hum.  Consumes RNG
        only when a hot term is active (pure-spatial RNG streams are
        bit-identical when ``hot_terms`` is empty)."""
        off = 0
        for ht in self.hot_terms:
            f = ht.fraction(tick)
            c = int(len(pts) * f)
            if c <= 0:
                continue
            pts = pts.copy() if off == 0 else pts
            pts[off:off + c] = ht.sample_inside(self.base.rng, c, tick)
            off += c
        return pts

    # -- term sampling (spatial-keyword workloads only) ------------------
    def sample_terms(self, xy: np.ndarray, tick: int,
                     k: int) -> np.ndarray:
        """(N, k) int64 vocabulary term ids for a tuple batch.  Tuples
        near an active hot term's focus carry that term in slot 0 with
        probability ``term_prob`` — the textual spike rides on the
        spatial concentration ``_redirect_hot_terms`` created.
        Consumes no RNG when ``k <= 0``."""
        n = len(xy)
        if k <= 0:
            return np.zeros((n, 0), np.int64)
        rng = self.base.rng
        terms = rng.choice(self.vocab, size=(n, k),
                           p=self._term_p).astype(np.int64)
        for ht in self.hot_terms:
            if ht.fraction(tick) <= 0:
                continue
            d2 = ((np.asarray(xy, np.float64)
                   - ht.center(tick)) ** 2).sum(1)
            near = d2 <= (2.5 * ht.radius) ** 2
            tag = near & (rng.random(n) < ht.term_prob)
            terms[tag, 0] = ht.term
        return terms

    def sample_subscription_terms(self, n: int, tick: int,
                                  k: int) -> np.ndarray:
        """(N, k) int64 term ids for registered subscriptions — pure
        Zipf, so popular (low-rank) terms are heavily subscribed and a
        hot term with a low rank hits a large standing audience.
        Consumes no RNG when ``k <= 0``."""
        if k <= 0:
            return np.zeros((n, 0), np.int64)
        return self.base.rng.choice(self.vocab, size=(n, k),
                                    p=self._term_p).astype(np.int64)

    def query_arrivals(self, tick: int) -> np.ndarray:
        rects = [h.burst_queries(self.base.rng, tick, side=self.query_side)
                 for h in self.hotspots]
        rects = [r for r in rects if len(r)]
        if not rects:
            return np.zeros((0, 4), np.float32)
        return np.concatenate(rects, axis=0)

    def sample_queries(self, n: int, tick: int = 0) -> np.ndarray:
        """Preload queries at this scenario's query side."""
        return self.base.sample_queries(n, side=self.query_side, tick=tick)

    def snapshot_arrivals(self, tick: int, rate: int,
                          side: float) -> np.ndarray:
        """One-shot probe rectangles for the SNAPSHOT query model.
        Probes arrive every ``snapshot_every`` ticks (a burst of
        ``rate × snapshot_every`` probes, so the mean probe rate is
        period-invariant); off-schedule ticks emit nothing, which is
        what lets probe workloads fuse between arrivals."""
        if rate <= 0 or tick % max(self.snapshot_every, 1):
            return np.zeros((0, 4), np.float32)
        n = int(rate) * max(self.snapshot_every, 1)
        return rects_around(self.sample_points(n, tick), side)

    def next_probe_arrival(self, tick: int) -> int:
        """First tick ≥ ``tick`` on the deterministic probe schedule
        (every ``snapshot_every`` ticks) — consumes no RNG, so the
        fused engine path can cut its scan windows here."""
        k = max(self.snapshot_every, 1)
        return tick if tick % k == 0 else (tick // k + 1) * k

    def membership_events(self, tick: int) -> list[MembershipEvent]:
        """Scheduled membership changes firing at exactly ``tick``."""
        return [e for e in self.membership if e.tick == tick]

    def next_membership_event(self, tick: int) -> int | None:
        ts = [e.tick for e in self.membership if e.tick >= tick]
        return min(ts) if ts else None

    def next_query_arrival(self, tick: int) -> int | None:
        """First tick ≥ ``tick`` whose ``query_arrivals`` is non-empty,
        or ``None``.  Burst windows are deterministic (hotspot start +
        the 4-tick first minute), so the fused engine path can cut its
        scan windows without consuming the RNG."""
        nxt = None
        for h in self.hotspots:
            if h.query_burst < 4:     # burst//4 == 0 emits nothing
                continue
            c = max(tick, h.start)
            if c < h.start + 4 and (nxt is None or c < nxt):
                nxt = c
        return nxt


@dataclass
class ReplaySource:
    """Pre-generated point pool served as cyclic slices.

    Takes source synthesis (mixture sampling is itself a hot loop) off
    the measured path of engine-throughput benchmarks — a deployed
    system reads tuples from network buffers, it does not synthesize
    them.  Queries delegate to a ``TwitterLikeSource`` so routers still
    see a realistic resident set; the arrival schedule is empty."""

    pool: np.ndarray
    base: TwitterLikeSource | None = None
    query_side: float = QUERY_SIDE
    cursor: int = 0
    snapshot_every: int = 1
    vocab: int = 2000
    # grid size for precomputed ingest-tier cell ids (0 = off).  Cell
    # ids depend only on the grid geometry, never on the routing plan,
    # so computing them once at pool-construction time is static data
    # prep — exactly like the pooled points themselves.  Batches then
    # carry ``TupleBatch.cells`` and cell-hungry planes (the sharded
    # device plane) skip the per-window point→cell pass.
    cell_grid: int = 0

    def __post_init__(self):
        if self.base is None:
            self.base = TwitterLikeSource()
        ranks = np.arange(max(self.vocab, 1), dtype=np.float64)
        w = 1.0 / np.power(ranks + 1.0, 1.05)
        self._term_p = w / w.sum()
        self.last_cells: np.ndarray | None = None
        self._cells: np.ndarray | None = None
        if self.cell_grid:
            from ..core import geometry
            g = int(self.cell_grid)
            row, col = geometry.points_to_cells(
                np.asarray(self.pool, np.float32), g)
            self._cells = row.astype(np.int64) * g + col

    def sample_terms(self, xy: np.ndarray, tick: int, k: int) -> np.ndarray:
        if k <= 0:
            return np.zeros((len(xy), 0), np.int64)
        return self.base.rng.choice(self.vocab, size=(len(xy), k),
                                    p=self._term_p).astype(np.int64)

    def sample_subscription_terms(self, n: int, tick: int,
                                  k: int) -> np.ndarray:
        if k <= 0:
            return np.zeros((n, 0), np.int64)
        return self.base.rng.choice(self.vocab, size=(n, k),
                                    p=self._term_p).astype(np.int64)

    def sample_points(self, n: int, tick: int = 0) -> np.ndarray:
        n, size = int(n), len(self.pool)
        lo = self.cursor
        self.cursor = (lo + n) % size
        if lo + n <= size:
            if self._cells is not None:
                self.last_cells = self._cells[lo:lo + n]
            return self.pool[lo:lo + n]
        # wraps (possibly several times for n > pool size): gather by
        # modular index so the batch always has exactly n points
        idx = (lo + np.arange(n)) % size
        if self._cells is not None:
            self.last_cells = self._cells[idx]
        return self.pool[idx]

    def sample_queries(self, n: int, tick: int = 0) -> np.ndarray:
        return self.base.sample_queries(n, side=self.query_side, tick=tick)

    def query_arrivals(self, tick: int) -> np.ndarray:
        return np.zeros((0, 4), np.float32)

    def snapshot_arrivals(self, tick: int, rate: int,
                          side: float) -> np.ndarray:
        if rate <= 0 or tick % max(self.snapshot_every, 1):
            return np.zeros((0, 4), np.float32)
        n = int(rate) * max(self.snapshot_every, 1)
        return rects_around(self.sample_points(n, tick), side)

    def next_probe_arrival(self, tick: int) -> int:
        k = max(self.snapshot_every, 1)
        return tick if tick % k == 0 else (tick // k + 1) * k

    def next_query_arrival(self, tick: int) -> int | None:
        return None


# ---------------------------------------------------------------------------
# The five paper scenarios (Figs 12–16).  Ticks are load-balancing rounds
# (15 s in the paper); default timelines span ~60 min.
# ---------------------------------------------------------------------------

def scenario(name: str, seed: int = 0, horizon: int = 240,
             peak: float = 0.4, query_burst: int = 2000,
             query_side: float = QUERY_SIDE,
             membership: tuple[MembershipEvent, ...] = (),
             snapshot_every: int = 1, vocab: int = 2000,
             hot_terms: tuple[HotTerm, ...] = (),
             term_peak: float = 0.0,
             chaos=None) -> ScenarioSource:
    base = TwitterLikeSource(seed=seed)
    lo, hi = (0.05, 0.05), (0.80, 0.80)  # lower-left / upper-right corners
    span = (horizon // 3, horizon // 3)  # hotspot occupies the middle third
    start, dur = span
    mk = lambda corner, temporal, spatial, st, pf: Hotspot(
        corner, start=st, duration=dur, peak_fraction=pf, temporal=temporal,
        spatial=spatial, query_burst=query_burst)
    if name == "uniform_normal":        # Fig 12
        hs = [mk(lo, "normal", "uniform", start, peak)]
    elif name == "normal_normal":       # Fig 13
        hs = [mk(lo, "normal", "normal", start, peak)]
    elif name == "uniform_step":        # Fig 14
        hs = [mk(lo, "step", "uniform", start, peak)]
    elif name == "two_overlapping":     # Fig 15
        hs = [mk(lo, "normal", "uniform", start, peak / 2),
              mk(hi, "normal", "uniform", start + dur // 4, peak / 2)]
    elif name == "two_consecutive":     # Fig 16
        d2 = dur // 2
        h1 = Hotspot(lo, start=start, duration=d2, peak_fraction=peak,
                     temporal="normal", spatial="uniform", query_burst=query_burst)
        h2 = Hotspot(hi, start=start + d2, duration=d2, peak_fraction=peak,
                     temporal="normal", spatial="uniform", query_burst=query_burst)
        hs = [h1, h2]
    elif name == "hot_hashtags":        # spatial-keyword pub/sub scenario
        # no spatial hotspots: ALL skew is textual + the geo-local
        # focus each trending term drags across the grid.  Two popular
        # terms (Zipf ranks 0 and 1) trend on crossing diagonals.
        hs = []
        if not hot_terms:
            st, dur = horizon // 6, 2 * horizon // 3
            pf = term_peak if term_peak > 0 else peak
            hot_terms = (
                HotTerm(0, start=st, duration=dur, peak_fraction=pf / 2,
                        path=((0.1, 0.1), (0.85, 0.85))),
                HotTerm(1, start=st, duration=dur, peak_fraction=pf / 2,
                        path=((0.85, 0.1), (0.1, 0.85))),
            )
    elif name == "none":
        hs = []
    else:
        raise ValueError(f"unknown scenario {name!r}")
    return ScenarioSource(base, hs, query_side=query_side,
                          membership=tuple(membership),
                          snapshot_every=snapshot_every,
                          vocab=vocab, hot_terms=tuple(hot_terms),
                          chaos=chaos)
