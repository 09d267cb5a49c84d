"""Declarative experiment suite: router spec × scenario spec ×
workload × engine config, seeds threaded end-to-end.

The pre-redesign ``run_experiment(router, source, ...)`` took fully
constructed objects, and its ``seed=`` parameter silently did nothing
(the engine kept a never-used rng while the source sampled from its
construction-time seed).  An :class:`Experiment` is instead a frozen
*description*: :func:`run` builds the source, the router (with its data
plane) and the engine from the spec, deriving every rng from
``Experiment.seed`` — same seed, same metrics, bit for bit.

``run_suite``/``sweep`` drive the benchmark matrix and tests uniformly::

    results = run_suite(sweep(
        routers=[RouterSpec("swarm"), RouterSpec("static_history")],
        scenarios=[ScenarioSpec("uniform_normal", ticks=90)],
        workloads=all_workloads(),
        seeds=(0, 1, 2),
        data_planes=("numpy", "torch"),
    ))

The engine's run mode is part of the spec: ``EngineConfig(
fused_window=W)`` makes :func:`run` drive the device-resident fused
path (``StreamingEngine.run_fused``), and — like any non-default
engine field — it is folded into ``Experiment.label``, so per-tick vs
fused sweeps cannot collide.
"""
from __future__ import annotations

import hashlib
import itertools
import re
from dataclasses import dataclass, field, replace

import numpy as np

from ..ft import ChaosSpec
from ..queries import QueryModel, WorkloadSpec
from ..telemetry import Stopwatch, Tracer
from .api import Router
from .baselines import (ReplicatedRouter, StaticHistoryRouter,
                        StaticUniformRouter, SwarmRouter)
from .engine import EngineConfig, Metrics, StreamingEngine
from .sources import (QUERY_SIDE, MembershipEvent, ScenarioSource,
                      TwitterLikeSource, scenario)

ROUTER_KINDS = ("replicated", "static_uniform", "static_history", "swarm")


def _nondefault_fields(spec) -> str:
    """``"a=1,b=2"`` for every dataclass field differing from its
    default — the label suffix that keeps swept specs distinguishable
    (and default specs' labels unchanged)."""
    import dataclasses
    parts = []
    for f in dataclasses.fields(spec):
        if f.default is dataclasses.MISSING:
            continue
        v = getattr(spec, f.name)
        if v != f.default:
            parts.append(f"{f.name}={v}")
    return ",".join(parts)


def workload_query_side(workload: WorkloadSpec | None) -> float:
    """Continuous-query rectangle side for a workload (kNN routes by its
    much smaller influence region)."""
    return (workload.knn_side
            if workload is not None and workload.query_model is QueryModel.KNN
            else QUERY_SIDE)


@dataclass(frozen=True)
class RouterSpec:
    """How to build one of the four routing systems."""

    kind: str = "swarm"
    grid_size: int = 64
    beta: int = 8
    decay: float = 0.5
    max_pairs: int = 1               # concurrent m_H→m_L pairs per round
    history_points: int = 4000       # static_history sample sizes
    history_queries: int = 2000
    history_rounds: int = 20
    history_seed: int | None = None  # default: experiment seed + 1
    # geo extensions (swarm only): fold the engine topology's per-link
    # cost matrix into pair matching, and/or arm the cost-trend
    # rebalance trigger (DESIGN.md §12).  Defaults keep the paper scan.
    link_aware: bool = False
    trend_window: int = 0
    trend_threshold: float = 0.35

    def build(self, *, num_machines: int,
              workload: WorkloadSpec | None = None,
              data_plane: str | None = None, seed: int = 0,
              standby: int = 0, link_cost=None) -> Router:
        kw = {"workload": workload, "data_plane": data_plane,
              "standby": standby}
        if self.kind == "replicated":
            return ReplicatedRouter(num_machines, self.grid_size, **kw)
        if self.kind == "static_uniform":
            return StaticUniformRouter(self.grid_size, num_machines, **kw)
        if self.kind == "static_history":
            hseed = self.history_seed if self.history_seed is not None \
                else seed + 1
            base = TwitterLikeSource(seed=hseed)
            # keep the original RNG order (points, then queries), and
            # balance the frozen plan for the query footprint it serves
            hist_pts = base.sample_points(self.history_points)
            hist_q = base.sample_queries(self.history_queries,
                                         side=workload_query_side(workload))
            return StaticHistoryRouter(self.grid_size, num_machines,
                                       hist_pts, hist_q,
                                       rounds=self.history_rounds, **kw)
        if self.kind == "swarm":
            return SwarmRouter(self.grid_size, num_machines, beta=self.beta,
                               decay=self.decay, max_pairs=self.max_pairs,
                               link_cost=(link_cost if self.link_aware
                                          else None),
                               trend_window=self.trend_window,
                               trend_threshold=self.trend_threshold,
                               **kw)
        raise ValueError(f"unknown router kind {self.kind!r}; "
                         f"one of {ROUTER_KINDS}")


@dataclass(frozen=True)
class ScenarioSpec:
    """How to build one scenario timeline (paper Figs 11–16).

    ``membership`` is a deterministic schedule of cluster-membership
    changes (:class:`~repro.streaming.sources.MembershipEvent`): kills,
    joins and capacity changes become a sweepable dimension of the
    experiment suite, exactly like hotspots.  ``snapshot_every`` sets
    the probe-arrival period of snapshot workloads (probes burst every
    k ticks at rate×k, so the mean rate is period-invariant and fused
    windows can run between arrivals)."""

    name: str = "uniform_normal"
    ticks: int = 90
    preload_queries: int = 3000
    query_burst: int = 500
    peak: float = 0.4
    membership: tuple[MembershipEvent, ...] = ()
    # seeded fault injection (ft.chaos.ChaosSpec | None): dropped and
    # delayed heartbeats, transient partitions, interrupted transfers —
    # a sweepable timeline dimension exactly like ``membership``
    chaos: ChaosSpec | None = None
    snapshot_every: int = 1
    # spatial-keyword knobs: count of auto-generated trending HotTerm
    # timelines (scenario "hot_hashtags"), their peak redirected stream
    # fraction, and a non-default vocabulary size (0 = scenario default)
    hot_terms: int = 0
    term_peak: float = 0.0
    vocab: int = 0

    @property
    def key(self) -> str:
        default = type(self).__dataclass_fields__["peak"].default
        peak = "" if self.peak == default else f",peak={self.peak}"
        mb = ""
        if self.membership:
            mb = "," + "+".join(
                f"{e.kind}@{e.tick}:m{e.machine}"
                + (f"x{e.factor}" if e.kind != "fail" and e.factor != 1.0
                   else "")
                for e in self.membership)
        snap = ("" if self.snapshot_every == 1
                else f",snap/{self.snapshot_every}")
        ch = "" if self.chaos is None else f",{self.chaos}"
        ht = ("" if not self.hot_terms
              else f",ht={self.hot_terms}x{self.term_peak}")
        vb = "" if not self.vocab else f",vocab={self.vocab}"
        return (f"{self.name}[{self.ticks}t,{self.preload_queries}q,"
                f"{self.query_burst}b{peak}{mb}{snap}{ch}{ht}{vb}]")

    def build(self, *, seed: int = 0,
              workload: WorkloadSpec | None = None) -> ScenarioSource:
        kw = {}
        if self.vocab:
            kw["vocab"] = self.vocab
        if self.term_peak:
            kw["term_peak"] = self.term_peak
        if self.hot_terms:
            # deterministic trending-term timelines: popular Zipf ranks
            # 0..n−1 on alternating diagonal paths, peaks splitting the
            # requested stream share
            from .sources import HotTerm
            st, dur = self.ticks // 6, max(2 * self.ticks // 3, 1)
            pf = (self.term_peak or self.peak) / self.hot_terms
            paths = (((0.1, 0.1), (0.85, 0.85)), ((0.85, 0.1), (0.1, 0.85)),
                     ((0.1, 0.85), (0.85, 0.1)), ((0.85, 0.85), (0.1, 0.1)))
            kw["hot_terms"] = tuple(
                HotTerm(i, start=st, duration=dur, peak_fraction=pf,
                        path=paths[i % len(paths)])
                for i in range(self.hot_terms))
        return scenario(self.name, seed=seed, horizon=self.ticks,
                        peak=self.peak, query_burst=self.query_burst,
                        query_side=workload_query_side(workload),
                        membership=self.membership,
                        snapshot_every=self.snapshot_every,
                        chaos=self.chaos, **kw)


@dataclass(frozen=True)
class Experiment:
    """One fully specified run.  ``seed`` derives every rng: the source,
    the history sample (seed+1 unless pinned) — nothing else holds
    randomness."""

    router: RouterSpec = field(default_factory=RouterSpec)
    scenario: ScenarioSpec = field(default_factory=ScenarioSpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    engine: EngineConfig = field(default_factory=EngineConfig)
    seed: int = 0
    data_plane: str = "torch"       # the card; "torch-cpu" / "numpy" on host

    @property
    def label(self) -> str:
        """Unique within a suite: every non-default router/engine field
        is folded in, so sweeping e.g. ``max_pairs`` or ``cap_units``
        cannot silently collide (labels are the result key)."""
        router = self.router.kind
        if extra := _nondefault_fields(self.router):
            router = f"{router}[{extra}]"
        engine = _nondefault_fields(self.engine)
        return (f"{router}/{self.scenario.key}/"
                f"{self.workload.label}/{self.data_plane}/seed={self.seed}"
                + (f"/engine[{engine}]" if engine else ""))

    def with_(self, **changes) -> "Experiment":
        return replace(self, **changes)


@dataclass
class ExperimentResult:
    experiment: Experiment
    metrics: Metrics
    wall_s: float
    router: Router
    tracer: Tracer | None = None   # the engine's tracer (telemetry runs)
    # law-check counters from the protocol sanitizer when the run was
    # sanitized (EngineConfig(sanitize=True) / REPRO_SANITIZE=1): a
    # clean run proves the laws were *exercised*, not skipped
    sanitizer_stats: dict | None = None

    @property
    def label(self) -> str:
        return self.experiment.label

    def asarrays(self) -> dict:
        return self.metrics.asarrays()


def safe_label(label: str) -> str:
    """A label flattened to a filesystem-safe trace-file stem.  Long
    labels (geo engine specs fold in links + chaos) are truncated with
    a digest suffix so the stem stays unique and under the 255-byte
    filename limit once ``.trace.json`` is appended."""
    stem = re.sub(r"[^A-Za-z0-9._-]+", "_", label).strip("_")
    if len(stem) > 160:
        digest = hashlib.blake2s(label.encode(), digest_size=4).hexdigest()
        stem = f"{stem[:160].rstrip('_')}__{digest}"
    return stem


def run(exp: Experiment) -> ExperimentResult:
    """Build everything from the spec and run the timeline.  When the
    engine spec carries ``telemetry.trace_dir``, the run's JSONL +
    Perfetto traces are exported there under the experiment label."""
    source = exp.scenario.build(seed=exp.seed, workload=exp.workload)
    # plane names: "numpy", "torch" (the card), "torch-cpu" (explicit
    # CPU); "sharded" raises NotImplementedError in planes.get_plane
    data_plane = exp.data_plane
    link_cost = None
    if exp.engine.links is not None:
        from ..ft import LinkModel
        link_cost = LinkModel(exp.engine.links,
                              exp.engine.num_machines).cost_matrix()
    router = exp.router.build(num_machines=exp.engine.num_machines,
                              workload=exp.workload,
                              data_plane=data_plane, seed=exp.seed,
                              standby=exp.engine.standby_machines,
                              link_cost=link_cost)
    eng = StreamingEngine(router, source, exp.engine)
    with Stopwatch() as sw:
        preload = eng.stream.preload(exp.scenario.preload_queries)
        if preload is not None:
            router.ingest(preload)
        metrics = eng.run(exp.scenario.ticks)
    tracer = eng.tracer if eng.tracer.enabled else None
    if tracer is not None and tracer.config.trace_dir:
        tracer.export(tracer.config.trace_dir, safe_label(exp.label))
    san = dict(eng.san.stats) if eng.san is not None else None
    return ExperimentResult(exp, metrics, sw.s, router, tracer,
                            sanitizer_stats=san)


def sweep(routers=(RouterSpec(),), scenarios=(ScenarioSpec(),),
          workloads=(WorkloadSpec(),), seeds=(0,),
          engine: EngineConfig | None = None,
          data_planes=("torch",)) -> list[Experiment]:
    """The full cartesian product as Experiment specs.  The plane is the
    card unless ``data_planes`` names the host ones ("torch-cpu",
    "numpy")."""
    engine = engine or EngineConfig()
    return [Experiment(router=r, scenario=sc, workload=wl, engine=engine,
                       seed=seed, data_plane=plane)
            for r, sc, wl, seed, plane in itertools.product(
                routers, scenarios, workloads, seeds, data_planes)]


def run_suite(experiments) -> dict[str, ExperimentResult]:
    """Run a batch of experiments; results keyed by ``Experiment.label``.
    Duplicate labels are rejected (they would silently shadow)."""
    results: dict[str, ExperimentResult] = {}
    for exp in experiments:
        if exp.label in results:
            raise ValueError(f"duplicate experiment label {exp.label!r}")
        results[exp.label] = run(exp)
    return results


def mean_uow(result: ExperimentResult, lo: int = 0,
             hi: int | None = None) -> float:
    """Mean units of work over a tick window (benchmark convenience)."""
    uow = np.asarray(result.metrics.units_of_work, float)
    return float(uow[lo:hi].mean())
