"""Query-execution and data-persistence models (the paper's §2 claim
that SWARM "is able to handle multiple query-execution and
data-persistence models", made concrete).

A *query model* describes how queries consume the stream:

* ``RANGE``    — continuous range queries: each query stays resident on
  its partitions and every incoming tuple is matched against the
  resident set (the behavior the rest of the repro always had).
* ``KNN``      — continuous kNN queries: each query stays resident with
  a focal point and a running top-k result set; an incoming tuple
  updates the top-k heaps of the nearby queries (Tornado-style).  The
  per-candidate work carries an extra ``log2(1+k)`` heap-update factor,
  and the TPU data plane for the top-k reduction is
  ``repro.kernels.knn_match``.
* ``SNAPSHOT`` — snapshot range queries: one-shot probes that scan the
  tuples *stored* on the partitions they overlap and then terminate
  (CheetahGIS-style stored-data streaming).  Tuples pay a deposit cost
  instead of a match cost.

A *persistence model* describes what happens to a tuple after it is
processed:

* ``EPHEMERAL`` — matched and dropped.  Snapshot probes only see a
  short sliding window of recent tuples (``WorkloadSpec.retention``
  decay per tick).
* ``STORED``    — tuples become partition-resident state: they are
  retained indefinitely, they contribute a resident-data term to the
  cost model's N(p) (``data_weight``), they count against executor
  memory, and partition migrations ship the resident tuples' bytes in
  addition to the moved queries' bytes (§5.2 chain-forwarding makes the
  shipment asynchronous; the accounting here bills it on the round that
  moved the partition).

How a query model plugs into engine + protocol
----------------------------------------------
The streaming engine reads ``router.workload`` each tick: continuous
models route ``source.query_arrivals`` through
``router.register_queries`` (resident state, Q' collectors); the
snapshot model routes ``source.snapshot_arrivals`` through
``router.route_snapshots`` (one-shot work items, still feeding the Q'
collectors so SWARM's cost model sees probe hotspots).  Persistence is
realized by ``repro.queries.store.TupleStore``, which the routers
deposit into and which ``core.protocol.Swarm`` migrates alongside
partitions (``RoundReport.moved_tuples`` / ``data_bytes``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class QueryModel(str, enum.Enum):
    RANGE = "range"
    KNN = "knn"
    SNAPSHOT = "snapshot"
    # spatio-textual pub/sub: spatial rect AND keyword conjunction
    # (repro.queries.keywords hashes terms into T buckets; matching is
    # repro.kernels.keyword_match)
    SPATIAL_KEYWORD = "spatial_keyword"


class PersistenceModel(str, enum.Enum):
    EPHEMERAL = "ephemeral"
    STORED = "stored"


@dataclass(frozen=True)
class QueryModelSpec:
    """Execution-model behavior the engine/routers branch on."""

    name: str
    continuous: bool      # queries stay resident (count toward Q(p)/qres)
    tuple_driven: bool    # incoming tuples probe the resident query set
    snapshot: bool        # arrivals are one-shot probes over stored tuples
    keyword: bool = False  # subscriptions carry a keyword conjunction

    def match_factor(self, k: int) -> float:
        """Scaling of the per-candidate match term (1 for range; the
        top-k heap-update factor for kNN; 0 for snapshot, whose work is
        probe-driven instead of tuple-driven)."""
        if not self.tuple_driven:
            return 0.0
        if self.name == QueryModel.KNN:
            return float(np.log2(1.0 + k))
        return 1.0


_REGISTRY: dict[str, QueryModelSpec] = {}


def register_query_model(spec: QueryModelSpec) -> QueryModelSpec:
    """Add an execution model to the registry (idempotent by name)."""
    _REGISTRY[str(spec.name)] = spec
    return spec


def get_query_model(name: str | QueryModel) -> QueryModelSpec:
    # direct registry hit first so models registered under custom names
    # resolve; fall back to enum coercion for the built-in spellings
    key = str(name)
    if key not in _REGISTRY:
        try:
            key = str(QueryModel(name))
        except ValueError:
            pass
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(f"unknown query model {name!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


register_query_model(QueryModelSpec(QueryModel.RANGE, continuous=True,
                                    tuple_driven=True, snapshot=False))
register_query_model(QueryModelSpec(QueryModel.KNN, continuous=True,
                                    tuple_driven=True, snapshot=False))
register_query_model(QueryModelSpec(QueryModel.SNAPSHOT, continuous=False,
                                    tuple_driven=False, snapshot=True))
register_query_model(QueryModelSpec(QueryModel.SPATIAL_KEYWORD,
                                    continuous=True, tuple_driven=True,
                                    snapshot=False, keyword=True))


@dataclass(frozen=True)
class WorkloadSpec:
    """One (query model × persistence model) workload configuration."""

    query_model: QueryModel = QueryModel.RANGE
    persistence: PersistenceModel = PersistenceModel.EPHEMERAL
    k: int = 8                   # kNN result-set size
    knn_side: float = 0.01       # kNN influence-region side (routing box)
    snapshot_rate: int = 400     # one-shot probes injected per tick
    snapshot_side: float = 0.02  # probe rectangle side
    bytes_per_tuple: int = 24    # x, y (f32) + id + storage header
    store_cost: float = 0.5      # work units to deposit one stored tuple
    scan_kappa: float = 0.05     # per-stored-tuple scan cost of a probe
    retention: float = 0.7       # ephemeral probe-window decay per tick
    data_weight: float = 0.05    # γ: resident tuples folded into N(p)
    # --- spatial-keyword pub/sub knobs (ignored unless spec.keyword) ---
    term_buckets: int = 32       # T: vocabulary hash buckets
    tuple_terms: int = 3         # terms carried by each incoming tuple
    sub_terms: int = 2           # conjunction terms per subscription
    delivery_cost: float = 0.05  # work units per expected delivery
    delivery_bytes: int = 48     # wire bytes per delivered notification

    def __post_init__(self):
        # accept plain strings ("knn", "stored"); identity comparisons
        # (`wl.query_model is QueryModel.KNN`) must see the enum
        object.__setattr__(self, "query_model", QueryModel(self.query_model))
        object.__setattr__(self, "persistence",
                           PersistenceModel(self.persistence))

    @property
    def spec(self) -> QueryModelSpec:
        return get_query_model(self.query_model)

    @property
    def stored(self) -> bool:
        return self.persistence is PersistenceModel.STORED

    @property
    def uses_store(self) -> bool:
        """Snapshot probes need something to scan even when ephemeral
        (the recent-tuple window); STORED always keeps resident data."""
        return self.stored or self.spec.snapshot

    @property
    def label(self) -> str:
        base = f"{self.query_model.value}+{self.persistence.value}"
        if not self.spec.keyword:
            return base
        # fold the textual knobs so pub/sub sweeps can't collide
        return (base + f"[T={self.term_buckets},kt={self.tuple_terms},"
                f"ks={self.sub_terms}]")


def all_workloads(keyword: bool = False, **overrides) -> list[WorkloadSpec]:
    """The {range, knn, snapshot} × {ephemeral, stored} matrix.

    ``keyword=True`` additionally includes the ``spatial_keyword``
    model (kept opt-in so the core 3×2 matrix — and every golden built
    on it — is unchanged).
    """
    models = [qm for qm in QueryModel
              if keyword or not get_query_model(qm).keyword]
    return [WorkloadSpec(query_model=qm, persistence=pm, **overrides)
            for qm in models for pm in PersistenceModel]
