"""Routing approaches compared in the paper's evaluation (§6):

* ``ReplicatedRouter``      — queries replicated everywhere, points round-robin
* ``StaticUniformRouter``   — equal-area static grid (kd over area)
* ``StaticHistoryRouter``   — static grid balanced with SWARM's cost model
                              over a limited history sample, then frozen
* ``SwarmRouter``           — the live SWARM protocol

All four implement the typed event/decision API of ``streaming.api``:
the engine drives exactly one entry point,

    ingest(batch: EventBatch) -> RoutingDecision | None

plus the per-round ``on_round(tick) -> RoundOutcome``, per-tick
``end_tick()`` upkeep and ``memory_usage()`` accounting.  The batched
routing/cost math itself is delegated to a pluggable
``streaming.planes.DataPlane`` (NumPy reference or jit-fused JAX) —
routers own only the mutable state: indexes, resident counts, tuple
stores and SWARM's collectors.

Every router carries a ``repro.queries.WorkloadSpec`` selecting the
query-execution model (range / knn / snapshot) and the persistence
model (ephemeral / stored); the default reproduces the original
continuous-range-over-ephemeral-tuples behavior exactly.

Migration note: the pre-redesign ``route_points(xy)`` /
``route_snapshots(rects)`` duck-typed entry points survive as thin
wrappers returning ``(owners, costs)``; new code should ingest
``TupleBatch`` / ``ProbeBatch`` events instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Swarm, balancer, geometry
from ..core.global_index import GlobalIndex
from ..queries import QueryModel, TermHasher, TupleStore, WorkloadSpec
from ..queries.keywords import bucket_onehot
from .api import (NO_ROUND, EventBatch, MachineFailure, MachineJoin,
                  MachineSlow, MemoryUsage, ProbeBatch, QueryBatch,
                  RoundOutcome, RoutingDecision, TupleBatch)
from .fused import FusedHostState
from .planes import CostParams, DataPlane, get_plane
from .sources import QUERY_SIDE

BYTES_PER_QUERY = 64   # moved-query wire size (rect + id + state header)

# Legacy alias: the mutable RoundInfo of the pre-redesign API is now the
# frozen, typed RoundOutcome.
RoundInfo = RoundOutcome


class _Base:
    """Cost model for processing one tuple on an executor (paper §6: an
    R*-tree probe over the machine-resident queries, plus reporting every
    matched query):

        cost = c0 + κ_probe·log2(1 + Q_machine) + κ_match·E[matches]

    E[matches] for a tuple landing in partition p ≈ Qres(p)·a_q/A(p) —
    the local query density times the query area.  This is what makes a
    hotspot (points *and* queries concentrated) quadratically expensive
    for whoever owns it, which is the effect SWARM redistributes.
    """

    def __init__(self, num_machines: int, kappa_probe: float = 1.0,
                 kappa_match: float = 1.0, c0: float = 1.0,
                 query_area: float | None = None, q_cache: int = 1500,
                 workload: WorkloadSpec | None = None,
                 data_plane: DataPlane | str | None = None,
                 standby: int = 0):
        self.m = num_machines
        # trailing machine slots that have not joined the cluster yet
        # (elastic scale-out targets); a MachineJoin event activates one
        self.standby = max(0, min(int(standby), num_machines - 1))
        self.kappa_probe = kappa_probe
        self.kappa_match = kappa_match
        self.c0 = c0
        self.workload = workload or WorkloadSpec()
        # spatial-keyword workloads hash subscription/tuple terms into
        # a fixed bucket space; None for pure-spatial models
        self.hasher = (TermHasher(self.workload.term_buckets)
                       if self.workload.spec.keyword else None)
        self.plane = get_plane(data_plane)
        if query_area is None:
            # match-cost coverage must price the resident rects the
            # workload actually registers: kNN influence regions are
            # much smaller than campus-scale range queries
            wl = self.workload
            side = (wl.knn_side if wl.query_model is QueryModel.KNN
                    else QUERY_SIDE)
            query_area = side ** 2
        self.query_area = query_area
        # Index size beyond which probes pay memory pressure (the paper's
        # Replicated "fails … due to high memory overhead" at 16M queries;
        # the soft penalty models cache/RAM thrash before the hard wall).
        self.q_cache = q_cache
        self.query_rects = np.zeros((0, 4), np.float32)
        self.store: TupleStore | None = None   # set where capacity is known

    # -- the typed entry point --------------------------------------------
    def ingest(self, batch: EventBatch
               ) -> RoutingDecision | RoundOutcome | None:
        """Route one event batch.  Work-carrying batches (tuples,
        probes) return a :class:`RoutingDecision`; state changes (query
        registration, joins, slowdowns) return ``None``; a failure may
        return the :class:`RoundOutcome` of the emergency re-homing it
        triggered (adaptive routers only)."""
        if isinstance(batch, TupleBatch):
            return self._route_tuples(batch.xy, batch.buckets)
        if isinstance(batch, QueryBatch):
            self.register_queries(batch.rects, batch.terms)
            return None
        if isinstance(batch, ProbeBatch):
            return self._route_probes(batch.rects)
        if isinstance(batch, MachineFailure):
            return self.on_machine_failed(batch.machine)
        if isinstance(batch, MachineJoin):
            return self.on_machine_joined(batch.machine,
                                          batch.capacity_factor)
        if isinstance(batch, MachineSlow):
            return self.on_machine_slow(batch.machine, batch.factor)
        raise TypeError(f"unknown event batch type {type(batch).__name__}")

    def _cost_params(self) -> CostParams:
        wl = self.workload
        return CostParams(
            c0=float(self.c0), kappa_probe=float(self.kappa_probe),
            kappa_match=float(self.kappa_match), q_cache=float(self.q_cache),
            query_area=float(self.query_area),
            match_factor=wl.spec.match_factor(wl.k),
            tuple_driven=wl.spec.tuple_driven,
            store_cost=float(wl.store_cost) if self.store is not None else 0.0,
            scan_kappa=float(wl.scan_kappa),
            delivery_cost=(float(wl.delivery_cost)
                           if self.hasher is not None else 0.0),
            keyword=self.hasher is not None)

    def _make_store(self, capacity: int) -> TupleStore | None:
        wl = self.workload
        if not wl.uses_store:
            return None
        return TupleStore(capacity, bytes_per_tuple=wl.bytes_per_tuple,
                          retention=1.0 if wl.stored else wl.retention)

    def _probe_cost(self, q_resident):
        from .planes import probe_term
        return probe_term(np, np.asarray(q_resident, np.float64),
                          self.kappa_probe, self.q_cache)

    # -- queries ----------------------------------------------------------
    def register_queries(self, rects: np.ndarray,
                         terms: np.ndarray | None = None) -> None:
        if len(rects):
            self.query_rects = np.concatenate([self.query_rects, rects], 0)
            self._index_queries(rects, terms)

    @property
    def q_total(self) -> int:
        return len(self.query_rects)

    def on_round(self, tick: int) -> RoundOutcome:
        return NO_ROUND

    def on_machine_failed(self, m: int) -> RoundOutcome | None:
        """Static plans cannot re-home a dead machine's partitions —
        its share of the stream is simply lost (the comparison point
        the elasticity benchmark measures)."""
        return None

    def on_machine_joined(self, m: int,
                          capacity_factor: float = 1.0) -> None:
        """Static plans never route to a late joiner."""
        return None

    def on_machine_slow(self, m: int, factor: float) -> None:
        """Static plans cannot shed a straggler's load."""
        return None

    def end_tick(self) -> None:
        """Per-tick persistence upkeep (ephemeral probe-window decay)."""
        if self.store is not None:
            self.store.expire()

    def resident_data_counts(self) -> np.ndarray:
        """Stored tuples per machine (STORED memory accounting)."""
        return np.zeros(self.m, np.float64)

    def memory_usage(self) -> MemoryUsage:
        """Executor memory: resident queries always count; resident
        tuples only under STORED persistence (the ephemeral probe window
        is bounded by retention decay, not by executor RAM)."""
        tuples = (self.resident_data_counts() if self.workload.stored
                  else np.zeros(self.m, np.float64))
        return MemoryUsage(queries=self.resident_counts(), tuples=tuples)

    # -- legacy entry points (see module migration note) -------------------
    def route_points(self, xy: np.ndarray):
        d = self._route_tuples(xy)
        return d.owners, d.costs

    def route_snapshots(self, rects: np.ndarray):
        d = self._route_probes(rects)
        return d.owners, d.costs

    # subclass hooks
    def _index_queries(self, rects: np.ndarray,
                       terms: np.ndarray | None = None) -> None: ...
    def _route_tuples(self, xy: np.ndarray,
                      buckets: np.ndarray | None = None
                      ) -> RoutingDecision: ...
    def _route_probes(self, rects: np.ndarray) -> RoutingDecision: ...
    def resident_counts(self) -> np.ndarray: ...


class ReplicatedRouter(_Base):
    """Queries on every machine; points round-robin (perfectly balanced,
    memory-bound; probes the *full* replicated query index).  A shadow
    uniform grid estimates local query density for the match term and,
    under the stored/snapshot models, stands in for the scatter targets
    of stored data — with data resident, 'replicate the queries and
    spray the tuples' stops being placement-free, which is exactly the
    stress the persistence models add (CheetahGIS observation)."""

    def __init__(self, num_machines: int, grid_size: int = 64, **kw):
        super().__init__(num_machines, **kw)
        self._rr = 0
        # queries are replicated on every *member* machine; the spray
        # rotation tracks membership (dead machines leave it, joiners
        # enter) — replication makes elasticity trivial for this router
        self._active = list(range(num_machines - self.standby))
        self._shadow = StaticUniformRouter(grid_size, num_machines,
                                           query_area=self.query_area,
                                           workload=self.workload,
                                           data_plane=self.plane,
                                           standby=self.standby)
        self.store = self._shadow.store

    def _index_queries(self, rects: np.ndarray,
                       terms: np.ndarray | None = None) -> None:
        self._shadow.register_queries(rects, terms)

    def on_machine_failed(self, m: int) -> None:
        if m in self._active and len(self._active) > 1:
            self._active.remove(m)
        return None

    def on_machine_joined(self, m: int,
                          capacity_factor: float = 1.0) -> None:
        if m not in self._active:
            self._active.append(m)
            self._active.sort()
        return None

    def _route_tuples(self, xy: np.ndarray,
                      buckets: np.ndarray | None = None) -> RoutingDecision:
        n = len(xy)
        active = np.asarray(self._active, np.int32)
        owners = active[(self._rr + np.arange(n)) % len(active)]
        self._rr = int((self._rr + n) % len(active))
        wl = self.workload
        probe = self._probe_cost(self.q_total) if wl.spec.tuple_driven else 0.0
        dels = None
        if self.hasher is not None:
            # replication spreads the probe work round-robin, but the
            # match/fan-out density is still spatial-keyword: price it
            # through the shadow grid's pivot histogram
            pids, match, dels = self._shadow._keyword_match_terms(xy, buckets)
            costs = (self.c0 + probe + wl.spec.match_factor(wl.k) * match
                     + wl.delivery_cost * dels)
        else:
            pids, match = self._shadow._match_terms(xy)
            costs = (self.c0 + probe + wl.spec.match_factor(wl.k) * match)
        if self.store is not None:
            self.store.deposit(pids, self._shadow.index.parts.capacity)
            costs = costs + wl.store_cost
        return RoutingDecision(owners, np.asarray(costs).astype(np.float32),
                               np.asarray(pids, np.int32),
                               None if dels is None
                               else np.asarray(dels, np.float64))

    def _route_probes(self, rects: np.ndarray) -> RoutingDecision:
        return self._shadow._route_probes(rects)

    def resident_counts(self) -> np.ndarray:
        return np.full(self.m, self.q_total, np.int64)

    def resident_data_counts(self) -> np.ndarray:
        return self._shadow.resident_data_counts()


class _GridRouter(_Base):
    """Shared machinery for grid-index routers (static and SWARM)."""

    # registration batches at least this large take the chunked bulk
    # overlap path (per-rect loop below it: small batches hit the
    # incremental GlobalIndex fast path the goldens were frozen on)
    BULK_INDEX_MIN = 4096
    _BULK_CHUNK = 131072

    def __init__(self, index: GlobalIndex, num_machines: int, **kw):
        super().__init__(num_machines, **kw)
        self.index = index
        self.qres = np.zeros(index.parts.capacity, np.int64)  # per-partition
        # spatial-keyword state: per-subscription pivot bucket (the
        # inverted-index posting each subscription is counted under)
        # and the (capacity, T+1) per-partition pivot histogram the
        # data planes contract against probe buckets; column T counts
        # wildcard (keyword-free) subscriptions
        self.sub_pivots = np.zeros(0, np.int64)
        self.qres_kw = (
            np.zeros((index.parts.capacity, self.hasher.wildcard + 1),
                     np.float64)
            if self.hasher is not None else None)
        self.store = self._make_store(index.parts.capacity)

    def _ensure_qres(self):
        cap = self.index.parts.capacity
        if len(self.qres) < cap:
            self.qres = np.concatenate(
                [self.qres, np.zeros(cap - len(self.qres), np.int64)])
        if self.qres_kw is not None and len(self.qres_kw) < cap:
            self.qres_kw = np.concatenate(
                [self.qres_kw,
                 np.zeros((cap - len(self.qres_kw),
                           self.qres_kw.shape[1]), np.float64)])

    def _index_queries(self, rects: np.ndarray,
                       terms: np.ndarray | None = None) -> None:
        self._ensure_qres()
        piv = None
        if self.hasher is not None:
            piv = self.hasher.pivots(terms, len(rects))
            self.sub_pivots = np.concatenate([self.sub_pivots, piv])
        g = self.index.grid_size
        r0, c0, r1, c1 = geometry.rects_to_cells(rects, g)
        if len(rects) >= self.BULK_INDEX_MIN:
            # bulk registration (pub/sub preloads millions of standing
            # subscriptions): chunked queries × live-partitions overlap
            # matrix instead of a per-rect Python loop
            p = self.index.parts
            live = p.live_ids()
            lr0, lc0 = p.r0[live][None, :], p.c0[live][None, :]
            lr1, lc1 = p.r1[live][None, :], p.c1[live][None, :]
            for lo in range(0, len(rects), self._BULK_CHUNK):
                hi = min(lo + self._BULK_CHUNK, len(rects))
                hit = geometry.boxes_overlap(
                    r0[lo:hi, None], c0[lo:hi, None],
                    r1[lo:hi, None], c1[lo:hi, None], lr0, lc0, lr1, lc1)
                self.qres[live] += hit.sum(0)
                if piv is not None:
                    qi, li = np.nonzero(hit)
                    np.add.at(self.qres_kw,
                              (live[li], piv[lo:hi][qi]), 1.0)
            return
        for i in range(len(rects)):
            pids = self.index.query_overlap_vectorized(
                int(r0[i]), int(c0[i]), int(r1[i]), int(c1[i]))
            self.qres[pids] += 1
            if piv is not None:
                self.qres_kw[pids, piv[i]] += 1.0

    def reindex_all_queries(self) -> None:
        """Rebuild per-partition resident counts after a plan change —
        vectorized partitions × queries overlap test, chunked so
        million-subscription pub/sub sets never materialize the full
        Q × P hit matrix."""
        self._ensure_qres()
        self.qres[:] = 0
        if self.qres_kw is not None:
            self.qres_kw[:] = 0.0
        if not len(self.query_rects):
            return
        g = self.index.grid_size
        p = self.index.parts
        live = p.live_ids()
        r0, c0, r1, c1 = geometry.rects_to_cells(self.query_rects, g)
        lr0, lc0 = p.r0[live][None, :], p.c0[live][None, :]
        lr1, lc1 = p.r1[live][None, :], p.c1[live][None, :]
        for lo in range(0, len(self.query_rects), self._BULK_CHUNK):
            hi = min(lo + self._BULK_CHUNK, len(self.query_rects))
            hit = geometry.boxes_overlap(
                r0[lo:hi, None], c0[lo:hi, None],
                r1[lo:hi, None], c1[lo:hi, None], lr0, lc0, lr1, lc1)
            self.qres[live] += hit.sum(0)
            if self.qres_kw is not None:
                qi, li = np.nonzero(hit)
                np.add.at(self.qres_kw,
                          (live[li], self.sub_pivots[lo:hi][qi]), 1.0)

    def _area_frac(self) -> np.ndarray:
        """Partition area as a fraction of the space, per allocated pid
        (the coverage denominator of the match/scan terms)."""
        p = self.index.parts
        g = self.index.grid_size
        n = p.n_alloc
        return (geometry.box_area(p.r0[:n], p.c0[:n], p.r1[:n], p.c1[:n])
                .astype(np.float64) / (g * g))

    def _match_terms(self, xy: np.ndarray):
        """(pids, match-term work) for each point — via the data plane."""
        self._ensure_qres()
        return self.plane.match_terms(xy, self.index.cell_to_partition,
                                      self.qres, self._area_frac(),
                                      float(self.query_area),
                                      float(self.kappa_match))

    def _probe_onehot(self, n: int,
                      buckets: np.ndarray | None) -> np.ndarray:
        """(N, T+1) probe indicator for a tuple batch; a batch without
        term annotations probes only the wildcard column (it can still
        match keyword-free subscriptions)."""
        t = self.hasher.wildcard
        if buckets is None:
            buckets = np.full((n, 1), t, np.int32)
        return bucket_onehot(buckets, t)

    def _keyword_match_terms(self, xy: np.ndarray,
                             buckets: np.ndarray | None):
        """(pids, match-term work, expected deliveries) per point —
        the keyword twin of :meth:`_match_terms`."""
        self._ensure_qres()
        return self.plane.keyword_match_terms(
            xy, self._probe_onehot(len(xy), buckets),
            self.index.cell_to_partition, self.qres_kw, self._area_frac(),
            float(self.query_area), float(self.kappa_match))

    def _route_tuples(self, xy: np.ndarray,
                      buckets: np.ndarray | None = None) -> RoutingDecision:
        self._ensure_qres()
        if self.hasher is not None:
            pids, owners, costs, dels = self.plane.keyword_costs(
                xy, self._probe_onehot(len(xy), buckets),
                self.index.cell_to_partition, self.index.parts.owner,
                self.qres_kw, self.resident_counts(), self._area_frac(),
                self._cost_params())
            if self.store is not None:
                self.store.deposit(pids, self.index.parts.capacity)
            return RoutingDecision(owners, costs, np.asarray(pids, np.int32),
                                   np.asarray(dels, np.float64))
        pids, owners, costs = self.plane.tuple_costs(
            xy, self.index.cell_to_partition, self.index.parts.owner,
            self.qres, self.resident_counts(), self._area_frac(),
            self._cost_params())
        if self.store is not None:
            self.store.deposit(pids, self.index.parts.capacity)
        return RoutingDecision(owners, costs, np.asarray(pids, np.int32))

    def _route_probes(self, rects: np.ndarray, pids=None,
                      owners=None) -> RoutingDecision:
        """One-shot probes over stored tuples: each probe scans the
        resident data of the partition holding its center (probes are
        campus-sized; partitions much larger).  Cost = index probe over
        the machine's stored tuples + per-tuple scan of the covered
        fraction."""
        if self.store is None:
            raise ValueError(
                f"workload {self.workload.label!r} keeps no tuple store for "
                "snapshot probes to scan; configure the router with a "
                "WorkloadSpec using QueryModel.SNAPSHOT (or STORED "
                "persistence) before routing ProbeBatch events")
        self.store.ensure(self.index.parts.capacity)
        pids, owners, costs = self.plane.probe_costs(
            rects, self.index.cell_to_partition, self.index.parts.owner,
            self.store.counts, self.resident_data_counts(),
            self._area_frac(), self._cost_params(), pids=pids, owners=owners)
        return RoutingDecision(owners, costs, np.asarray(pids, np.int32))

    def resident_counts(self) -> np.ndarray:
        p = self.index.parts
        live = p.live_ids()
        out = np.zeros(self.m, np.int64)
        np.add.at(out, p.owner[live], self.qres[live])
        return out

    def resident_data_counts(self) -> np.ndarray:
        if self.store is None:
            return np.zeros(self.m, np.float64)
        return self.store.by_machine(self.index.parts, self.m)

    # -- device-resident fast path (streaming.fused) -----------------------
    def fused_host_state(self) -> FusedHostState:
        """Snapshot of everything the fused tuple-ingest step reads,
        in the router's native dtypes (copies: the engine diffs
        successive snapshots to scatter-patch the device state)."""
        self._ensure_qres()
        p = self.index.parts
        af = np.ones(p.capacity, np.float64)
        af[:p.n_alloc] = self._area_frac()
        return FusedHostState(
            grid=self.index.cell_to_partition.copy(),
            owner=p.owner.copy(),
            qres=self.qres.copy(),
            area_frac=af,
            q_machine=self.resident_counts(),
            track_stats=False,
            n_alloc=int(p.n_alloc),
            qres_kw=None if self.qres_kw is None else self.qres_kw.copy())

    def fused_absorb(self, cn_rows: np.ndarray, cn_cols: np.ndarray) -> None:
        """Collector deltas drained from the device; grid routers keep
        no per-round statistics."""


class StaticUniformRouter(_GridRouter):
    def __init__(self, grid_size: int, num_machines: int, **kw):
        active = num_machines - int(kw.get("standby", 0) or 0)
        super().__init__(
            GlobalIndex.initialize(grid_size, num_machines,
                                   active_machines=active),
            num_machines, **kw)


class StaticHistoryRouter(_GridRouter):
    """Paper's 'Static Grid Based on History': SWARM's cost model balances
    a *limited history* sample offline; the plan is then frozen."""

    def __init__(self, grid_size: int, num_machines: int,
                 history_points: np.ndarray, history_queries: np.ndarray,
                 rounds: int = 40, **kw):
        active = num_machines - int(kw.get("standby", 0) or 0)
        sw = Swarm(grid_size, num_machines, decay=1.0, beta=2,
                   active_machines=active)
        chunks = max(rounds, 1)
        pt_chunks = np.array_split(history_points, chunks)
        q_chunks = np.array_split(history_queries, chunks)
        for pts, qs in zip(pt_chunks, q_chunks):
            if len(pts):
                sw.ingest_points(pts)
            if len(qs):
                sw.ingest_queries(qs)
            force_rebalance_round(sw)
        super().__init__(sw.index, num_machines, **kw)


class SwarmRouter(_GridRouter):
    """The live protocol.  Tuple/probe batches also feed SWARM's
    collectors; every engine round triggers one load-balancing round.
    The router's data plane also serves the protocol's control-plane
    math (round close, batched split evaluation), and ``max_pairs``
    selects how many m_H→m_L transfers one round may plan (1 = the
    paper's single reduction)."""

    def __init__(self, grid_size: int, num_machines: int, *, beta: int = 20,
                 decay: float = 0.5, use_binary_search: bool = False,
                 max_pairs: int = 1, link_cost=None, trend_window: int = 0,
                 trend_threshold: float = 0.35, **kw):
        active = num_machines - int(kw.get("standby", 0) or 0)
        self.swarm = Swarm(grid_size, num_machines, beta=beta, decay=decay,
                           use_binary_search=use_binary_search,
                           max_pairs=max_pairs, active_machines=active,
                           link_cost=link_cost, trend_window=trend_window,
                           trend_threshold=trend_threshold)
        super().__init__(self.swarm.index, num_machines, **kw)
        self.swarm.plane = self.plane
        if self.store is not None:
            wl = self.workload
            self.swarm.attach_store(
                self.store,
                data_weight=wl.data_weight if wl.stored else 0.0,
                bill_migration=wl.stored)

    def _index_queries(self, rects: np.ndarray,
                       terms: np.ndarray | None = None) -> None:
        super()._index_queries(rects, terms)
        self.swarm.ingest_queries(rects)

    def note_transfer_event(self, round_no: int, kind: str) -> None:
        """Geo links: the engine observed a transfer retry/abort after
        dispatch — record it on the round's DecisionRecord."""
        self.swarm.note_transfer_event(round_no, kind)

    def fused_host_state(self) -> FusedHostState:
        from dataclasses import replace
        # SWARM's N' collectors ride the fused step: the device bank
        # absorbs the per-tuple scatter and drains at round close
        return replace(super().fused_host_state(), track_stats=True)

    def fused_absorb(self, cn_rows: np.ndarray, cn_cols: np.ndarray) -> None:
        self.swarm.absorb_collectors(cn_rows, cn_cols)

    def _route_tuples(self, xy: np.ndarray,
                      buckets: np.ndarray | None = None) -> RoutingDecision:
        self.swarm.ingest_points(xy)  # collectors (N'); then normal routing
        return super()._route_tuples(xy, buckets)

    def _route_probes(self, rects: np.ndarray, pids=None,
                      owners=None) -> RoutingDecision:
        # probes feed the Q' collectors so the cost model sees them
        if pids is None and self.store is not None:
            pids, owners = self.swarm.ingest_snapshot_probes(rects)
        return super()._route_probes(rects, pids=pids, owners=owners)

    def _outcome(self, rep) -> RoundOutcome:
        """Typed outcome of a plan change, with receiver-side
        moved-query accounting: after re-indexing, each transfer's
        moved queries are the resident counts of its *new* partitions
        owned by the receiver m_L — the machine that pays the install
        work (the engine bills ``moved_by_transfer`` there)."""
        moved_by: tuple[int, ...] = ()
        if rep.did_rebalance:
            self.reindex_all_queries()
            p = self.index.parts
            moved_by = tuple(
                int(self.qres[[pid for pid in t.new_pids
                               if p.owner[pid] == t.m_l]].sum())
                for t in rep.transfers)
        moved_queries = int(sum(moved_by))
        rec = rep.record
        if rec is not None:
            # enrich the flight-recorder record with the router-side
            # migration accounting (known only after reindexing), and
            # keep the protocol's decision log pointing at the enriched
            # copy
            rec = dataclasses.replace(
                rec, moved_queries=moved_queries,
                migration_bytes=(rep.data_bytes
                                 + moved_queries * BYTES_PER_QUERY),
                moved_by_transfer=moved_by,
                transfers=tuple(
                    dataclasses.replace(t, moved_queries=int(mq))
                    for t, mq in zip(rec.transfers, moved_by)))
            rep.record = rec
            self.swarm.replace_last_decision(rec)
        return RoundOutcome.from_report(
            rep, moved_queries=moved_queries,
            bytes_per_query=BYTES_PER_QUERY, moved_by_transfer=moved_by,
            record=rec)

    def on_round(self, tick: int) -> RoundOutcome:
        return self._outcome(self.swarm.run_round())

    def on_machine_failed(self, m: int) -> RoundOutcome | None:
        """Crash-stop handling (§4.1.1): emergency multi-pair
        redistribution of the dead machine's partitions over the
        survivors, through the same ``core.planner`` round machinery as
        rebalancing (``plan_round(evacuate=m)``); partition chains keep
        pointing at the previous machine, so surviving replicas of old
        data can still be consulted.  Returns the recovery's
        :class:`RoundOutcome` (``None`` when the machine owned
        nothing)."""
        rep = self.swarm.recover_machine(m)
        if not rep.transfers:
            return None
        return self._outcome(rep)

    def on_machine_joined(self, m: int,
                          capacity_factor: float = 1.0) -> None:
        """(Re)join: the machine becomes a reporting member and an
        eligible m_L — load flows to it through the ordinary FSM-gated
        reduction rounds (no dedicated join path)."""
        self.swarm.mark_alive(m, capacity_factor)
        return None

    def on_machine_slow(self, m: int, factor: float) -> None:
        """Straggler notification: the capacity factor folds into C(m)
        (``planner.collect``), so the Fig-9 FSM sheds the machine's
        load via normal reductions instead of crashing it."""
        self.swarm.set_capacity_factor(m, factor)
        return None


def force_rebalance_round(sw: Swarm):
    """Run one SWARM round with the decision forced to REBALANCE (used to
    build the history-balanced static grid and by tests)."""
    from ..core import planner
    from ..core.protocol import RoundReport
    sw.round_no += 1
    sw._close_stats()
    agg = sw._collect()
    rep = RoundReport(sw.round_no, balancer.REBALANCE, agg.r_s)
    plan = planner.plan_round(
        sw.stats, agg, sw.index.parts, dead=sw.excluded,
        max_pairs=sw.max_pairs, use_binary_search=sw.use_binary_search,
        cost_fn=sw.cost_fn, plane=sw.plane)
    sw._apply_plan(plan, rep)
    sw._finish_round(rep)
    sw._record_decision("forced", rep, plan)
    return rep
