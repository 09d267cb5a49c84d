"""Pluggable data planes: the batched array math behind routing *and*
the control plane's per-round fold.

A :class:`DataPlane` computes the *stateless* batched quantities of the
system: the routing hot path (cell routing, per-tuple cost terms) and,
since the array-native control-plane refactor, the round's heavy math —
the Algorithm-2 prefix-sum round close (:meth:`DataPlane.close_round`)
and the batched §4.3.2 split-candidate evaluation
(:meth:`DataPlane.split_costs`) consumed by ``core.planner``.  Routers
and the protocol own all mutable state (indexes, resident counts,
stores, collectors) and call into the plane; swapping the plane changes
how the math runs, not what it computes.

Two implementations:

* :class:`NumpyPlane` — the reference path; bit-for-bit the pre-redesign
  behavior (float64 intermediates, float32 outputs; whole-bank
  ``statistics.close_round``).
* :class:`TorchPlane` — PyTorch on one device (the card by default):
  routing and cost terms in float32 tensors, the mirror of the JAX
  package's ``JaxPlane``.  The round close runs the hand-written CUDA
  kernel of ``kernels.stats_update`` over the *live* partition subset
  only (retired/unallocated rows are zero or never read again, so
  skipping them is exact; the reference closes the whole capacity bank);
  on ``device="cpu"`` it runs that kernel's plain PyTorch version.

Besides the stateless per-call API, both planes implement the
*device-resident* fused-ingest contract of ``streaming.fused``:
:meth:`DataPlane.make_state` uploads a router snapshot once,
:meth:`DataPlane.scatter_update` edits it in place after a rebalance
(only the changed entries cross the wire), and
:meth:`DataPlane.run_window` executes a whole window of engine ticks —
routing, cost terms, SWARM's N′ collector accumulation and the
engine's queue/backpressure dynamics — in one dispatch
(a device-side loop over the window's ticks on the torch plane; the
single-tick :meth:`DataPlane.step` updates the resident collectors in
place), so the steady state transfers only O(window·machines)
metrics instead of per-item owners/costs.  The NumPy plane's window is the literal
per-tick reference loop, sharing ``fused.host_process_tick`` with the
engine so fused-vs-per-tick metric parity holds by construction.

``chip_smoke.py`` at the repository root drives this plane on the card
and times its kernel (``PERF.md``).
"""
from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..core import geometry, planner
from ..core import statistics as S
from ..telemetry.tracer import current as _tracer
from .fused import (DeviceState, EngineCarry, FusedHostState, FusedOutputs,
                    FusedParams, host_process_tick)


def probe_term(mod, q, kappa_probe, q_cache):
    """The per-tuple index-probe cost with cache-pressure knee (§6):
    ``κ_probe·log2(1+Q)·(1 + max(0, (Q−q_cache)/q_cache))``.

    The single home of the formula — both planes' fused paths and the
    replicated router's scalar path call it with ``mod`` = numpy or
    torch, so a tuning change cannot silently diverge between the
    compared systems.  ``torch.maximum`` takes no Python scalar, so the
    torch form clamps instead."""
    excess = (q - q_cache) / q_cache
    if mod is np:
        pressure = 1.0 + np.maximum(0.0, excess)
    else:
        pressure = 1.0 + excess.clamp_min(0.0)
    return kappa_probe * mod.log2(1.0 + q) * pressure


@dataclass(frozen=True)
class CostParams:
    """Per-router scalar bundle for the cost terms (paper §6):
    ``cost = c0 + κ_probe·log2(1+Q_m)·pressure + mf·κ_match·E[matches]``
    plus the persistence deposit (``store_cost``) and, for snapshot
    probes, the stored-tuple scan term (``scan_kappa``)."""

    c0: float
    kappa_probe: float
    kappa_match: float
    q_cache: float
    query_area: float
    match_factor: float
    tuple_driven: bool
    store_cost: float       # 0.0 when the workload keeps no store
    scan_kappa: float = 0.0
    # spatial-keyword pub/sub: per-expected-delivery fan-out work and
    # the flag that routes tuples through the keyword cost path
    delivery_cost: float = 0.0
    keyword: bool = False


class DataPlane:
    """Interface; see module docstring.  ``grid`` is the (G, G) int32
    cell→partition map, ``owner_table`` the (P,) int32 partition→machine
    map, ``area_frac`` the (P,) float64 partition area as a fraction of
    the space, ``qres`` the (P,) resident-query counts and
    ``q_machine``/``d_machine`` the per-machine resident query/tuple
    counts."""

    name = "abstract"

    def tuple_costs(self, xy, grid, owner_table, qres, q_machine,
                    area_frac, p: CostParams):
        """Route a tuple batch and price it: (pids, owners, costs)."""
        raise NotImplementedError

    def match_terms(self, xy, grid, qres, area_frac, query_area,
                    kappa_match):
        """(pids, match-term work) per point — the E[matches] density
        approximation used by the replicated router's shadow grid."""
        raise NotImplementedError

    def keyword_costs(self, xy, onehot, grid, owner_table, qres_kw,
                      q_machine, area_frac, p: CostParams):
        """Route and price a spatial-keyword tuple batch.

        ``onehot`` is the (N, T+1) probe-bucket indicator of each tuple
        (wildcard column always on, ``queries.keywords.bucket_onehot``)
        and ``qres_kw`` the (P, T+1) per-partition pivot histogram; the
        expected candidate count per tuple is their contraction, and
        the expected deliveries its coverage-scaled value.  Returns
        ``(pids, owners, costs, deliveries)``."""
        raise NotImplementedError

    def keyword_match_terms(self, xy, onehot, grid, qres_kw, area_frac,
                            query_area, kappa_match):
        """Keyword twin of :meth:`match_terms` for the replicated
        router's shadow grid: ``(pids, match-term work, expected
        deliveries)`` per point."""
        raise NotImplementedError

    def probe_costs(self, rects, grid, owner_table, store_counts,
                    d_machine, area_frac, p: CostParams,
                    pids=None, owners=None):
        """Route snapshot probes (by center) and price the stored-tuple
        scan: (pids, owners, costs).  ``pids``/``owners`` may be
        supplied when the router already routed the batch (SWARM's
        collector path)."""
        raise NotImplementedError

    # -- exact match work (kernel packages) ---------------------------------
    def match_counts(self, points, rects):
        """Exact tuple↔query join sizes: (per-point matches, per-query
        matches) — ``repro.kernels.spatial_match`` semantics."""
        raise NotImplementedError

    def keyword_match_counts(self, points, pt_masks, rects, sub_masks):
        """Exact fused spatial ∧ keyword-conjunction join sizes over
        hashed bucket masks — ``repro.kernels.keyword_match``
        semantics: (per-point deliveries, per-subscription matches)."""
        raise NotImplementedError

    def knn_distances(self, points, foci, k: int = 8):
        """(Q, k) ascending squared distances —
        ``repro.kernels.knn_match`` semantics."""
        raise NotImplementedError

    # -- control plane (core.planner) ---------------------------------------
    def close_round(self, stats, decay: float, live) -> None:
        """Algorithm-2 round close, in place: fold the collectors of
        every live partition into the maintained statistics and reset
        them (``core.statistics.close_round`` semantics)."""
        raise NotImplementedError

    def split_costs(self, stats, pids, boxes, r_s, cost_fn):
        """Batched split-candidate evaluation for K partitions: stacked
        (c_lo, c_hi, valid) of shape (K, 2 axes, G) — the cost of each
        side at every global split position (``core.planner`` consumes
        the argmin)."""
        raise NotImplementedError

    # -- device-resident fused ingest (streaming.fused) ---------------------
    def make_state(self, host: FusedHostState) -> DeviceState:
        """Upload one router snapshot as a resident :class:`DeviceState`
        (collector banks start at zero)."""
        raise NotImplementedError

    def scatter_update(self, state: DeviceState,
                       updates: dict[str, tuple]) -> DeviceState:
        """Apply ``FusedHostState.diff`` output in place: scatter the
        changed entries of each named field (a rebalance touches a few
        partitions; nothing else is re-transferred)."""
        raise NotImplementedError

    def reset_collectors(self, state: DeviceState) -> DeviceState:
        """Zero the N′ collector banks (after the engine drained them
        into the host stats bank via ``Swarm.absorb_collectors``)."""
        raise NotImplementedError

    def step(self, state: DeviceState, cp: CostParams, xy,
             track_stats: bool = False, query_batch=None, kw=None):
        """One fused ingest step: route + price ``xy`` and accumulate
        the N′ collectors on the resident state in a single dispatch.
        Returns ``(state, (pids, owners, costs))`` — with a trailing
        ``deliveries`` element when ``kw`` (the batch's (N, K+1) probe
        bucket ids) is given and the state carries ``qres_kw``.  Query
        registration is a host-boundary event by design (arrivals are
        rare and touch the partition boxes the planner owns), so
        ``query_batch`` must be ``None`` — the engine routes
        ``QueryBatch`` events through the per-tick path between
        windows."""
        raise NotImplementedError

    def run_window(self, state: DeviceState, cp: CostParams,
                   fp: FusedParams, carry: EngineCarry, xy_stack,
                   kw_stack=None, cells=None):
        """Execute ``len(xy_stack)`` fused engine ticks (inject →
        route/price/collect → process → backpressure).  ``xy_stack`` is
        (W, B, 2) with B = ⌊λmax⌋ staged candidates per tick;
        ``kw_stack`` is the matching (W, B, K+1) int32 probe-bucket
        stack for spatial-keyword workloads (None otherwise).
        ``cells`` optionally carries the (W, B) precomputed flat cell
        ids from ingest-tier batches (``TupleBatch.cells``, engine-
        verified against this plane's grid size); planes that set
        ``wants_cells`` consume them, reference planes derive cells
        themselves and ignore the hint.
        ``fp.alive`` is the effective-capacity mask (alive × capacity
        factor): elastic membership — kills, joins, stragglers — reaches
        the window's tick dynamics through that one per-window array,
        while plan changes from recovery/rebalancing arrive as
        ``scatter_update`` patches of the resident state.  Returns
        ``(state, carry, FusedOutputs, ok)``; ``ok`` is False when the
        window cannot represent the tick dynamics exactly (the torch
        plane's histogram factoring assumes backpressure stays idle) —
        the caller must then discard all four values and replay the
        staged batches through the per-tick reference path."""
        raise NotImplementedError

    # set by planes whose ``run_window`` consumes precomputed ingest
    # cell ids (the sharded plane); the engine stages ``cells`` only for
    # these, keeping the reference planes' call shape unchanged
    wants_cells: bool = False

    def collector_banks(self, state: DeviceState):
        """The N′ collector banks as host ``(cn_rows, cn_cols)`` float64
        arrays of shape (P, G+1), ready for ``Swarm.absorb_collectors``.
        Single-device planes read the resident banks back directly; the
        sharded plane additionally unscatters its per-device slot banks
        into partition order."""
        return (np.asarray(state.cn_rows), np.asarray(state.cn_cols))

    def reshard_transfers(self, state, outcome, router) -> int:
        """Physically move a round's transferred state between devices,
        returning the bytes moved.  Single-device planes hold every
        machine on one device — a planner transfer is purely a scatter
        patch of the resident plan, nothing moves, so the default
        reports 0.  The sharded plane re-homes the moved partitions'
        query rows + store payload across device shards and returns the
        actual payload bytes, which must equal the billed
        ``RoundOutcome.migration_bytes`` (tested)."""
        return 0


# ---------------------------------------------------------------------------
# NumPy reference plane
# ---------------------------------------------------------------------------

class NumpyPlane(DataPlane):
    name = "numpy"

    def _route(self, xy, grid, owner_table):
        g = grid.shape[0]
        row, col = geometry.points_to_cells(np.asarray(xy), g)
        pids = grid[row, col]
        return pids, owner_table[pids]

    def tuple_costs(self, xy, grid, owner_table, qres, q_machine,
                    area_frac, p: CostParams):
        pids, owners = self._route(xy, grid, owner_table)
        if p.tuple_driven:
            q = np.asarray(q_machine, np.float64)[owners]
            probe = probe_term(np, q, p.kappa_probe, p.q_cache)
            cov = np.minimum(
                p.query_area / np.maximum(area_frac[pids], 1e-12), 1.0)
            match = p.kappa_match * qres[pids] * cov
            costs = p.c0 + probe + p.match_factor * match
        else:
            costs = np.full(len(xy), p.c0, np.float64)
        costs = costs + p.store_cost
        return pids, owners.astype(np.int32), costs.astype(np.float32)

    def match_terms(self, xy, grid, qres, area_frac, query_area,
                    kappa_match):
        g = grid.shape[0]
        row, col = geometry.points_to_cells(np.asarray(xy), g)
        pids = grid[row, col]
        cov = np.minimum(query_area / np.maximum(area_frac[pids], 1e-12), 1.0)
        return pids, kappa_match * qres[pids] * cov

    def keyword_costs(self, xy, onehot, grid, owner_table, qres_kw,
                      q_machine, area_frac, p: CostParams):
        # op order mirrors tuple_costs exactly so the 0-keyword case
        # (all-wildcard onehot ⇒ cand == qres, delivery_cost == 0)
        # degrades to the continuous-range costs bit-for-bit
        pids, owners = self._route(xy, grid, owner_table)
        q = np.asarray(q_machine, np.float64)[owners]
        probe = probe_term(np, q, p.kappa_probe, p.q_cache)
        cov = np.minimum(
            p.query_area / np.maximum(area_frac[pids], 1e-12), 1.0)
        cand = (np.asarray(qres_kw, np.float64)[pids]
                * np.asarray(onehot, np.float64)).sum(1)
        match = p.kappa_match * cand * cov
        costs = p.c0 + probe + p.match_factor * match
        deliveries = cand * cov
        costs = costs + p.delivery_cost * deliveries + p.store_cost
        return (pids, owners.astype(np.int32), costs.astype(np.float32),
                deliveries)

    def keyword_match_terms(self, xy, onehot, grid, qres_kw, area_frac,
                            query_area, kappa_match):
        g = grid.shape[0]
        row, col = geometry.points_to_cells(np.asarray(xy), g)
        pids = grid[row, col]
        cov = np.minimum(query_area / np.maximum(area_frac[pids], 1e-12), 1.0)
        cand = (np.asarray(qres_kw, np.float64)[pids]
                * np.asarray(onehot, np.float64)).sum(1)
        return pids, kappa_match * cand * cov, cand * cov

    def probe_costs(self, rects, grid, owner_table, store_counts,
                    d_machine, area_frac, p: CostParams,
                    pids=None, owners=None):
        rects = np.asarray(rects)
        if pids is None:
            centers = np.stack([(rects[:, 0] + rects[:, 2]) * 0.5,
                                (rects[:, 1] + rects[:, 3]) * 0.5], axis=1)
            pids, owners = self._route(centers, grid, owner_table)
        probe = p.kappa_probe * np.log2(1.0 + np.asarray(d_machine)[owners])
        area_q = ((rects[:, 2] - rects[:, 0])
                  * (rects[:, 3] - rects[:, 1])).astype(np.float64)
        cov = np.minimum(area_q / np.maximum(area_frac[pids], 1e-12), 1.0)
        scan = p.scan_kappa * store_counts[pids] * cov
        costs = (p.c0 + probe + scan).astype(np.float32)
        return pids, np.asarray(owners, np.int32), costs

    def match_counts(self, points, rects, chunk: int = 512):
        points = np.asarray(points, np.float32)
        rects = np.asarray(rects, np.float32)
        pcnt = np.zeros(len(points), np.int32)
        qcnt = np.zeros(len(rects), np.int32)
        for lo in range(0, len(rects), chunk):
            r = rects[lo:lo + chunk]
            inside = ((points[:, None, 0] >= r[None, :, 0])
                      & (points[:, None, 0] <= r[None, :, 2])
                      & (points[:, None, 1] >= r[None, :, 1])
                      & (points[:, None, 1] <= r[None, :, 3]))
            pcnt += inside.sum(1, dtype=np.int32)
            qcnt[lo:lo + chunk] = inside.sum(0, dtype=np.int32)
        return pcnt, qcnt

    def keyword_match_counts(self, points, pt_masks, rects, sub_masks,
                             chunk: int = 512):
        points = np.asarray(points, np.float32)
        pt_masks = np.asarray(pt_masks, np.float32)
        rects = np.asarray(rects, np.float32)
        sub_masks = np.asarray(sub_masks, np.float32)
        pcnt = np.zeros(len(points), np.int32)
        qcnt = np.zeros(len(rects), np.int32)
        inv = 1.0 - pt_masks
        for lo in range(0, len(rects), chunk):
            r = rects[lo:lo + chunk]
            hit = ((points[:, None, 0] >= r[None, :, 0])
                   & (points[:, None, 0] <= r[None, :, 2])
                   & (points[:, None, 1] >= r[None, :, 1])
                   & (points[:, None, 1] <= r[None, :, 3]))
            # buckets the subscription needs that the tuple lacks
            miss = inv @ sub_masks[lo:lo + chunk].T
            hit &= miss < 0.5
            pcnt += hit.sum(1, dtype=np.int32)
            qcnt[lo:lo + chunk] = hit.sum(0, dtype=np.int32)
        return pcnt, qcnt

    def knn_distances(self, points, foci, k: int = 8):
        points = np.asarray(points, np.float32)
        foci = np.asarray(foci, np.float32)
        d2 = ((foci[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        part = np.partition(d2, k - 1, axis=1)[:, :k]
        return np.sort(part, axis=1)

    # -- control plane ------------------------------------------------------
    def close_round(self, stats, decay: float, live) -> None:
        # reference semantics: the whole capacity bank, exactly as the
        # pre-refactor control plane did (``live`` is a no-op hint here)
        S.close_round(stats, decay)

    def split_costs(self, stats, pids, boxes, r_s, cost_fn):
        return planner.numpy_split_costs(stats, pids, boxes, r_s, cost_fn)

    # -- device-resident fused ingest (reference semantics) -----------------
    def make_state(self, host: FusedHostState) -> DeviceState:
        g1 = host.grid.shape[0] + 1
        z = lambda: np.zeros((host.capacity, g1), np.float32)
        return DeviceState(host.grid, host.owner, host.qres, host.area_frac,
                           host.q_machine, z(), z(), host.qres_kw)

    def scatter_update(self, state: DeviceState,
                       updates: dict[str, tuple]) -> DeviceState:
        repl = {}
        for name, (idx, vals) in updates.items():
            arr = getattr(state, name).copy()
            arr[idx] = vals
            repl[name] = arr
        return state._replace(**repl)

    def reset_collectors(self, state: DeviceState) -> DeviceState:
        return state._replace(cn_rows=np.zeros_like(state.cn_rows),
                              cn_cols=np.zeros_like(state.cn_cols))

    def step(self, state: DeviceState, cp: CostParams, xy,
             track_stats: bool = False, query_batch=None, kw=None):
        if query_batch is not None:
            raise NotImplementedError(
                "query registration is a host-boundary event; ingest "
                "QueryBatch through the router between fused windows")
        if kw is not None:
            from ..queries.keywords import bucket_onehot
            onehot = bucket_onehot(kw, state.qres_kw.shape[1] - 1)
            pids, owners, costs, dels = self.keyword_costs(
                xy, onehot, state.grid, state.owner, state.qres_kw,
                state.q_machine, state.area_frac, cp)
            out = (pids, owners, costs, dels)
        else:
            pids, owners, costs = self.tuple_costs(
                xy, state.grid, state.owner, state.qres, state.q_machine,
                state.area_frac, cp)
            out = (pids, owners, costs)
        if track_stats:
            row, col = geometry.points_to_cells(np.asarray(xy),
                                                state.grid.shape[0])
            one = np.ones(len(pids), np.float32)
            np.add.at(state.cn_rows, (pids, row), one)
            np.add.at(state.cn_cols, (pids, col), one)
        return state, out

    def run_window(self, state: DeviceState, cp: CostParams,
                   fp: FusedParams, carry: EngineCarry, xy_stack,
                   kw_stack=None, cells=None):
        """The per-tick reference loop over pre-staged batches: same
        float64 host math, same ``np.add.at`` ordering, shared
        ``host_process_tick`` — metrics-equal to ``StreamingEngine.
        step`` by construction."""
        qu = np.asarray(carry.queue_units, np.float64).copy()
        qt = np.asarray(carry.queue_tuples, np.float64).copy()
        lam_bp = float(carry.lam_bp)
        w = len(xy_stack)
        m = len(qu)
        thr, lat = np.zeros(w), np.zeros(w)
        util = np.zeros((w, m))
        inj = np.zeros(w, np.int64)
        dels = np.zeros(w) if kw_stack is not None else None
        with _tracer().span("fused_window_dispatch", ticks=w,
                            plane="numpy"):
            for i in range(w):
                n = int(min(fp.lambda_max, lam_bp))
                state, out = self.step(
                    state, cp, xy_stack[i, :n],
                    track_stats=fp.track_stats,
                    kw=None if kw_stack is None else kw_stack[i, :n])
                owners, costs = out[1], out[2]
                if dels is not None:
                    dels[i] = float(out[3].sum())
                np.add.at(qu, owners, costs.astype(np.float64))
                np.add.at(qt, owners, 1.0)
                pu, thr[i], lat[i], lam_bp = host_process_tick(
                    qu, qt, lam_bp, fp.cap_units, fp.alive, fp.bp_high,
                    fp.bp_dec, fp.bp_inc, fp.lambda_max)
                util[i] = pu / np.maximum(fp.cap_units, 1e-9)
                inj[i] = n
        return state, EngineCarry(qu, qt, lam_bp), FusedOutputs(
            thr, lat, util, inj, dels), True


# ---------------------------------------------------------------------------
# Torch plane (one device; the hand-written CUDA kernels on the card)
# ---------------------------------------------------------------------------

class _UploadCache:
    """Content-addressed host→device upload cache for the *state* side
    of the per-call API (owner table, qres, machine counts, cost
    scalars).  Routers mutate these only at query arrivals and round
    boundaries, so between rounds every call would re-ship identical
    bytes.  Keying on the exact content (dtype, shape, bytes) makes the
    cache safe against in-place mutation — a changed ``qres`` is simply
    a miss — and every entry is a copy, never a view of the caller's
    array.  Large arrays (the batches themselves) bypass the cache:
    hashing them would cost more than the transfer saves."""

    MAX_BYTES = 1 << 16
    MAX_ITEMS = 256

    def __init__(self, device):
        self._device = device
        self._items: OrderedDict[tuple, torch.Tensor] = OrderedDict()

    def get(self, arr: np.ndarray) -> torch.Tensor:
        if arr.nbytes > self.MAX_BYTES:
            return torch.tensor(arr, device=self._device)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        dev = self._items.get(key)
        if dev is None:
            dev = torch.tensor(arr, device=self._device)
            self._items[key] = dev
            if len(self._items) > self.MAX_ITEMS:
                self._items.popitem(last=False)
        else:
            self._items.move_to_end(key)
        return dev


def state_from_numpy(host, device="cuda") -> DeviceState:
    """Upload one router snapshot as a resident :class:`DeviceState` of
    torch tensors — the port's counterpart of ``make_state``.  ``host``
    is any object with the :class:`FusedHostState` fields as NumPy
    arrays (the JAX package's snapshot works as is).  Index tables are
    int64 (torch's gather index type), everything else float32 as on the
    JAX plane; the collector banks start at zero."""
    dev = torch.device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)
    g1 = host.grid.shape[0] + 1
    z = lambda: torch.zeros((len(host.owner), g1), dtype=torch.float32,
                            device=dev)
    return DeviceState(i64(host.grid), i64(host.owner), f32(host.qres),
                       f32(host.area_frac), f32(host.q_machine), z(), z(),
                       None if host.qres_kw is None else f32(host.qres_kw))


def split_terms(bank_sub, a1, g: int):
    """Torch twin of ``core.planner.split_terms`` — the same six (K, G)
    side totals; the reference indexes with a NumPy ``arange``, which a
    device tensor cannot take."""
    k = bank_sub.shape[1]
    rows = torch.arange(k, device=bank_sub.device)
    n_sp = bank_sub[S.N, :, :g]
    q_sp = bank_sub[S.Q, :, :g]
    r_sp = bank_sub[S.R, :, :g]
    n_tot = bank_sub[S.N, rows, a1][:, None]
    q_tot = bank_sub[S.Q, rows, a1][:, None]
    r_tot = bank_sub[S.R, rows, a1][:, None]
    span_next = bank_sub[S.SPANQ, :, 1:g + 1]
    prespan_next = bank_sub[S.PRESPANQ, :, 1:g + 1]
    q_hi = q_tot - q_sp + span_next
    r_hi = r_tot - r_sp + prespan_next
    return n_sp, q_sp, r_sp, n_tot - n_sp, q_hi, r_hi


class TorchPlane(DataPlane):
    """The data plane on one torch device — the card unless the caller
    asks for the CPU.

    Per-call routing and pricing compute in float32 tensors with the
    JAX plane's term order.  The round close launches the CUDA kernel
    K1 (``kernels.stats_update``) on the card; only ``device="cpu"``
    reaches its plain PyTorch version.  The fused window counts tuples
    per (tick, partition) and per (partition, cell coordinate) with
    exact integer scatter-adds, never with a float32 matmul, so TF32
    cannot round a count whatever the process's matmul settings; the
    cost and queue contractions are elementwise products summed in
    float32 (no matmul either).  Exact tuple↔query match work (kernels
    K2–K4) is not ported yet (ROADMAP Queue 2)."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchPlane(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run the plain "
                               "PyTorch versions on the host")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._upload = _UploadCache(self.device)

    # -- upload / download helpers ------------------------------------------
    def _dev(self, arr, dtype=None) -> torch.Tensor:
        """Device copy of a (small) state array through the
        content-addressed upload cache."""
        return self._upload.get(np.asarray(arr, dtype))

    def _sc(self, v) -> torch.Tensor:
        """Cached 0-dim float32 device scalar: the cost terms then run in
        float32 throughout, like the JAX plane's device scalars."""
        return self._upload.get(np.float32(v))

    def _batch(self, arr, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(
            self.device)

    def _cost_scalars(self, cp: CostParams) -> tuple:
        return (self._sc(cp.c0), self._sc(cp.kappa_probe),
                self._sc(cp.kappa_match), self._sc(cp.q_cache),
                self._sc(cp.query_area), self._sc(cp.match_factor),
                self._sc(cp.store_cost), self._sc(cp.delivery_cost))

    def _fence(self) -> None:
        """Wait for the device (enabled-tracer spans only)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _host(t: torch.Tensor, dtype) -> np.ndarray:
        return t.cpu().numpy().astype(dtype, copy=False)

    # -- tensor bodies ------------------------------------------------------
    @staticmethod
    def _route(xy, grid, owner_table):
        row, col = geometry.points_to_cells(xy, grid.shape[0])
        pids = grid[row.long(), col.long()]
        return pids, owner_table[pids]

    @staticmethod
    def _cov(query_area, area_frac):
        return torch.clamp_max(query_area / area_frac.clamp_min(1e-12), 1.0)

    def _cost_body(self, n, pids, owners, qres, q_machine, area_frac, sc, *,
                   tuple_driven: bool):
        """The per-tuple §6 cost terms — one home shared by the per-call
        path, the fused single step and the window."""
        c0, kappa_probe, kappa_match, q_cache, query_area, mf, store_cost, \
            _ = sc
        if tuple_driven:
            q = q_machine[owners]
            probe = probe_term(torch, q, kappa_probe, q_cache)
            cov = self._cov(query_area, area_frac[pids])
            match = kappa_match * qres[pids] * cov
            costs = c0 + probe + mf * match
        else:
            costs = c0.expand(n)
        return costs + store_cost

    def _kw_cost_body(self, pids, owners, qres_kw, onehot, q_machine,
                      area_frac, sc):
        """Keyword cost terms: the match density is the (P, T+1) pivot
        histogram contracted with each tuple's probe buckets; the fan-out
        bill ``delivery_cost · E[deliveries]`` is added on top (same term
        order as :meth:`_cost_body`)."""
        (c0, kappa_probe, kappa_match, q_cache, query_area, mf,
         store_cost, delivery_cost) = sc
        q = q_machine[owners]
        probe = probe_term(torch, q, kappa_probe, q_cache)
        cov = self._cov(query_area, area_frac[pids])
        cand = (qres_kw[pids] * onehot).sum(1)
        match = kappa_match * cand * cov
        deliveries = cand * cov
        costs = (c0 + probe + mf * match + delivery_cost * deliveries
                 + store_cost)
        return costs, deliveries

    # -- per-call interface -------------------------------------------------
    def tuple_costs(self, xy, grid, owner_table, qres, q_machine,
                    area_frac, p: CostParams):
        pids, owners = self._route(self._batch(xy), self._dev(grid, np.int64),
                                   self._dev(owner_table, np.int64))
        costs = self._cost_body(
            len(xy), pids, owners, self._dev(qres, np.float32),
            self._dev(q_machine, np.float32),
            self._dev(area_frac, np.float32), self._cost_scalars(p),
            tuple_driven=p.tuple_driven)
        return (self._host(pids, np.int32), self._host(owners, np.int32),
                self._host(costs, np.float32))

    def match_terms(self, xy, grid, qres, area_frac, query_area,
                    kappa_match):
        row, col = geometry.points_to_cells(self._batch(xy), grid.shape[0])
        pids = self._dev(grid, np.int64)[row.long(), col.long()]
        cov = self._cov(self._sc(query_area),
                        self._dev(area_frac, np.float32)[pids])
        match = self._sc(kappa_match) * self._dev(qres, np.float32)[pids] * cov
        return self._host(pids, np.int32), self._host(match, np.float32)

    def keyword_costs(self, xy, onehot, grid, owner_table, qres_kw,
                      q_machine, area_frac, p: CostParams):
        pids, owners = self._route(self._batch(xy), self._dev(grid, np.int64),
                                   self._dev(owner_table, np.int64))
        costs, dels = self._kw_cost_body(
            pids, owners, self._dev(qres_kw, np.float32),
            self._batch(onehot), self._dev(q_machine, np.float32),
            self._dev(area_frac, np.float32), self._cost_scalars(p))
        return (self._host(pids, np.int32), self._host(owners, np.int32),
                self._host(costs, np.float32), self._host(dels, np.float64))

    def keyword_match_terms(self, xy, onehot, grid, qres_kw, area_frac,
                            query_area, kappa_match):
        row, col = geometry.points_to_cells(self._batch(xy), grid.shape[0])
        pids = self._dev(grid, np.int64)[row.long(), col.long()]
        cov = self._cov(self._sc(query_area),
                        self._dev(area_frac, np.float32)[pids])
        cand = (self._dev(qres_kw, np.float32)[pids]
                * self._batch(onehot)).sum(1)
        return (self._host(pids, np.int32),
                self._host(self._sc(kappa_match) * cand * cov, np.float64),
                self._host(cand * cov, np.float64))

    def probe_costs(self, rects, grid, owner_table, store_counts,
                    d_machine, area_frac, p: CostParams,
                    pids=None, owners=None):
        rects_t = self._batch(rects)
        if pids is None:
            centers = torch.stack([(rects_t[:, 0] + rects_t[:, 2]) * 0.5,
                                   (rects_t[:, 1] + rects_t[:, 3]) * 0.5], 1)
            pids_t, owners_t = self._route(centers,
                                           self._dev(grid, np.int64),
                                           self._dev(owner_table, np.int64))
        else:
            pids_t = self._batch(pids, np.int64)
            owners_t = self._batch(owners, np.int64)
        probe = self._sc(p.kappa_probe) * torch.log2(
            1.0 + self._dev(d_machine, np.float32)[owners_t])
        area_q = ((rects_t[:, 2] - rects_t[:, 0])
                  * (rects_t[:, 3] - rects_t[:, 1]))
        cov = self._cov(area_q, self._dev(area_frac, np.float32)[pids_t])
        scan = (self._sc(p.scan_kappa)
                * self._dev(store_counts, np.float32)[pids_t] * cov)
        costs = self._sc(p.c0) + probe + scan
        return (self._host(pids_t, np.int32), self._host(owners_t, np.int32),
                self._host(costs, np.float32))

    def match_counts(self, points, rects):
        raise NotImplementedError(
            "exact spatial match counts run on kernel K2 (spatial_match), "
            "not ported yet: ROADMAP Queue 2 / Queue 1 item 5")

    def keyword_match_counts(self, points, pt_masks, rects, sub_masks):
        raise NotImplementedError(
            "exact keyword match counts run on kernel K3 (keyword_match), "
            "not ported yet: ROADMAP Queue 2 / Queue 1 item 5")

    def knn_distances(self, points, foci, k: int = 8):
        raise NotImplementedError(
            "kNN distances run on kernel K4 (knn_match), not ported yet: "
            "ROADMAP Queue 2 / Queue 1 item 5")

    # -- control plane ------------------------------------------------------
    def close_round(self, stats, decay: float, live) -> None:
        """Live-subset round close on kernel K1.

        Retired partitions are cleared when they retire and unallocated
        capacity is zero, and neither is ever read again — so folding
        only the live rows is exact while the work scales with the live
        count.  Only the six *input* channels of the live rows cross to
        the device, rows and cols stacked into one (6, 2·live, G+1) bank
        so a round close is one upload, one launch and one download; R
        and preSpanQ' are fully derived and the collectors are reset
        host-side."""
        from ..kernels import stats_update as SU
        live = np.asarray(live)
        n = len(live)
        if n == 0:
            return
        tr = _tracer()
        in_ch = np.array(SU.IN_CH)[:, None]
        with (tr.span("stats_close", live=n) if tr.enabled
              else contextlib.nullcontext()):
            bank6 = np.concatenate([stats.rows[in_ch, live[None, :]],
                                    stats.cols[in_ch, live[None, :]]],
                                   axis=1)
            out = SU.close_round_inputs(self._batch(bank6), decay=decay)
            out = out.cpu().numpy()
        for k, bank in enumerate((stats.rows, stats.cols)):
            for i, ch in enumerate(SU.OUT_CH):
                bank[ch, live] = out[i, k * n:(k + 1) * n]
            for ch in S.COLLECTORS:
                bank[ch, live] = 0.0

    def split_costs(self, stats, pids, boxes, r_s, cost_fn):
        """Batched split terms on the device; the pluggable ``cost_fn``
        stays host-side NumPy on the downloaded terms, so custom cost
        models need not be written in torch."""
        pids = np.asarray(pids)
        g = stats.grid_size
        out_lo, out_hi, out_valid = [], [], []
        for axis, bank in ((0, stats.rows), (1, stats.cols)):
            a1 = boxes[2] if axis == 0 else boxes[3]
            # only the maintained channels are read by the split terms
            sub = self._batch(bank[:S.C_N, pids])
            terms = torch.stack(split_terms(sub, self._batch(a1, np.int64),
                                            g)).cpu().numpy()
            c_lo, c_hi, valid = planner.split_cost_curves(
                tuple(terms), boxes, axis, g, r_s, cost_fn)
            out_lo.append(c_lo)
            out_hi.append(c_hi)
            out_valid.append(valid)
        return (np.stack(out_lo, 1), np.stack(out_hi, 1),
                np.stack(out_valid, 1))

    # -- device-resident fused ingest ---------------------------------------
    def make_state(self, host: FusedHostState) -> DeviceState:
        return state_from_numpy(host, self.device)

    def scatter_update(self, state: DeviceState,
                       updates: dict[str, tuple]) -> DeviceState:
        """Patch the changed entries in place (a rebalance touches a few
        partitions; nothing else crosses to the device)."""
        for name, (idx, vals) in updates.items():
            arr = getattr(state, name)
            idx = idx if isinstance(idx, tuple) else (idx,)
            arr.index_put_(tuple(self._batch(i, np.int64) for i in idx),
                           self._batch(vals, np.float64).to(arr.dtype))
        return state

    def collector_banks(self, state: DeviceState):
        return (self._host(state.cn_rows, np.float64),
                self._host(state.cn_cols, np.float64))

    def reset_collectors(self, state: DeviceState) -> DeviceState:
        return state._replace(cn_rows=torch.zeros_like(state.cn_rows),
                              cn_cols=torch.zeros_like(state.cn_cols))

    def step(self, state: DeviceState, cp: CostParams, xy,
             track_stats: bool = False, query_batch=None, kw=None):
        """One fused ingest step.  With ``track_stats`` the resident
        collector banks are updated in place (the JAX plane donates its
        state here); the window path never mutates its input state."""
        if query_batch is not None:
            raise NotImplementedError(
                "query registration is a host-boundary event; ingest "
                "QueryBatch through the router between fused windows")
        tr = _tracer()
        with (tr.span("fused_step_dispatch", batch=len(xy)) if tr.enabled
              else contextlib.nullcontext()):
            xy_t = self._batch(xy)
            g = state.grid.shape[0]
            row, col = geometry.points_to_cells(xy_t, g)
            row, col = row.long(), col.long()
            pids = state.grid[row, col]
            owners = state.owner[pids]
            sc = self._cost_scalars(cp)
            dels = None
            if kw is not None:
                from ..queries.keywords import bucket_onehot
                t1 = state.qres_kw.shape[1]
                costs, dels = self._kw_cost_body(
                    pids, owners, state.qres_kw,
                    self._batch(bucket_onehot(kw, t1 - 1)), state.q_machine,
                    state.area_frac, sc)
            else:
                costs = self._cost_body(len(xy), pids, owners, state.qres,
                                        state.q_machine, state.area_frac, sc,
                                        tuple_driven=cp.tuple_driven)
            if track_stats:
                one = torch.ones(len(xy), dtype=torch.float32,
                                 device=self.device)
                state.cn_rows.index_put_((pids, row), one, accumulate=True)
                state.cn_cols.index_put_((pids, col), one, accumulate=True)
            if tr.enabled:
                self._fence()
        out = (self._host(pids, np.int32), self._host(owners, np.int32),
               self._host(costs, np.float32))
        if dels is not None:
            out = out + (self._host(dels, np.float64),)
        return state, out

    def _counts(self, idx: torch.Tensor, n: int) -> torch.Tensor:
        """Exact histogram of ``idx`` over ``n`` bins as float32: a
        scatter-add of ones (integer partial sums stay exact below 2²⁴
        in any order, and no host sync is needed, unlike
        ``torch.bincount`` on the card)."""
        out = torch.zeros(n, dtype=torch.float32, device=self.device)
        return out.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32,
                                                 device=self.device))

    def run_window(self, state: DeviceState, cp: CostParams,
                   fp: FusedParams, carry: EngineCarry, xy_stack,
                   kw_stack=None, cells=None):
        """One window of ``W`` engine ticks, factored through per-tick
        partition counts (the JAX plane's ``_window_fn``).

        Every per-tuple quantity of the fused tick is a function of the
        tuple's partition alone, so each tick's whole effect is its
        (partition) count row: the per-machine queue aggregates are the
        counts weighted by per-partition cost and summed by owner, and
        the N′ collector deltas are counts by (partition, cell
        coordinate).  The staged points cross to the device once; the
        engine dynamics then run as a loop over the W ticks of tiny
        (M,) float32 ops — the mirror of ``fused.host_process_tick`` —
        with one device→host transfer at the end.

        The counts assume *full* staged batches, so the window is valid
        only while backpressure stays idle; ``ok`` is False as soon as
        the throttled injection drops below the batch, and the caller
        then discards every returned value and replays the window
        through the reference path.  The input ``state`` is therefore
        never mutated: the new collector banks are fresh tensors."""
        f32 = torch.float32
        dev = self.device
        w, b = xy_stack.shape[:2]
        g = state.grid.shape[0]
        m = len(fp.alive)
        p_cap = state.owner.shape[0]
        p_used = min(fp.n_alloc, p_cap) if fp.n_alloc else p_cap
        keyword = kw_stack is not None
        tr = _tracer()
        with (tr.span("fused_window_dispatch", ticks=w, batch=b,
                      plane="torch") if tr.enabled
              else contextlib.nullcontext()):
            row, col = geometry.points_to_cells(self._batch(xy_stack), g)
            row, col = row.long(), col.long()
            pids = state.grid[row, col]                          # (W, B)
            tick = torch.arange(w, device=dev)[:, None]
            count_wp = self._counts((tick * p_used + pids).reshape(-1),
                                    w * p_used).view(w, p_used)
            owner_u = state.owner[:p_used]
            owner_m = (owner_u[:, None]
                       == torch.arange(m, device=dev)[None, :]).to(f32)
            own_g = owner_u.clamp_min(0)       # retired rows: −1, no counts
            sc = self._cost_scalars(cp)
            if keyword:
                # (tick, partition, term-bucket) counts against the
                # (P, T+1) pivot histogram — keyword filtering factors
                # through them exactly like routing factors through the
                # partition counts
                (c0, kappa_probe, kappa_match, q_cache, query_area, mf,
                 store_cost, delivery_cost) = sc
                t1 = state.qres_kw.shape[1]
                ids = self._batch(kw_stack, np.int64)            # (W, B, K+1)
                flat = ((tick[:, :, None] * p_used + pids[:, :, None]) * t1
                        + ids)[ids >= 0]
                cnt_wpb = self._counts(flat, w * p_used * t1).view(
                    w, p_used, t1)
                base_p = (c0 + probe_term(torch, state.q_machine[own_g],
                                          kappa_probe, q_cache) + store_cost)
                cov_p = self._cov(query_area, state.area_frac[:p_used])
                del_wp = ((cnt_wpb * state.qres_kw[:p_used][None]).sum(-1)
                          * cov_p[None, :])
                units_wm = (
                    (count_wp[:, :, None] * (base_p[:, None] * owner_m)).sum(1)
                    + (mf * kappa_match + delivery_cost)
                    * (del_wp[:, :, None] * owner_m).sum(1))
                dels_w = del_wp.sum(1)
            else:
                cost_p = self._cost_body(
                    p_used, torch.arange(p_used, device=dev), own_g,
                    state.qres, state.q_machine, state.area_frac, sc,
                    tuple_driven=cp.tuple_driven)
                units_wm = (count_wp[:, :, None]
                            * (cost_p[:, None] * owner_m)).sum(1)
                dels_w = torch.zeros(w, dtype=f32, device=dev)
            tuples_wm = (count_wp[:, :, None] * owner_m).sum(1)
            outs, carry_t, ok = self._scan(units_wm, tuples_wm, carry, fp, b)
            if fp.track_stats:
                g1 = g + 1
                flat_p = pids.reshape(-1) * g1
                state = state._replace(
                    cn_rows=state.cn_rows + self._counts(
                        flat_p + row.reshape(-1), p_cap * g1).view(p_cap, g1),
                    cn_cols=state.cn_cols + self._counts(
                        flat_p + col.reshape(-1), p_cap * g1).view(p_cap, g1))
            # the window's only device→host transfer
            host = torch.cat([outs.reshape(-1), carry_t, ok.to(f32)[None],
                              dels_w]).cpu().numpy().astype(np.float64)
        k = w * (m + 3)
        outs = host[:k].reshape(w, m + 3)
        qu, qt, lam = host[k:k + m], host[k + m:k + 2 * m], host[k + 2 * m]
        ok = bool(host[k + 2 * m + 1])
        return (state, EngineCarry(qu, qt, float(lam)),
                FusedOutputs(outs[:, 0], outs[:, 1], outs[:, 3:],
                             outs[:, 2].astype(np.int64),
                             host[k + 2 * m + 2:] if keyword else None),
                ok)

    def _scan(self, units_wm, tuples_wm, carry: EngineCarry,
              fp: FusedParams, batch: int):
        """The engine's tick dynamics over the window's (W, M) aggregate
        stack, in float32 on the device — the mirror of
        ``fused.host_process_tick`` (and of the JAX plane's scan body).
        Returns the stacked per-tick ``(throughput, latency, injected,
        utilization…)`` rows (W, M+3), the flat final carry ``(queue
        units, queue tuples, λ)`` and the device-side ``ok`` flag."""
        f32 = torch.float32
        sc = self._sc
        cap_units, lambda_max = sc(fp.cap_units), sc(fp.lambda_max)
        bp_high, bp_dec, bp_inc = sc(fp.bp_high), sc(fp.bp_dec), sc(fp.bp_inc)
        eps, zero, one = sc(1e-9), sc(0.0), sc(1.0)
        cap = cap_units * self._dev(fp.alive, np.float32)
        cap_pos = cap > 0
        cap_div = torch.maximum(cap, eps)
        high = bp_high * cap_units
        lam_up = bp_inc * lambda_max
        util_div = torch.maximum(cap_units, eps)
        qu = self._batch(carry.queue_units)
        qt = self._batch(carry.queue_tuples)
        lam = sc(carry.lam_bp)
        rows, oks = [], []
        for i in range(units_wm.shape[0]):
            n = torch.floor(torch.minimum(lambda_max, lam))
            oks.append(n >= batch)             # full-batch optimism holds
            qu = qu + units_wm[i]
            qt = qt + tuples_wm[i]
            pu = torch.minimum(qu, cap)
            avg = torch.where(qt > 0, qu / torch.maximum(qt, eps), one)
            pt = torch.minimum(pu / torch.maximum(avg, eps), qt)
            qu = qu - pt * avg
            qt = qt - pt
            delay = torch.where(cap_pos, qu / cap_div + avg / cap_div, zero)
            w = pt.sum()
            latency = torch.where(w > 0, (delay * pt).sum()
                                  / torch.maximum(w, eps), zero)
            lam = torch.where((qu > high).any(),
                              torch.maximum(lam * bp_dec, one),
                              torch.minimum(lam + lam_up, lambda_max))
            rows.append(torch.cat([torch.stack([w, latency, n]),
                                   pu / util_div]))
        ok = torch.stack(oks).all()
        return (torch.stack(rows), torch.cat([qu, qt, lam[None]]).to(f32),
                ok)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_PLANES: dict[str, object] = {
    "numpy": NumpyPlane, "torch": TorchPlane,
    "torch-cpu": functools.partial(TorchPlane, "cpu")}


@functools.lru_cache(maxsize=None)
def _plane_singleton(name: str) -> DataPlane:
    return _PLANES[name]()


def get_plane(plane: "DataPlane | str | None") -> DataPlane:
    """Resolve a plane argument: an instance passes through, a name is
    looked up (instances are shared — planes are stateless).  ``None``
    and ``"torch"`` mean the card; ``"torch-cpu"`` is the same plane on
    the host and ``"numpy"`` the reference plane."""
    if plane is None:
        return _plane_singleton("torch")
    if isinstance(plane, DataPlane):
        return plane
    if plane == "sharded":
        raise NotImplementedError(
            "the sharded data plane is not ported yet: ROADMAP Queue 1 "
            "item 7")
    if plane not in _PLANES:
        raise ValueError(f"unknown data plane {plane!r}; "
                         f"available: {sorted(_PLANES)}")
    return _plane_singleton(plane)


def available_planes() -> tuple[str, ...]:
    return tuple(sorted(_PLANES))
