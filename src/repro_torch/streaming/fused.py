"""Device-resident streaming fast path: shared containers + reference
tick dynamics.

The per-call data-plane API re-converts and re-uploads the router's
state arrays on every batch and pulls per-item owners/costs back to the
host, where the engine and SWARM's collectors do host-side scatter
work.  At realistic batch sizes that makes the adaptivity machinery
*heavier* than the streamed workload — the opposite of SWARM's premise.
The fused path keeps the steady-state ingest loop device-resident:

* :class:`DeviceState` — everything the ingest hot path reads or writes,
  living on the device across ticks: the cell→partition ``grid``, the
  partition ``owner`` table, per-partition resident queries ``qres`` and
  ``area_frac``, per-machine resident queries ``q_machine``, and the two
  N′ statistics-collector banks (``cn_rows``/``cn_cols``) that absorb
  per-tuple updates until the round close.
* :class:`FusedHostState` — the router-side snapshot a ``DeviceState``
  is built from (and diffed against, so a rebalance becomes a scatter
  update of the few changed entries rather than a re-upload).
* :class:`FusedParams` / :class:`EngineCarry` / :class:`FusedOutputs` —
  the scalar bundle, the per-tick mutable engine state and the stacked
  per-tick metrics crossing the host boundary once per *window*.
* :func:`host_process_tick` — steps 4–6 of the engine tick (process,
  latency, backpressure) as a standalone function.  Both the per-tick
  engine loop and the NumPy plane's fused window call it, so the fused
  reference path is metrics-equal to the per-tick loop *by
  construction*; the JAX plane mirrors the same formulas in float32
  inside its scanned step.

Query registration, snapshot probes and rebalancing stay host-boundary
events by design: they are rare relative to tuple ingest, and the round
pipeline (``core.planner``) is already batched host code.  The engine
(:meth:`~repro.streaming.engine.StreamingEngine.run_fused`) cuts its
scan windows at exactly those ticks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np


class DeviceState(NamedTuple):
    """Device-resident ingest state (NamedTuple → a JAX pytree for
    free; the NumPy plane uses the same container with host arrays).

    ``grid``/``owner``/``qres``/``area_frac``/``q_machine`` are
    read-only within a window; the collector banks ``cn_rows``/
    ``cn_cols`` (shape (P, G+1), the N′ channel of
    ``core.statistics``) are accumulated in place and drained into the
    host stats bank at host-boundary events via
    ``Swarm.absorb_collectors``."""

    grid: object        # (G, G) int32 cell → partition
    owner: object       # (P,) int32 partition → machine
    qres: object        # (P,) resident-query counts
    area_frac: object   # (P,) partition area fraction
    q_machine: object   # (M,) per-machine resident queries
    cn_rows: object     # (P, G+1) float32 N' row collector deltas
    cn_cols: object     # (P, G+1) float32 N' col collector deltas
    # (P, T+1) per-partition pivot-bucket histogram (column T = the
    # wildcard bucket); None unless the workload is spatial-keyword
    qres_kw: object = None


@dataclass(frozen=True)
class FusedHostState:
    """Router-state snapshot behind one :class:`DeviceState`.

    Arrays are *copies* (the router mutates its own in place), kept in
    the router's native dtypes so the NumPy reference path prices
    batches bit-for-bit like the per-tick loop; the JAX plane applies
    its usual float32/int32 device casts when uploading.
    ``track_stats`` is True for routers that feed SWARM's collectors
    (the others skip the collector scatter entirely)."""

    grid: np.ndarray
    owner: np.ndarray
    qres: np.ndarray
    area_frac: np.ndarray
    q_machine: np.ndarray
    track_stats: bool = False
    n_alloc: int = 0      # allocated-id prefix (ids are never reused)
    # (capacity, T+1) pivot-bucket histogram for spatial-keyword
    # workloads, None otherwise
    qres_kw: np.ndarray | None = None

    @property
    def capacity(self) -> int:
        return len(self.owner)

    def diff(self, new: "FusedHostState") -> dict[str, tuple] | None:
        """Per-field changed indices vs ``new``: the scatter updates
        that bring a device state built from ``self`` up to date.
        Returns ``None`` when shapes changed (full rebuild needed)."""
        updates: dict[str, tuple] = {}
        names = ["grid", "owner", "qres", "area_frac", "q_machine"]
        if (self.qres_kw is None) != (new.qres_kw is None):
            return None
        if self.qres_kw is not None:
            names.append("qres_kw")
        for name in names:
            a, b = getattr(self, name), getattr(new, name)
            if a.shape != b.shape:
                return None
            idx = np.nonzero(a != b)
            if len(idx[0]):
                updates[name] = (idx if a.ndim > 1 else idx[0], b[idx])
        return updates


class EngineCarry(NamedTuple):
    """Mutable engine state threaded through a scan window."""

    queue_units: object   # (M,)
    queue_tuples: object  # (M,)
    lam_bp: object        # scalar backpressure-throttled injection rate


class FusedOutputs(NamedTuple):
    """Stacked per-tick metrics of one window — the only device→host
    traffic of the steady state (O(W·M), never O(W·batch))."""

    throughput: np.ndarray   # (W,) processed tuples
    latency: np.ndarray      # (W,)
    utilization: np.ndarray  # (W, M)
    injected: np.ndarray     # (W,) int
    # (W,) expected subscription deliveries (spatial-keyword workloads
    # only; None keeps the pure-spatial windows byte-identical)
    deliveries: np.ndarray | None = None


@dataclass(frozen=True)
class FusedParams:
    """Engine scalars a fused window needs besides the cost params."""

    cap_units: float
    lambda_max: float
    bp_high: float
    bp_dec: float
    bp_inc: float
    # (M,) effective-capacity mask: alive × per-machine capacity factor
    # (0 = dead/standby, <1 = straggler) — membership and slowdowns
    # reach the fused tick dynamics through this one array
    alive: np.ndarray
    track_stats: bool = False
    n_alloc: int = 0         # allocated-id prefix of the state banks


def host_process_tick(queue_units: np.ndarray, queue_tuples: np.ndarray,
                      lam_bp: float, cap_units: float, alive: np.ndarray,
                      bp_high: float, bp_dec: float, bp_inc: float,
                      lambda_max: float):
    """Steps 4–6 of one engine tick: process queued work against
    capacity, derive latency, update global backpressure.  ``alive`` is
    the effective-capacity mask (alive × capacity factor), so dead
    machines process nothing and stragglers proportionally less.

    Mutates ``queue_units``/``queue_tuples`` in place and returns
    ``(processed_units, processed_total, latency, lam_bp)``.  This is
    *the* definition of the engine's tick dynamics — ``StreamingEngine.
    step`` and ``NumpyPlane.run_window`` both call it, and
    ``JaxPlane``'s scanned step mirrors it in float32."""
    cap = cap_units * alive
    processed_units = np.minimum(queue_units, cap)
    avg_cost = np.where(queue_tuples > 0,
                        queue_units / np.maximum(queue_tuples, 1e-9),
                        1.0)
    processed_tuples = np.minimum(
        processed_units / np.maximum(avg_cost, 1e-9), queue_tuples)
    queue_units -= processed_tuples * avg_cost
    queue_tuples -= processed_tuples
    with np.errstate(divide="ignore", invalid="ignore"):
        delay = np.where(cap > 0, queue_units / np.maximum(cap, 1e-9)
                         + avg_cost / np.maximum(cap, 1e-9), 0.0)
    w = processed_tuples.sum()
    latency = float((delay * processed_tuples).sum() / w) if w > 0 else 0.0
    if (queue_units > bp_high * cap_units).any():
        lam_bp = max(lam_bp * bp_dec, 1.0)
    else:
        lam_bp = min(lam_bp + bp_inc * lambda_max, lambda_max)
    return processed_units, float(w), latency, lam_bp


def window_histograms(xy_stack, g: int, *, devices: int = 1,
                      wp: int | None = None, cells=None, kw_stack=None,
                      t1: int = 0):
    """Per-ingest-worker cell histograms of one staged window.

    Splits each tick's batch into ``devices`` contiguous chunks (one per
    ingest worker / device shard) and bincounts each chunk onto the flat
    ``g×g`` cell grid, returning ``(devices, wp, g²)`` float32 — padded
    with zero ticks up to ``wp``.  Summing over the worker axis
    reproduces the single-device per-tick bincount *exactly* (integer
    counts), which is what makes the sharded plane's owner-exchange
    ``all_to_all`` metrics-identical to the single-device plane.

    ``cells`` (optional, ``(w, b)`` flat cell ids) skips the per-window
    point→cell pass when batches carry precomputed ingest-tier cell ids
    (:class:`~repro.streaming.api.TupleBatch`).  For spatial-keyword
    workloads pass ``kw_stack`` ((w, b, K+1) hashed probe buckets, −1 =
    unused column) and ``t1 = term_buckets + 1`` to additionally get the
    per-worker (cell × bucket) histograms ``(devices, wp, g²·t1)``.
    Returns ``(hists, kw_hists)``; ``kw_hists`` is ``None`` when ``t1``
    is 0.
    """
    from ..core import geometry
    w, b = len(xy_stack), len(xy_stack[0])
    wp = wp or w
    d = max(int(devices), 1)
    bounds = (b * np.arange(d + 1)) // d
    hists = np.zeros((d, wp, g * g), np.float32)
    kwh = np.zeros((d, wp, g * g * t1), np.float32) if t1 else None
    for i in range(w):
        if cells is not None:
            cell = np.asarray(cells[i], np.int64)
        else:
            row, col = geometry.points_to_cells(
                np.asarray(xy_stack[i], np.float32), g)
            cell = row.astype(np.int64) * g + col
        for k in range(d):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            hists[k, i] = np.bincount(cell[lo:hi], minlength=g * g)
            if t1:
                ids = np.asarray(kw_stack[i][lo:hi], np.int64)
                flat = cell[lo:hi, None] * t1 + ids
                kwh[k, i] = np.bincount(flat[ids >= 0].reshape(-1),
                                        minlength=g * g * t1)
    return hists, kwh
