"""Sharded data plane: SWARM's machine axis over device shards.

The single-device :class:`~repro_torch.streaming.planes.TorchPlane`
simulates all M machines in one resident state on one device, so a
planner transfer is only a scatter patch.  :class:`ShardedTorchPlane`
places the machines on physically separate state, one shard per
``torch.device`` of :func:`~repro_torch.launch.mesh.streaming_mesh`
(``home[m] = m·D//M`` maps machines to contiguous shard blocks).  One
process drives every shard, as the JAX package's ``shard_map`` drives
its mesh: each shard's work reads only tensors on its own device, and
every byte that crosses between shards is an explicit copy.

* **State layout** (:class:`ShardedState`).  The routing table — the
  cell→partition ``grid``, the ``owner`` table, ``qres``,
  ``area_frac``, ``q_machine`` and the keyword pivot ``qres_kw`` — is
  replicated once per distinct physical device.  The N′ collectors are
  slot-sharded: shard j holds an ``(S, G+1)`` bank for exactly the
  partitions whose owner is homed on it (``slot_pid``/``pid_slot``, as
  the reference's :func:`assign_slots` lays them out).
* **Ingest per shard.**  Each tick's staged batch splits into D
  contiguous chunks, one ingest worker per shard, and each chunk is
  binned onto the ``g×g`` cell grid on its shard's device with exact
  integer scatter-adds (:func:`shard_histograms`, bit for bit
  ``fused.window_histograms``).
* **Owner-keyed exchange.**  A cell's destination is
  ``home[owner[grid]]``.  Each destination keeps the list of cells it
  owns (:class:`_Route`, rebuilt whenever ``grid`` or ``owner``
  changes); every source sends it just those columns of its
  histogram, and the destination sums them in source order — the
  reference's ``lax.all_to_all`` without its dense masked
  ``(D, W, G²)`` array.
* **Exact counts.**  The reference's one-hot ``cell_slot`` products
  become index-adds over the cell → slot map, so no count goes through
  a float32 (or TF32) matmul; the cost and queue contractions are
  elementwise products summed in float32, as in ``TorchPlane``.
* **``psum`` and the replicated scan.**  The per-shard ``(W, M)`` units
  and tuples are summed in shard order on shard 0's device, and
  ``TorchPlane._scan`` runs once there (the reference runs it on every
  shard, on the same inputs).  The carry is uploaded each window, so no
  cache can replay a stale queue state.
* **A throttled window** (backpressure engaged) runs
  ``TorchPlane._throttled_window`` on shard 0's replicas, its collector
  delta folded into the owning shards' slot banks.
* **Round close** is inherited: K1 on shard 0's device over the banks
  :meth:`ShardedTorchPlane.collector_banks` unscatters.
* **Transfers move real bytes.**  :meth:`ShardedTorchPlane.
  reshard_transfers` builds each applied transfer's payload (64 B per
  re-homed query + the store payload) on the sender's device and
  copies it into a buffer allocated on the receiver's (:func:`send`);
  the bytes received equal the billed ``RoundOutcome.migration_bytes``.
* **Spans** (tracer on).  ``sharded_window_dispatch`` holds
  ``shard_ingest`` (``tuples``, host → card ``bytes``), per destination
  ``shard_exchange`` (``shard``, ``bytes`` received from other shards)
  and ``shard_price`` (its slot counts, pricing and psum copies), then
  ``shard_scan``; ``reshard_transfers`` (``transfers``, ``bytes``)
  holds a round's payload copies.  None adds a synchronisation.

On the host, ``get_plane("sharded-cpu")`` or ``data_plane="sharded-cpu"``
with ``EngineConfig(devices=4)`` runs four shards on the CPU; on one
card, ``ShardedTorchPlane(4, "cuda", colocate=True)`` places four
shards on it.  ``tests/test_torch_sharded.py`` holds the parity suite
against the JAX package.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import geometry
from ..launch.mesh import streaming_mesh
from ..telemetry.tracer import _NULL_SPAN, current as _tracer
from .fused import DeviceState, EngineCarry, FusedHostState, FusedParams
from .planes import CostParams, TorchPlane, _UploadCache

# wire format of one re-homed resident query: 16 float32 fields
# (rect, terms digest, counters) = 64 B — matches the cost model's
# BYTES_PER_QUERY billing constant (streaming.baselines)
QUERY_ROW_FLOATS = 16
BYTES_PER_QUERY = 4 * QUERY_ROW_FLOATS


def _pad64(n: int) -> int:
    """Round up to a multiple of 64 (the reference's slot-bank bucket)."""
    return max(64, -(-n // 64) * 64)


def machine_homes(num_machines: int, devices: int) -> np.ndarray:
    """Machine→device map: contiguous blocks, ``home[m] = m·D//M``."""
    return (np.arange(num_machines, dtype=np.int64)
            * devices // max(num_machines, 1)).astype(np.int32)


def assign_slots(owner: np.ndarray, home: np.ndarray, devices: int):
    """Pack every partition id into a per-device slot bank.

    Returns ``(slot_pid (D, S) int32, pid_slot (P,) int32, S)`` with S
    the 64-padded max per-device occupancy (shared bucket → one compile
    per bank size).  All capacity rows get slots — unallocated ids have
    zero ``qres``/counts, so pricing them is exact and the bank size
    tracks the capacity bank like the single-device plane's.
    """
    owner = np.asarray(owner, np.int64)
    dev = home[np.clip(owner, 0, len(home) - 1)].astype(np.int64)
    counts = np.bincount(dev, minlength=devices)
    s = _pad64(max(int(counts.max()), 1))
    order = np.argsort(dev, kind="stable")
    start = np.zeros(devices, np.int64)
    start[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(len(owner), dtype=np.int64) - start[dev[order]]
    slot_pid = np.full((devices, s), -1, np.int32)
    slot_pid[dev[order], rank] = order.astype(np.int32)
    pid_slot = np.empty(len(owner), np.int32)
    pid_slot[order] = rank.astype(np.int32)
    return slot_pid, pid_slot, int(s)


class _Route(NamedTuple):
    """One destination shard's share of the cell grid: the cells whose
    owner is homed on it, and where each lands in its slot bank."""

    cells: tuple             # (n,) int64 flat cell ids, one copy per
    #                          physical device (the sources gather with it)
    slot: torch.Tensor       # (n,) int64 slot of each cell's partition
    bank_row: torch.Tensor   # (n,) int64 slot·(G+1) + cell row
    bank_col: torch.Tensor   # (n,) int64 slot·(G+1) + cell column
    pids: torch.Tensor       # (S,) int64 slot → partition id (−1 = empty)


class ShardedState(NamedTuple):
    """The fused state with the machine axis over D shards.

    The first five fields keep :class:`~repro_torch.streaming.fused.
    DeviceState`'s names (so ``FusedHostState.diff`` patches apply
    unchanged) and hold one replica per distinct physical device, in
    the order the shards first name them.  ``cn_rows``/``cn_cols`` hold
    one ``(S, G+1)`` float32 bank per shard on that shard's device.
    ``slot_pid`` (D, S), ``pid_slot`` (P,) and ``home`` (M,) are the
    reference's slot layout as host arrays; ``host_grid``/``host_owner``
    mirror the plan the layout and ``routes`` (one :class:`_Route` per
    shard) are built from."""

    grid: tuple
    owner: tuple
    qres: tuple
    area_frac: tuple
    q_machine: tuple
    cn_rows: tuple
    cn_cols: tuple
    qres_kw: tuple | None = None
    slot_pid: np.ndarray | None = None
    pid_slot: np.ndarray | None = None
    home: np.ndarray | None = None
    host_grid: np.ndarray | None = None
    host_owner: np.ndarray | None = None
    routes: tuple | None = None


def _distinct(shards) -> tuple:
    """The physical devices of ``shards``, in the order they first
    appear (replica r of a replicated field lives on ``_distinct[r]``)."""
    return tuple(dict.fromkeys(shards))


def _routes(grid, owner, home, slot_pid, pid_slot, shards) -> tuple:
    """Per-destination cell lists of the plan ``(grid, owner)``.  A
    cell goes where its partition's slot is: ``home`` of the owner,
    clipped as :func:`assign_slots` clips retired (−1) owners."""
    phys = _distinct(shards)
    g1 = grid.shape[0] + 1
    flat = grid.reshape(-1)
    dest = home[np.clip(owner[flat], 0, len(home) - 1)]
    out = []
    for j, dev in enumerate(shards):
        cells = np.flatnonzero(dest == j).astype(np.int64)
        slot = pid_slot[flat[cells]].astype(np.int64)
        row, col = np.divmod(cells, grid.shape[0])
        up = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.int64)).to(dev)
        out.append(_Route(tuple(torch.from_numpy(cells).to(p) for p in phys),
                          up(slot), up(slot * g1 + row), up(slot * g1 + col),
                          up(slot_pid[j])))
    return tuple(out)


def state_from_numpy(host, devices) -> ShardedState:
    """Upload one router snapshot as a :class:`ShardedState` over the
    shard devices ``devices`` — the sharded twin of
    ``planes.state_from_numpy``.  ``host`` is any object with the
    :class:`FusedHostState` fields as NumPy arrays (the JAX package's
    snapshot works as is).  Index tables are int64, everything else
    float32; the collector banks start at zero."""
    shards = tuple(torch.device(d) for d in devices)
    phys = _distinct(shards)
    rep = lambda a, dt: tuple(  # noqa: E731
        torch.tensor(np.asarray(a, dt), device=p) for p in phys)
    grid = np.array(host.grid, np.int64)
    owner = np.array(host.owner, np.int64)
    home = machine_homes(len(host.q_machine), len(shards))
    slot_pid, pid_slot, s = assign_slots(owner, home, len(shards))
    g1 = grid.shape[0] + 1
    zeros = lambda: tuple(  # noqa: E731
        torch.zeros((s, g1), dtype=torch.float32, device=d) for d in shards)
    return ShardedState(
        rep(grid, np.int64), rep(owner, np.int64),
        rep(host.qres, np.float32), rep(host.area_frac, np.float32),
        rep(host.q_machine, np.float32), zeros(), zeros(),
        None if host.qres_kw is None else rep(host.qres_kw, np.float32),
        slot_pid, pid_slot, home, grid, owner,
        _routes(grid, owner, home, slot_pid, pid_slot, shards))


def _upload(arr: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)


def shard_histograms(xy_stack, g: int, shards, *, cells=None, kw_stack=None,
                     t1: int = 0):
    """Per-shard ingest histograms of one staged window, each binned on
    its shard's device: the device twin of ``fused.window_histograms``.

    Each tick's batch splits into ``len(shards)`` contiguous chunks
    (``bounds = b·arange(D+1)//D``); shard k bins chunk k of every tick
    onto the flat ``g×g`` grid, from the batches' ``cells`` when given
    (``(W, B)`` flat ids) and from the points otherwise.  Returns
    ``(hists, kw_hists)``: a ``(W, g²)`` float32 count tensor per shard
    and, for spatial-keyword windows (``t1 = term buckets + 1``,
    ``kw_stack`` the ``(W, B, K+1)`` probe buckets, −1 unused), a
    ``(W, g²·t1)`` one per shard; ``kw_hists`` is ``None`` when ``t1``
    is 0.  Every count is an integer scatter-add, so the tensors equal
    the reference's bincounts bit for bit."""
    xy_stack = np.asarray(xy_stack)
    w, b = xy_stack.shape[:2]
    d = len(shards)
    bounds = (b * np.arange(d + 1)) // d
    cells = None if cells is None else np.stack(
        [np.asarray(c, np.int64) for c in cells])
    n_cells = g * g
    hists, kwh = [], []
    for k, dev in enumerate(shards):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        tick = torch.arange(w, device=dev)[:, None]
        if cells is not None:
            cell = _upload(cells[:, lo:hi], np.int64, dev)
        else:
            row, col = geometry.points_to_cells(
                _upload(xy_stack[:, lo:hi], np.float32, dev), g)
            cell = row.long() * g + col.long()
        hists.append(TorchPlane._counts(
            (tick * n_cells + cell).reshape(-1), w * n_cells).view(
                w, n_cells))
        if t1:
            ids = _upload(np.asarray(kw_stack)[:, lo:hi], np.int64, dev)
            flat = ((tick[:, :, None] * n_cells + cell[:, :, None]) * t1
                    + ids)[ids >= 0]
            kwh.append(TorchPlane._counts(flat, w * n_cells * t1).view(
                w, n_cells * t1))
    return tuple(hists), (tuple(kwh) if t1 else None)


def send(buf: np.ndarray, src, dst) -> tuple[torch.Tensor, torch.Tensor]:
    """Move one reshard payload: place ``buf`` on the sender's device
    ``src``, then copy it into a buffer allocated on the receiver's
    device ``dst``.  Returns ``(sent, received)``.  The received tensor
    never shares storage with the sent one, also when both shards sit
    on one device (``.to`` would then return the same tensor)."""
    sent = torch.from_numpy(buf).to(src)
    got = torch.empty(sent.shape, dtype=sent.dtype, device=dst)
    got.copy_(sent)
    if got.device.type == "cuda":
        torch.cuda.synchronize(got.device)
    return sent, got


class ShardedTorchPlane(TorchPlane):
    """The data plane with SWARM's machine axis over D device shards.

    The per-call routing and pricing API, ``split_costs`` and the round
    close (K1) are inherited from :class:`TorchPlane` and run on shard
    0's device; the fused-window contract is rebuilt over the shards
    (module docstring).  ``devices=None`` means every visible card (one
    shard on the CPU); ``colocate=True`` allows more shards than cards.
    Instances of ``"sharded"`` and ``"sharded-cpu"`` are both named
    ``"sharded"``, the name the sanitizer's reshard-billing law keys on."""

    name = "sharded"
    wants_cells = True

    def __init__(self, devices: int | None = None, device="cuda", *,
                 colocate: bool = False):
        self.shards = streaming_mesh(devices, device, colocate=colocate)
        super().__init__(self.shards[0])
        self._phys = _distinct(self.shards)
        self._rep = tuple(self._phys.index(s) for s in self.shards)
        self._uploads = {p: (self._upload if p == self.device
                             else _UploadCache(p)) for p in self._phys}
        # running totals: bytes moved by reshard_transfers (held equal
        # to the billed migration bytes), and over the windows whose
        # full batch held (``ok``; a throttled window runs on shard 0)
        # the bytes the exchange sent between shards, the windows and
        # the tuples each shard binned
        self.reshard_bytes_total = 0
        self.exchange_bytes_total = 0
        self.windows = 0
        self.shard_tuples = np.zeros(len(self.shards), np.int64)

    @property
    def devices(self) -> int:
        return len(self.shards)

    @property
    def colocated(self) -> bool:
        """Whether some shards share a physical device."""
        return len(self._phys) < len(self.shards)

    def _fence(self) -> None:
        for p in self._phys:
            if p.type == "cuda":
                torch.cuda.synchronize(p)

    # -- state layout --------------------------------------------------------
    def make_state(self, host: FusedHostState) -> ShardedState:
        return state_from_numpy(host, self.shards)

    def scatter_update(self, state: ShardedState, updates) -> ShardedState:
        """Patch every replica in place; when ``owner`` changed
        (a transfer, recovery re-homing, a split allocating pids) the
        slot layout is recomputed, and when ``grid`` or ``owner``
        changed the per-destination cell lists are rebuilt."""
        for name, (idx, vals) in updates.items():
            idx = idx if isinstance(idx, tuple) else (idx,)
            for arr in getattr(state, name):
                arr.index_put_(tuple(_upload(i, np.int64, arr.device)
                                     for i in idx),
                               _upload(vals, np.float64,
                                       arr.device).to(arr.dtype))
            if name in ("grid", "owner"):
                getattr(state, "host_" + name)[idx] = vals
        if "owner" in updates:
            state = self._resync_slots(state)
        if "grid" in updates or "owner" in updates:
            state = state._replace(routes=_routes(
                state.host_grid, state.host_owner, state.home,
                state.slot_pid, state.pid_slot, self.shards))
        return state

    def _resync_slots(self, state: ShardedState) -> ShardedState:
        slot_pid, pid_slot, s = assign_slots(state.host_owner, state.home,
                                             self.devices)
        if np.array_equal(slot_pid, state.slot_pid):
            return state
        # re-home the banks through partition order.  The engine drains
        # the collectors before any plan change reaches the plane, so
        # these are zeros in practice — moving the contents keeps the
        # operation exact for any caller
        valid = slot_pid >= 0
        banks = []
        for bank in self.collector_banks(state):
            new = np.zeros((self.devices, s, bank.shape[1]), np.float32)
            new[valid] = bank[slot_pid[valid]]
            banks.append(tuple(torch.tensor(new[j], device=dev)
                               for j, dev in enumerate(self.shards)))
        return state._replace(cn_rows=banks[0], cn_cols=banks[1],
                              slot_pid=slot_pid, pid_slot=pid_slot)

    def reset_collectors(self, state: ShardedState) -> ShardedState:
        zeros = tuple(torch.zeros_like(b) for b in state.cn_rows)
        return state._replace(cn_rows=zeros,
                              cn_cols=tuple(torch.zeros_like(b)
                                            for b in state.cn_cols))

    def collector_banks(self, state: ShardedState):
        """Unscatter the per-shard slot banks into partition order,
        (P, G+1) float64 host arrays for ``Swarm.absorb_collectors``."""
        p = len(state.host_owner)
        out = []
        for banks in (state.cn_rows, state.cn_cols):
            full = np.zeros((p, banks[0].shape[1]), np.float64)
            for sp, bank in zip(state.slot_pid, banks):
                valid = sp >= 0
                full[sp[valid]] = bank.cpu().numpy()[valid]
            out.append(full)
        return out[0], out[1]

    # -- single-tick path (tests and tools; the engine's boundary ticks
    #    use the per-call API) ------------------------------------------------
    def step(self, state: ShardedState, cp: CostParams, xy,
             track_stats: bool = False, query_batch=None, kw=None):
        """``TorchPlane.step`` on shard 0's replicas, its collector delta
        then folded into the owning shards' slot banks."""
        return self._on_shard0(
            state, track_stats, lambda tmp: TorchPlane.step(
                self, tmp, cp, xy, track_stats, query_batch, kw))

    def _on_shard0(self, state: ShardedState, track_stats: bool, body):
        """``body`` on shard 0's replicas as one device's state, with
        zeroed collector banks where ``track_stats``, the banks' delta
        then folded into the owning shards' slot banks.  Returns
        ``(state, *body's other results)``."""
        p, g1 = state.owner[0].shape[0], state.cn_rows[0].shape[1]
        zeros = (torch.zeros((p, g1), dtype=torch.float32,
                             device=self.device) if track_stats else None)
        tmp = DeviceState(state.grid[0], state.owner[0], state.qres[0],
                          state.area_frac[0], state.q_machine[0], zeros,
                          None if zeros is None else zeros.clone(),
                          None if state.qres_kw is None
                          else state.qres_kw[0])
        tmp, *rest = body(tmp)
        if track_stats:
            state = state._replace(
                cn_rows=self._fold(state.cn_rows, tmp.cn_rows, state),
                cn_cols=self._fold(state.cn_cols, tmp.cn_cols, state))
        return (state, *rest)

    def _fold(self, banks, delta, state) -> tuple:
        out = []
        for sp, bank, dev in zip(state.slot_pid, banks, self.shards):
            sp = _upload(sp, np.int64, self.device)
            rows = delta[sp.clamp_min(0)] * (sp >= 0)[:, None]
            out.append(bank + rows.to(dev))
        return tuple(out)

    # -- fused window --------------------------------------------------------
    def _exchange(self, hists, route, j: int):
        """What destination shard ``j`` receives in the owner-keyed
        exchange: from every source, in source order, the columns of the
        cells it owns, summed.  Returns ``(received, bytes sent between
        distinct shards)``."""
        dev = self.shards[j]
        total, sent = None, 0
        for k, h in enumerate(hists):
            part = h[:, route.cells[self._rep[k]]]     # gathered at source k
            if k != j:
                sent += part.numel() * part.element_size()
            part = part.to(dev)
            total = part if total is None else total + part
        return total, sent

    def _throttled_window(self, state: ShardedState, cp: CostParams,
                          fp: FusedParams, carry: EngineCarry, xy_stack,
                          kw_stack=None, cells=None):
        """``TorchPlane._throttled_window`` on shard 0's replicas, its
        collector delta then folded into the owning shards' slot banks,
        as :meth:`step` does."""
        return self._on_shard0(
            state, fp.track_stats, lambda tmp: TorchPlane._throttled_window(
                self, tmp, cp, fp, carry, xy_stack, kw_stack, cells))

    def _full_window(self, state: ShardedState, cp: CostParams,
                     fp: FusedParams, carry: EngineCarry, xy_stack,
                     kw_stack=None, cells=None):
        """One window of W engine ticks over the shards: per-shard
        ingest histograms, the owner-keyed exchange, per-shard slot
        counts and (W, M) aggregates, their sum in shard order and
        ``TorchPlane._scan`` on shard 0 (module docstring).  As with
        ``TorchPlane``, the window holds only while backpressure stays
        idle: ``ok`` False means :meth:`run_window` discards everything
        returned, so the input ``state`` is never mutated (the new
        banks are fresh tensors)."""
        f32 = torch.float32
        w, b = np.shape(xy_stack)[:2]
        g = int(state.host_grid.shape[0])
        g1 = g + 1
        m = len(fp.alive)
        d = self.devices
        keyword = kw_stack is not None
        t1 = int(state.qres_kw[0].shape[1]) if keyword else 0
        tr = _tracer()
        on = tr.enabled
        with (tr.span("sharded_window_dispatch", ticks=w, batch=b,
                      plane="sharded", devices=d) if on else _NULL_SPAN):
            # host → card: 8 B a tuple (an int64 cell id or two float32
            # coordinates), and 8 B a probe bucket
            with (tr.span("shard_ingest", tuples=w * b,
                          bytes=8 * (w * b + (np.size(kw_stack) if t1
                                              else 0)))
                  if on else _NULL_SPAN):
                hists, kwh = shard_histograms(xy_stack, g, self.shards,
                                              cells=cells, kw_stack=kw_stack,
                                              t1=t1)
            if keyword:
                kwh = tuple(h.view(w, g * g, t1) for h in kwh)
            units_wm = tuples_wm = dels_w = None
            rows, cols, sent = [], [], 0
            for j, (route, dev) in enumerate(zip(state.routes, self.shards)):
                r = self._rep[j]
                with (tr.span("shard_exchange", shard=j) if on
                      else _NULL_SPAN) as ex:
                    mine, nbytes = self._exchange(hists, route, j)
                    if keyword:
                        mine_kw, kw_bytes = self._exchange(kwh, route, j)
                        nbytes += kw_bytes
                    ex.set(bytes=nbytes)
                sent += nbytes
                with (tr.span("shard_price", shard=j) if on
                      else _NULL_SPAN):
                    s = route.pids.shape[0]
                    sp = route.pids.clamp_min(0)
                    own = state.owner[r][sp]
                    own_sm = ((own[:, None]
                               == torch.arange(m, device=dev)[None])
                              & (route.pids >= 0)[:, None]).to(f32)
                    count_ws = torch.zeros((w, s), dtype=f32, device=dev
                                           ).index_add_(1, route.slot, mine)
                    sc = self._cost_scalars(cp, self._uploads[self._phys[r]])
                    if keyword:
                        cnt_wsb = torch.zeros(
                            (w, s, t1), dtype=f32, device=dev
                        ).index_add_(1, route.slot, mine_kw)
                        units_j, dels_j = self._kw_window_body(
                            count_ws, cnt_wsb, sp, own.clamp_min(0), own_sm,
                            state.qres_kw[r], state.q_machine[r],
                            state.area_frac[r], sc)
                        dels_j = dels_j.to(self.device)
                        dels_w = dels_j if dels_w is None else dels_w + dels_j
                    else:
                        cost_s = self._cost_body(
                            s, sp, own.clamp_min(0), state.qres[r],
                            state.q_machine[r], state.area_frac[r], sc,
                            tuple_driven=cp.tuple_driven)
                        units_j = (count_ws[:, :, None]
                                   * (cost_s[:, None] * own_sm)).sum(1)
                    tuples_j = (count_ws[:, :, None] * own_sm).sum(1)
                    # the psum: shard order, on shard 0's device
                    units_j = units_j.to(self.device)
                    tuples_j = tuples_j.to(self.device)
                    units_wm = (units_j if units_wm is None
                                else units_wm + units_j)
                    tuples_wm = (tuples_j if tuples_wm is None
                                 else tuples_wm + tuples_j)
                    if fp.track_stats:
                        # the shard's own cells' row and column counts
                        # into its own slot bank
                        hist = mine.sum(0)
                        size = s * g1
                        rows.append(state.cn_rows[j] + torch.zeros(
                            size, dtype=f32, device=dev).index_add_(
                                0, route.bank_row, hist).view(s, g1))
                        cols.append(state.cn_cols[j] + torch.zeros(
                            size, dtype=f32, device=dev).index_add_(
                                0, route.bank_col, hist).view(s, g1))
            with (tr.span("shard_scan") if on else _NULL_SPAN):
                if dels_w is None:
                    dels_w = torch.zeros(w, dtype=f32, device=self.device)
                outs, carry_t, ok = self._scan(units_wm, tuples_wm, carry,
                                               fp, b)
                carry, outs, ok = self._download(outs, carry_t, ok, dels_w,
                                                 keyword)
            if on:
                self._fence()
        if fp.track_stats:
            state = state._replace(cn_rows=tuple(rows), cn_cols=tuple(cols))
        binned = np.diff((b * np.arange(d + 1)) // d) * w
        if ok:
            self.shard_tuples += binned
            self.exchange_bytes_total += sent
            self.windows += 1
        if on:
            # per-shard ingest tracks: tuples each shard's worker binned
            for k in range(d):
                tr.counter("shard_tuples", float(binned[k]), machine=k)
        return state, carry, outs, ok

    # -- transfers as physical resharding ------------------------------------
    def reshard_transfers(self, state, outcome, router) -> int:
        """Move each applied transfer's payload sender shard → receiver
        shard and return the bytes received.

        Payload per transfer = one (moved_queries, 16) float32 block of
        re-homed resident-query rows (64 B each, the wire format the
        cost model bills as ``BYTES_PER_QUERY``; pid, qres and area
        fraction in the header columns, read from ``router``'s plan)
        plus — on the first transfer —
        the migrated store payload (the simulated store is a count
        sketch, so the buffer carries exactly the billed bytes).  The
        total therefore equals the billed
        ``RoundOutcome.migration_bytes``."""
        transfers = tuple(getattr(outcome, "transfers", ()) or ())
        if state is None or not transfers:
            return 0
        tr = _tracer()
        with (tr.span("reshard_transfers", transfers=len(transfers))
              if tr.enabled else _NULL_SPAN) as sp:
            home = state.home
            # the header columns come from the router's plan after the
            # round: a split in the same round can hand a transfer pids
            # past the resident state's capacity (the reference reads the
            # state and raises IndexError there, ROADMAP F8)
            plan = router.fused_host_state()
            qres, af = plan.qres, plan.area_frac
            moved_q = int(getattr(outcome, "moved_queries", 0) or 0)
            migration = int(getattr(outcome, "migration_bytes", 0) or 0)
            per_q = BYTES_PER_QUERY
            data_bytes = migration - per_q * moved_q
            if data_bytes < 0:      # router bills a different query size
                per_q, data_bytes = 0, migration
            moved_by = list(getattr(outcome, "moved_by_transfer", ())
                            or ())
            if (len(moved_by) != len(transfers)
                    or sum(moved_by) != moved_q):
                moved_by = [moved_q] + [0] * (len(transfers) - 1)
            total = 0
            for i, (rec, nq) in enumerate(zip(transfers, moved_by)):
                src = self.shards[int(home[rec.m_h]) % self.devices]
                dst = self.shards[int(home[rec.m_l]) % self.devices]
                payload = []
                if per_q and nq:
                    rows = np.zeros((int(nq), QUERY_ROW_FLOATS),
                                    np.float32)
                    pids = np.asarray(rec.new_pids, np.int64)[:int(nq)]
                    rows[:len(pids), 0] = pids
                    rows[:len(pids), 1] = qres[pids]
                    rows[:len(pids), 2] = af[pids]
                    payload.append(rows)
                if i == 0 and data_bytes:
                    payload.append(np.zeros(int(data_bytes), np.uint8))
                moved = 0
                for buf in payload:
                    _, got = send(buf, src, dst)
                    moved += got.numel() * got.element_size()
                total += moved
                if tr.enabled and moved:
                    tr.counter("reshard_bytes", float(moved),
                               machine=int(rec.m_l))
            sp.set(bytes=total)
        self.reshard_bytes_total += total
        return total


@functools.lru_cache(maxsize=None)
def sharded_plane(devices: int | None = None,
                  device="cuda") -> ShardedTorchPlane:
    """Shared plane instance per (shard count, device);
    ``EngineConfig.devices`` and the plane names ``"sharded"`` /
    ``"sharded-cpu"`` resolve through here.  Shards colocated on fewer
    cards are built as ``ShardedTorchPlane(D, "cuda", colocate=True)``."""
    return ShardedTorchPlane(devices, device)
