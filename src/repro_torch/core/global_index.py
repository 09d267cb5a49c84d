"""SWARM global index (paper §4.1.1).

A 2-D grid of cells where each cell points to the partition covering it;
each partition records its borders and owning executor machine.  Routing
a point is one gather (O(1)); routing a range query uses Algorithm 1's
partition-skipping walk — or, TPU-natively, a vectorized overlap test
against the (small) partition table, which is branch-free and batchable.

The index is *functional*: mutation produces new arrays, giving the
latch-free reader semantics of §4.3.1/§5.1 (an in-flight router keeps a
consistent snapshot while the Coordinator installs the new plan).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import geometry

NO_PARTITION = -1


@dataclass
class PartitionTable:
    """Dense table of partitions (capacity P_MAX, grows by doubling)."""

    r0: np.ndarray
    c0: np.ndarray
    r1: np.ndarray
    c1: np.ndarray
    owner: np.ndarray        # executor machine id; −1 when retired
    alive: np.ndarray        # bool — currently routable
    parent: np.ndarray       # parent partition id in the chain (§5.2), −1 none
    prev_machine: np.ndarray  # previous responsible machine (§5.2), −1 none
    birth_round: np.ndarray   # round the partition was created
    n_alloc: int = 0

    @classmethod
    def with_capacity(cls, p_max: int) -> "PartitionTable":
        z = lambda fill, dt: np.full(p_max, fill, dt)
        return cls(z(0, np.int32), z(0, np.int32), z(-1, np.int32), z(-1, np.int32),
                   z(-1, np.int32), np.zeros(p_max, bool), z(-1, np.int32),
                   z(-1, np.int32), z(0, np.int32), 0)

    @property
    def capacity(self) -> int:
        return len(self.owner)

    def _grow(self) -> None:
        for name in ("r0", "c0", "r1", "c1", "owner", "parent", "prev_machine",
                     "birth_round"):
            arr = getattr(self, name)
            setattr(self, name, np.concatenate([arr, np.full_like(arr, -1)]))
        self.alive = np.concatenate([self.alive, np.zeros_like(self.alive)])

    def allocate(self, r0: int, c0: int, r1: int, c1: int, owner: int,
                 parent: int = -1, prev_machine: int = -1, birth_round: int = 0) -> int:
        """Allocate a fresh unique partition id (paper: ids are never reused
        while a chain may reference them; we simply never reuse)."""
        if self.n_alloc == self.capacity:
            self._grow()
        pid = self.n_alloc
        self.n_alloc += 1
        self.r0[pid], self.c0[pid], self.r1[pid], self.c1[pid] = r0, c0, r1, c1
        self.owner[pid], self.alive[pid] = owner, True
        self.parent[pid], self.prev_machine[pid] = parent, prev_machine
        self.birth_round[pid] = birth_round
        return pid

    def retire(self, pid: int) -> None:
        self.alive[pid] = False

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.alive[: self.n_alloc])[0]


@dataclass
class GlobalIndex:
    grid_size: int
    cell_to_partition: np.ndarray  # (G, G) int32 → partition id
    parts: PartitionTable

    # ------------------------------------------------------------------
    # Initialization (§4.1.1): recursively split the largest-area
    # partition (longer side first) until each machine owns one.
    # ------------------------------------------------------------------
    @classmethod
    def initialize(cls, grid_size: int, num_machines: int,
                   p_capacity: int | None = None,
                   active_machines: int | None = None) -> "GlobalIndex":
        """``active_machines`` < ``num_machines`` leaves the trailing
        machine slots standby: partitions are split among (and owned
        by) the first ``active_machines`` machines only — standby slots
        receive work only after they join and the balancer re-homes
        load onto them (elastic scale-out)."""
        active = num_machines if active_machines is None \
            else max(1, min(int(active_machines), num_machines))
        cap = p_capacity or max(4 * num_machines, 64)
        parts = PartitionTable.with_capacity(cap)
        root = parts.allocate(0, 0, grid_size - 1, grid_size - 1, owner=0)
        live = [root]
        while len(live) < active:
            areas = [geometry.box_area(parts.r0[p], parts.c0[p], parts.r1[p], parts.c1[p])
                     for p in live]
            tgt = live[int(np.argmax(areas))]
            r0, c0, r1, c1 = (int(parts.r0[tgt]), int(parts.c0[tgt]),
                              int(parts.r1[tgt]), int(parts.c1[tgt]))
            if r1 == r0 and c1 == c0:  # cell-sized: cannot split further
                break
            if (r1 - r0) >= (c1 - c0):  # split the longer side
                mid = (r0 + r1) // 2
                a = parts.allocate(r0, c0, mid, c1, owner=-1, parent=tgt)
                b = parts.allocate(mid + 1, c0, r1, c1, owner=-1, parent=tgt)
            else:
                mid = (c0 + c1) // 2
                a = parts.allocate(r0, c0, r1, mid, owner=-1, parent=tgt)
                b = parts.allocate(r0, mid + 1, r1, c1, owner=-1, parent=tgt)
            parts.retire(tgt)
            live.remove(tgt)
            live += [a, b]
        for m, pid in enumerate(sorted(live)):
            parts.owner[pid] = m % active
        grid = np.full((grid_size, grid_size), NO_PARTITION, np.int32)
        for pid in live:
            grid[parts.r0[pid]:parts.r1[pid] + 1, parts.c0[pid]:parts.c1[pid] + 1] = pid
        return cls(grid_size, grid, parts)

    # ------------------------------------------------------------------
    # Routing
    # ------------------------------------------------------------------
    def route_points(self, row, col):
        """Vectorized O(1) point routing: (pids, owners)."""
        pids = self.cell_to_partition[row, col]
        return pids, self.parts.owner[pids]

    def query_overlap_vectorized(self, r0: int, c0: int, r1: int, c1: int) -> np.ndarray:
        """All live partitions overlapping the query box — branch-free
        overlap test against the partition table (TPU-native variant)."""
        p = self.parts
        live = p.alive[: p.n_alloc]
        hit = live & geometry.boxes_overlap(
            p.r0[: p.n_alloc], p.c0[: p.n_alloc], p.r1[: p.n_alloc], p.c1[: p.n_alloc],
            r0, c0, r1, c1)
        return np.nonzero(hit)[0]

    def query_overlap(self, r0: int, c0: int, r1: int, c1: int) -> list[int]:
        """Algorithm 1: partition-skipping stack walk (faithful)."""
        result: list[int] = []
        seen: set[int] = set()
        # Paper's (left, top) corner: the row of the query's top edge and
        # the col of its left edge; the "right-of-border"/"below-border"
        # pushes cover the whole box while skipping interior cells.
        stack = [(r0, c0)]
        g = self.grid_size
        while stack:
            cr, cc = stack.pop()
            if cr < r0 or cr > r1 or cc < c0 or cc > c1 or cr >= g or cc >= g:
                continue
            pid = int(self.cell_to_partition[cr, cc])
            if pid == NO_PARTITION or pid in seen:
                continue
            seen.add(pid)
            result.append(pid)
            # cell after the partition's right border, same row
            stack.append((cr, int(self.parts.c1[pid]) + 1))
            # cell below the partition's bottom border, same column
            stack.append((int(self.parts.r1[pid]) + 1, cc))
        return result

    # ------------------------------------------------------------------
    # Plan installation (latch-free: build a fresh grid, swap reference)
    # ------------------------------------------------------------------
    def apply_changes(self, changed_pids) -> None:
        """Repaint grid cells for the given (new) partitions.  Readers of
        the previous ``cell_to_partition`` array keep a consistent view —
        the functional analogue of the paper's latch-free update."""
        grid = self.cell_to_partition.copy()
        p = self.parts
        for pid in changed_pids:
            grid[p.r0[pid]:p.r1[pid] + 1, p.c0[pid]:p.c1[pid] + 1] = pid
        self.cell_to_partition = grid

    def machine_partitions(self, m: int) -> np.ndarray:
        p = self.parts
        ids = p.live_ids()
        return ids[p.owner[ids] == m]
