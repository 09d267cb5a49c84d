"""Partition-resident tuple storage (the data-persistence half of the
queries subsystem).

``TupleStore`` keeps one resident-tuple count per partition id, sharing
the partition-table id space of ``core.global_index``.  It is the state
behind both persistence models:

* STORED    — ``retention=1.0``: deposits accumulate; counts feed the
  cost model's resident-data term and the engine's memory check, and
  ``migrate``/``split`` return how many tuples a plan change shipped
  (billed as migration bytes, §5.2 chain-forwarding).
* EPHEMERAL — ``retention<1``: counts decay each tick, so snapshot
  probes see only a sliding window of recent tuples and nothing is
  durable enough to bill on migration.

Counts are float64 so retention decay composes exactly with deposits;
readers quantize where integers matter.
"""
from __future__ import annotations

import numpy as np


class TupleStore:
    def __init__(self, capacity: int, *, bytes_per_tuple: int = 24,
                 retention: float = 1.0):
        self.counts = np.zeros(int(capacity), np.float64)
        self.bytes_per_tuple = int(bytes_per_tuple)
        self.retention = float(retention)

    # -- capacity ----------------------------------------------------------
    def ensure(self, capacity: int) -> None:
        """Grow alongside the partition table."""
        if len(self.counts) < capacity:
            self.counts = np.concatenate(
                [self.counts, np.zeros(capacity - len(self.counts))])

    # -- writes ------------------------------------------------------------
    def deposit(self, pids: np.ndarray, capacity: int | None = None) -> None:
        if capacity is not None:
            self.ensure(capacity)
        np.add.at(self.counts, pids, 1.0)

    def expire(self) -> None:
        """One tick of retention decay (no-op for STORED)."""
        if self.retention < 1.0:
            self.counts *= self.retention
            np.putmask(self.counts, self.counts < 0.5, 0.0)

    def migrate(self, old_pid: int, new_pid: int) -> int:
        """Move a retired partition's tuples to its successor id.
        Returns the number of tuples shipped."""
        self.ensure(new_pid + 1)
        moved = self.counts[old_pid]
        self.counts[new_pid] += moved
        self.counts[old_pid] = 0.0
        return int(round(moved))

    def split(self, old_pid: int, lo_pid: int, hi_pid: int,
              frac_lo: float) -> int:
        """Split a partition's tuples by area fraction (the store keeps
        counts, not coordinates; area-proportional is the §4.2 uniform
        within-partition assumption).  Returns tuples that changed
        machine — the caller knows which side moved."""
        self.ensure(max(lo_pid, hi_pid) + 1)
        total = self.counts[old_pid]
        lo = total * float(np.clip(frac_lo, 0.0, 1.0))
        self.counts[lo_pid] += lo
        self.counts[hi_pid] += total - lo
        self.counts[old_pid] = 0.0
        return int(round(total))

    # -- reads -------------------------------------------------------------
    def total(self) -> float:
        return float(self.counts.sum())

    def by_machine(self, parts, num_machines: int) -> np.ndarray:
        """Resident tuples per machine, summed over live partitions."""
        live = parts.live_ids()
        out = np.zeros(num_machines, np.float64)
        self.ensure(parts.capacity)
        np.add.at(out, parts.owner[live], self.counts[live])
        return out
