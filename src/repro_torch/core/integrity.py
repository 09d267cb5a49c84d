"""System-integrity mechanics (paper §5).

Partitions move *without their data*: the moved partition records its
``parent`` partition id and ``prev_machine``; historical queries walk
this chain until data expires, at which point the chain is broken.  The
ledger here is also used by the tests to assert the exactly-once
guarantee (§5.1: "no objects get lost or processed twice").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .global_index import PartitionTable


def partition_chain(parts: PartitionTable, pid: int, max_len: int = 64) -> list[int]:
    """Walk the parent chain starting at (and excluding) ``pid``.

    Returns the parent pids, oldest last — the machines to consult for
    historical data (§5.2 example: p3 → p1 on m1)."""
    chain: list[int] = []
    cur = int(parts.parent[pid])
    while cur >= 0 and len(chain) < max_len:
        chain.append(cur)
        cur = int(parts.parent[cur])
    return chain


def expire_chains(parts: PartitionTable, current_round: int, window_rounds: int) -> int:
    """Break chains whose parents' data has expired.

    A retired partition's data expires ``window_rounds`` after it was
    replaced (its children's birth_round).  Children then clear their
    parent pointer ("the previous involved machine ... breaks the
    chain").  Returns the number of links broken."""
    broken = 0
    for pid in range(parts.n_alloc):
        par = int(parts.parent[pid])
        if par < 0:
            continue
        # the parent was superseded when this child was born
        if current_round - int(parts.birth_round[pid]) >= window_rounds:
            parts.parent[pid] = -1
            parts.prev_machine[pid] = -1
            broken += 1
    return broken


@dataclass
class ProcessingLedger:
    """Exactly-once accounting used by the integrity tests: every tuple id
    must be processed exactly once across all machines, even while
    partitions migrate mid-stream."""

    processed: dict[int, int] = field(default_factory=dict)  # tuple id → machine
    duplicates: list[tuple[int, int, int]] = field(default_factory=list)

    def record(self, tuple_ids: np.ndarray, machine: int) -> None:
        for t in np.asarray(tuple_ids).ravel():
            t = int(t)
            if t in self.processed:
                self.duplicates.append((t, self.processed[t], machine))
            else:
                self.processed[t] = machine

    def assert_exactly_once(self, expected_ids) -> None:
        missing = [int(t) for t in expected_ids if int(t) not in self.processed]
        if missing or self.duplicates:
            raise AssertionError(
                f"integrity violated: {len(missing)} lost, "
                f"{len(self.duplicates)} duplicated")
