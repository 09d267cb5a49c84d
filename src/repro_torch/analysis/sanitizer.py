"""Runtime protocol sanitizer — ASAN-style conservation-law checks.

The paper's §5 integrity guarantee ("no objects get lost or processed
twice") and the parity pins shipped since PR 2 are conservation laws:

* **queue conservation** — per tick, queued tuples change by exactly
  (injected − processed); nothing leaks between machines.
* **disjoint cover** — the live partitions' boxes tile the G×G grid
  exactly: every cell painted with a live partition, every live
  partition painting exactly its box area, owners in range.
* **aggregation consistency** — per-machine resident-query totals equal
  the sum of their partitions' ``qres`` (no query lost or counted twice
  across the partition→machine aggregation).
* **collector deposits == drains** — the N′ device collector banks
  drain exactly as many tuple deposits as the plane accepted since the
  last reset (row and column channels agree with each other and with
  the deposit count).
* **billed bytes == resharded bytes** — the sharded plane's physical
  cross-device reshard moves exactly the bytes the planner billed.

Enable with ``EngineConfig(sanitize=True)`` or ``REPRO_SANITIZE=1``
(the env var keeps experiment labels unchanged).  Violations raise
:class:`SanitizerError` at the offending tick — fail fast, like ASAN —
and ``ProtocolSanitizer.stats`` counts how many of each law were
checked, so a "silent" run provably exercised them.
"""
from __future__ import annotations

import numpy as np


class SanitizerError(AssertionError):
    """A streaming-protocol conservation law was violated."""


class SanitizingPlane:
    """Delegating :class:`~repro.streaming.planes.DataPlane` wrapper that
    counts tuple deposits into the N′ collector banks and validates the
    drain / reshard laws.  Every other attribute and method passes
    through, so any plane (numpy / jax / sharded) runs unchanged."""

    def __init__(self, inner, sanitizer: "ProtocolSanitizer"):
        self._inner = inner
        self._san = sanitizer
        self._deposited = 0.0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- deposit accounting --------------------------------------------
    def make_state(self, host):
        self._deposited = 0.0
        return self._inner.make_state(host)

    def step(self, state, cp, xy, track_stats=False, query_batch=None,
             kw=None):
        out = self._inner.step(state, cp, xy, track_stats=track_stats,
                               query_batch=query_batch, kw=kw)
        if track_stats:
            self._deposited += len(xy)
        return out

    def run_window(self, state, cp, fp, carry, xy_stack, kw_stack=None,
                   cells=None):
        state, carry, outs, ok = self._inner.run_window(
            state, cp, fp, carry, xy_stack, kw_stack=kw_stack, cells=cells)
        if ok and fp.track_stats:
            # a declined window (ok=False) is discarded by the engine
            # and replayed host-side — its deposits never commit
            self._deposited += float(np.asarray(outs.injected).sum())
        return state, carry, outs, ok

    # -- law checks at the drain / reshard boundaries ------------------
    def collector_banks(self, state):
        cnr, cnc = self._inner.collector_banks(state)
        self._san.check_collectors(cnr, cnc, self._deposited)
        return cnr, cnc

    def reset_collectors(self, state):
        self._deposited = 0.0
        return self._inner.reset_collectors(state)

    def reshard_transfers(self, state, outcome, router) -> int:
        moved = self._inner.reshard_transfers(state, outcome, router)
        self._san.check_reshard(
            moved, outcome, sharded=getattr(self._inner, "name", "")
            == "sharded")
        return moved


class ProtocolSanitizer:
    """Engine-side conservation checks; one instance per engine run."""

    def __init__(self):
        self.stats = {"ticks": 0, "rounds": 0, "covers": 0,
                      "collector_drains": 0, "reshards": 0}

    def wrap_plane(self, plane) -> SanitizingPlane:
        if isinstance(plane, SanitizingPlane):
            return plane
        return SanitizingPlane(plane, self)

    def _fail(self, law: str, detail: str):
        raise SanitizerError(f"[{law}] {detail}")

    # -- per-tick -------------------------------------------------------
    def check_tick(self, engine, qt_before: float, injected: int,
                   processed: float) -> None:
        """Queue conservation: tuples queued after the tick equal the
        pre-injection backlog plus the injected batch minus the
        processed count; queues never go negative."""
        self.stats["ticks"] += 1
        qt = engine.queue_tuples
        if (qt < -1e-6).any():
            worst = int(np.argmin(qt))
            self._fail("queue-nonneg",
                       f"machine {worst} has {qt[worst]:.6f} queued "
                       f"tuples at tick {engine.tick_no}")
        expect = qt_before + injected - processed
        got = float(qt.sum())
        tol = 1e-6 * max(abs(expect), 1.0)
        if abs(got - expect) > tol:
            self._fail("tuple-conservation",
                       f"tick {engine.tick_no}: queued tuples {got:.6f} "
                       f"!= backlog {qt_before:.6f} + injected "
                       f"{injected} - processed {processed:.6f} "
                       f"(leak of {got - expect:+.6f})")

    # -- per-round ------------------------------------------------------
    def check_round(self, engine, outcome) -> None:
        self.stats["rounds"] += 1
        if outcome is not None:
            if int(outcome.migration_bytes) < 0:
                self._fail("billing", f"negative migration_bytes "
                           f"{outcome.migration_bytes}")
            if outcome.moved_by_transfer and len(
                    outcome.moved_by_transfer) != len(outcome.transfers):
                self._fail("billing",
                           f"{len(outcome.moved_by_transfer)} per-transfer "
                           f"moved counts for {len(outcome.transfers)} "
                           "transfers")
        index = getattr(engine.router, "index", None)
        if index is not None and hasattr(index, "cell_to_partition"):
            self.check_cover(index, num_machines=len(engine.alive),
                             tick=engine.tick_no)
        fh = getattr(engine.router, "fused_host_state", None)
        if fh is not None:
            self.check_aggregation(fh(), tick=engine.tick_no)

    def check_cover(self, index, num_machines: int, tick: int) -> None:
        """Live partitions tile the grid disjointly and completely."""
        self.stats["covers"] += 1
        grid = index.cell_to_partition
        parts = index.parts
        g = grid.shape[0]
        if (grid < 0).any():
            n = int((grid < 0).sum())
            self._fail("disjoint-cover",
                       f"tick {tick}: {n} grid cells map to no partition")
        counts = np.bincount(grid.ravel(), minlength=parts.n_alloc)
        live = parts.live_ids()
        painted = set(np.nonzero(counts)[0])
        if painted - set(live.tolist()):
            dead = sorted(painted - set(live.tolist()))[:4]
            self._fail("disjoint-cover",
                       f"tick {tick}: grid cells map to non-live "
                       f"partitions {dead}")
        for pid in live:
            area = ((int(parts.r1[pid]) - int(parts.r0[pid]) + 1)
                    * (int(parts.c1[pid]) - int(parts.c0[pid]) + 1))
            if counts[pid] != area:
                self._fail(
                    "disjoint-cover",
                    f"tick {tick}: partition {int(pid)} paints "
                    f"{int(counts[pid])} cells but its box covers "
                    f"{area} — boxes overlap or leave holes")
        if int(counts[live].sum()) != g * g:
            self._fail("disjoint-cover",
                       f"tick {tick}: live partitions paint "
                       f"{int(counts[live].sum())} of {g * g} cells")
        owners = parts.owner[live]
        if len(live) and ((owners < 0) | (owners >= num_machines)).any():
            self._fail("disjoint-cover",
                       f"tick {tick}: live partition owner out of range "
                       f"[0, {num_machines})")

    def check_aggregation(self, host, tick: int) -> None:
        """q_machine must be exactly the owner-scatter of qres — no
        resident query lost or double-counted in the aggregation."""
        qres = np.asarray(host.qres, np.float64)
        owner = np.asarray(host.owner)
        m = len(host.q_machine)
        valid = (owner >= 0) & (owner < m)
        expect = np.bincount(owner[valid], weights=qres[valid],
                             minlength=m)
        got = np.asarray(host.q_machine, np.float64)
        if not np.allclose(got, expect, atol=0.5):
            worst = int(np.argmax(np.abs(got - expect)))
            self._fail("aggregation",
                       f"tick {tick}: q_machine[{worst}]={got[worst]} "
                       f"but its partitions' qres sum to "
                       f"{expect[worst]}")

    # -- plane boundaries ----------------------------------------------
    def check_collectors(self, cn_rows, cn_cols, deposited: float) -> None:
        self.stats["collector_drains"] += 1
        rows = float(np.asarray(cn_rows, np.float64).sum())
        cols = float(np.asarray(cn_cols, np.float64).sum())
        tol = max(0.5, 1e-6 * max(deposited, 1.0))
        if abs(rows - cols) > tol:
            self._fail("collector-drain",
                       f"N' row bank sums to {rows} but column bank to "
                       f"{cols} — a tuple deposited into one channel "
                       "only")
        if abs(rows - deposited) > tol:
            self._fail("collector-drain",
                       f"collector banks drain {rows} deposits but the "
                       f"plane accepted {deposited} tuples since the "
                       "last reset")

    def check_reshard(self, moved: int, outcome, sharded: bool) -> None:
        self.stats["reshards"] += 1
        billed = int(outcome.migration_bytes)
        if sharded:
            if int(moved) != billed:
                self._fail("reshard-billing",
                           f"sharded plane moved {moved} bytes but the "
                           f"planner billed {billed}")
        elif int(moved) != 0:
            self._fail("reshard-billing",
                       f"single-device plane reported {moved} moved "
                       "bytes — the plan patch is the whole move")
