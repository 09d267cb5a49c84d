"""One run of one cell: set-up, the timed window, the traced readings and
the comparison with the plain reference, as one result line.

Set-up, in order: load the kernels from the build cache; generate one
whole traffic cycle from the seed; preload the standing queries; run the
first cycle through the engine (which registers any query burst and
warms every shape the cell's rounds use).  The window then drives the
engine one SWARM round at a time, back to back (a closed loop), for the
given seconds; every card of the cell is synchronised at both of its
ends.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROFILE_S = 8.0          # profile whole cycles until this much has passed
CHECK_ROUNDS = 6         # rounds of the window held against the reference


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    system: dict          # the configuration's system block, cell overrides applied
    workload: dict        # the cell's workload file
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix
    and workload files, found by name."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def read(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    config = read(ROOT, conf["file"])
    traffic = read(HERE, "traffic", f"{w['traffic']}.json")
    if "same_as" in traffic:       # one stream under a second name
        traffic = read(HERE, "traffic", f"{traffic['same_as']}.json")
    spec = read(HERE, "workloads", f"{name}.json")
    system = {**config["system"], **spec.get("system", {})}

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name, int(w["chips"]), config, traffic, system, spec,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _sync(cards: tuple) -> None:
    if cards:
        import torch
        for k in cards:
            torch.cuda.synchronize(k)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             stash: dict | None = None) -> dict:
    """One run; returns the result line's object, ``checks`` last.
    ``stash``, when given, receives the captured rounds and the traffic
    (for the control runs)."""
    import torch

    import system as S
    from check import evaluate, verdict
    from traffic import stream
    t_start = time.perf_counter() if t_start is None else t_start
    sysp = cell.system
    if device != "cpu":
        from repro_torch.kernels import stats_update
        t0 = time.perf_counter()
        stats_update.ops.build()
        _log(f"kernels loaded in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    traffic = stream.generate(cell.traffic, sysp, seed)
    _log(f"traffic: {traffic.cycle} ticks x {traffic.points.shape[1]} "
         f"tuples, {len(traffic.queries)} standing queries, "
         f"{sum(len(r) for r, _ in traffic.burst.values())} in bursts, "
         f"generated in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    eng = S.build(sysp, traffic, device, traced, cell.chips)
    cards = S.cards(eng)
    _log(f"preload in {time.perf_counter() - t0:.3f} s")
    re = int(sysp["round_every"])
    t0 = time.perf_counter()
    eng.run(S.warmup_ticks(traffic.cycle, re))
    _sync(cards)
    _log(f"warm-up cycle in {time.perf_counter() - t0:.3f} s")
    prof = None
    if traced:
        from readings import Profiler
        prof = Profiler(eng.tracer, cards)
        prof.start()                  # the profiler's own first-use cost
        eng.run(re)
        prof.stop()
        prof = Profiler(eng.tracer, cards)
        eng.tracer.events.clear()
        _span_reindex(eng)
    rounds_per_cycle = max(traffic.cycle // re, 1)
    pick = Sampler(seed, rounds_per_cycle)
    cap = S.RoundCapture(eng)
    times, live, k = [], [], 0
    tick0 = eng.tick_no
    setup_s = time.perf_counter() - t_start
    _sync(cards)
    w0 = time.perf_counter()
    if prof is not None:
        prof.start()
    profiling = prof is not None
    while True:
        take = pick.take(k)
        if take:
            cap.begin()
        t0 = time.perf_counter()
        eng.run(re)
        t1 = time.perf_counter()
        if take:
            cap.end()
            pick.keep(k, cap.rounds.pop())
        times.append(t1 - t0)
        k += 1
        if k % rounds_per_cycle == 0:
            live.append(len(eng.router.index.parts.live_ids()))
            if profiling and t1 - w0 >= min(PROFILE_S, seconds / 2):
                prof.stop()
                profiling = False
        if t1 - w0 >= seconds and k >= rounds_per_cycle:
            break
    if profiling:
        prof.stop()
    _sync(cards)
    window_s = time.perf_counter() - w0
    ticks = eng.tick_no - tick0
    injected = int(np.sum(eng.metrics.injected[tick0:]))
    peak = max((torch.cuda.max_memory_allocated(k) for k in cards), default=0)
    _log(f"window: {k} rounds, {ticks} ticks, {injected} tuples injected "
         f"in {window_s:.3f} s")
    per_cycle = [1e3 * float(np.mean(times[i:i + rounds_per_cycle]))
                 for i in range(0, k - rounds_per_cycle + 1, rounds_per_cycle)]
    _log(f"round ms by cycle: {[round(x, 1) for x in per_cycle]}")
    _log(f"live partitions by cycle: {live}, at the close "
         f"{len(eng.router.index.parts.live_ids())}")
    _declined(eng, traced, traffic.cycle)
    _rebalances(eng, tick0, traffic.cycle)

    metrics = {}
    if not traced:
        vals = {"tuples_per_s": injected / window_s,
                "round_p95_ms": 1e3 * float(np.percentile(times, 95)),
                "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    breakdown = None
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name() if device != "cpu"
                    else "cpu"),
           "count": max(len(cards), 1), "memory_peak_bytes": int(peak)}
    if traced:
        from readings import Trace
        tr = Trace([e for e in eng.tracer.events if e.kind == "span"],
                   int(sysp["grid"]))
        prof.reduce(tr)
        for m in cell.per_layer:
            mod = importlib.import_module(f"metrics.{m['name']}")
            v = mod.read(tr)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}

    rounds = pick.chosen()
    _log(f"rounds checked: {[r['k'] for r in rounds]} of {k}")
    if stash is not None:
        stash.update(rounds=rounds, traffic=traffic)
    del eng, cap
    if device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums = evaluate(rounds, traffic, sysp)
    ok, checks = verdict(nums, len(rounds))
    _log(f"reference over {len(rounds)} rounds in "
         f"{time.perf_counter() - t0:.3f} s")
    out = {"correct": ok, "attempted": k, "failed": 0, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


class Sampler:
    """Which rounds of the window are held against the reference: spread
    over the whole window, wherever it ends, with at most
    ``2 * CHECK_ROUNDS + 1`` captured at a time.

    One round is captured in each block of ``stride`` rounds, at a place
    drawn from the seed; when the captures pass ``2 * CHECK_ROUNDS`` the
    stride doubles and one capture of each merged pair is kept.  Besides,
    one round of each replay cycle is captured and kept until the next
    cycle's, so that the last cycle reached is always among them.  After
    the window, the last cycle's round and ``CHECK_ROUNDS - 1`` of the
    others, drawn from the seed, are checked."""

    def __init__(self, seed: int, per_cycle: int):
        self.rng = np.random.default_rng([int(seed), 1])
        self.per_cycle = per_cycle
        self.stride, self.block, self.slot = 1, -1, -1
        self.cycle_slot = -1
        self.spread: dict[int, dict] = {}      # block → captured round
        self.latest: dict | None = None

    def take(self, k: int) -> bool:
        if k % self.per_cycle == 0:
            self.cycle_slot = k + int(self.rng.integers(self.per_cycle))
        b = k // self.stride
        if b != self.block:
            self.block = b
            self.slot = b * self.stride + int(self.rng.integers(self.stride))
        return k in (self.slot, self.cycle_slot)

    def keep(self, k: int, rec: dict) -> None:
        rec["k"] = k
        if k == self.cycle_slot:
            self.latest = rec
        if k == self.slot:
            self.spread[k // self.stride] = rec
        if len(self.spread) > 2 * CHECK_ROUNDS:
            self.stride *= 2
            merged: dict[int, list] = {}
            for b, r in sorted(self.spread.items()):
                merged.setdefault(b // 2, []).append(r)
            self.spread = {b: rs[int(self.rng.integers(len(rs)))]
                           for b, rs in merged.items()}
            self.block, self.slot = k // self.stride, -1

    def chosen(self) -> list[dict]:
        last = [self.latest] if self.latest is not None else []
        rest = [r for r in self.spread.values() if r is not self.latest]
        n = min(CHECK_ROUNDS - len(last), len(rest))
        pick = self.rng.choice(len(rest), size=n, replace=False)
        return sorted(last + [rest[i] for i in pick.tolist()],
                      key=lambda r: r["k"])


def _declined(eng, traced: bool, cycle: int) -> None:
    """Windows the engine declined in the window, by tick of the cycle
    (traced runs only: the tracer records each window's ``ok``)."""
    if not traced:
        return
    win = [e for e in eng.tracer.events
           if e.kind == "span" and e.name == "fused_window"]
    bad = sorted({e.tick % cycle for e in win if e.args.get("ok") is False})
    _log(f"fused windows: {len(win)}, declined "
         f"{sum(e.args.get('ok') is False for e in win)}, at cycle ticks "
         f"{bad}")


def _span_reindex(eng) -> None:
    """A span around the router's re-indexing of the standing queries
    after a plan change (``reindex_all_queries``), which runs outside the
    program's own spans (traced runs only)."""
    router, tr = eng.router, eng.tracer
    real = router.reindex_all_queries

    def reindex_all_queries():
        with tr.span("reindex_queries", queries=router.q_total):
            real()

    router.reindex_all_queries = reindex_all_queries


def _rebalances(eng, tick0: int, cycle: int) -> None:
    """The window's plan changes: rounds that moved partitions, and the
    queries they moved (64 bytes each), by tick of the cycle."""
    mt = eng.metrics
    tr = np.asarray(mt.transfers[tick0:])
    moved = np.asarray(mt.migration_bytes[tick0:]) // 64
    inj = np.asarray(mt.injected[tick0:])
    at = sorted({(tick0 + i) % cycle for i in np.nonzero(tr)[0].tolist()})
    _log(f"plan changes: {int((tr > 0).sum())} ticks with transfers, "
         f"{int(tr.sum())} transfers, {int(moved.sum())} queries moved; "
         f"at cycle ticks {at}; injected a tick min {int(inj.min())} "
         f"max {int(inj.max())}")
