"""The system under test, built from a configuration file's ``system``
block: SWARM's router over the data plane of the cell's ``chips``
(``TorchPlane`` on one device, or ``ShardedTorchPlane`` over several
cards), the streaming engine fed by the benchmark's replay source, and
the standing queries preloaded.  Also the capture of what a sampled
round produced, for the comparison with the plain reference once the
window has closed."""
from __future__ import annotations

import numpy as np

from replay import ReplaySource


def data_plane(chips: int, device: str):
    """The cell's data plane: ``TorchPlane`` on one device for one chip;
    for more, ``ShardedTorchPlane``, SWARM's machine axis over ``chips``
    shards, one to a card on ``cuda`` (never colocated) and all on the
    host on ``cpu``."""
    from repro_torch.streaming import ShardedTorchPlane, TorchPlane
    if chips > 1:
        return ShardedTorchPlane(chips, device)
    return TorchPlane(device)


def cards(eng) -> tuple:
    """The CUDA device indices the engine's data plane runs on, in the
    order its shards first name them; none on the host."""
    import torch
    plane = eng.router.swarm.plane
    devs = getattr(plane, "shards", (plane.device,))
    return tuple(dict.fromkeys(
        torch.cuda.current_device() if d.index is None else d.index
        for d in devs if d.type == "cuda"))


def build(sysp: dict, traffic, device: str, traced: bool, chips: int):
    """The engine of one cell on its ``chips`` cards, with its standing
    queries registered."""
    from repro_torch.streaming import (EngineConfig, QueryBatch, QueryModel,
                                       StreamingEngine, SwarmRouter,
                                       TelemetryConfig, WorkloadSpec)
    if sysp["query_model"] == "spatial_keyword":
        wl = WorkloadSpec(query_model=QueryModel.SPATIAL_KEYWORD,
                          term_buckets=int(sysp["term_buckets"]),
                          tuple_terms=int(sysp["tuple_terms"]),
                          sub_terms=int(sysp["sub_terms"]),
                          delivery_cost=float(sysp["delivery_cost"]),
                          delivery_bytes=int(sysp["delivery_bytes"]))
    else:
        wl = WorkloadSpec(query_model=QueryModel.RANGE)
    cost = sysp["cost"]
    router = SwarmRouter(
        int(sysp["grid"]), int(sysp["machines"]), beta=int(sysp["beta"]),
        decay=float(sysp["decay"]), workload=wl,
        data_plane=data_plane(chips, device),
        query_area=float(sysp["query_side"]) ** 2, c0=float(cost["c0"]),
        kappa_probe=float(cost["kappa_probe"]),
        kappa_match=float(cost["kappa_match"]),
        q_cache=float(cost["q_cache"]))
    cfg = EngineConfig(
        num_machines=int(sysp["machines"]),
        cap_units=float(sysp["cap_units"]),
        lambda_max=float(sysp["lambda_max"]),
        mem_queries=int(sysp["mem_queries"]),
        mem_tuples=float(sysp["mem_tuples"]),
        bp_high=float(sysp["bp_high"]), bp_dec=float(sysp["bp_dec"]),
        bp_inc=float(sysp["bp_inc"]),
        round_every=int(sysp["round_every"]),
        migration_unit_cost=float(sysp["migration_unit_cost"]),
        fused_window=int(sysp["fused_window"]),
        telemetry=TelemetryConfig(tick_spans=False) if traced else None)
    eng = StreamingEngine(router, ReplaySource(traffic), cfg)
    router.ingest(QueryBatch(traffic.queries, 0, traffic.query_terms))
    return eng


def warmup_ticks(cycle: int, round_every: int) -> int:
    """Ticks of set-up: the whole first cycle (which registers any query
    burst), then up to the first tick of a round, so that each call of
    ``run(round_every)`` in the window is exactly one SWARM round."""
    return cycle + (1 - cycle) % round_every if round_every > 1 else cycle


def _plan(router) -> dict:
    p = router.index.parts
    n = p.n_alloc
    return {"grid": router.index.cell_to_partition.copy(),
            "boxes": np.stack([p.r0[:n], p.c0[:n], p.r1[:n], p.c1[:n]],
                              1).astype(np.int64),
            "owner": p.owner[:n].astype(np.int64),
            "live": p.live_ids().astype(np.int64)}


def _fsm(router) -> dict:
    d = router.swarm.decision
    return {"stage": int(d.stage), "decision": int(d.decision),
            "same_count": int(d.same_count), "pre_rs": float(d.pre_rs)}


class RoundCapture:
    """What a sampled round of the window produced: the plan, decision
    state and queue state it started from, its per-tick outputs, the
    statistics banks as the round close found them and as it left them,
    and the plan, decision state, transfers and migration bytes after.

    The round close is read by wrapping the data plane's ``close_round``
    for that round only."""

    def __init__(self, eng):
        self.eng = eng
        self.rounds: list[dict] = []

    def begin(self) -> None:
        eng, router = self.eng, self.eng.router
        rec = {"tick": eng.tick_no, "start": _plan(router),
               "queue_units": eng.queue_units.copy(),
               "queue_tuples": eng.queue_tuples.copy(),
               "lam": float(eng.lam_bp),
               "qres": router.qres[:router.index.parts.n_alloc].copy(),
               "qres_kw": (None if router.qres_kw is None else
                           router.qres_kw[:router.index.parts.n_alloc]
                           .copy()),
               "fsm": _fsm(router), "closes": []}
        plane = router.swarm.plane
        real = plane.close_round

        def close_round(stats, decay, live):
            live = np.asarray(live)
            entry = (stats.rows[:, live].copy(), stats.cols[:, live].copy())
            real(stats, decay, live)
            rec["closes"].append({
                "live": live.copy(), "decay": float(decay), "entry": entry,
                "exit": (stats.rows[:, live].copy(),
                         stats.cols[:, live].copy())})

        plane.close_round = close_round
        self.rounds.append(rec)

    def end(self) -> None:
        eng, router = self.eng, self.eng.router
        del router.swarm.plane.close_round
        rec = self.rounds[-1]
        t0, t1 = rec["tick"], eng.tick_no
        mt = eng.metrics
        rec["ticks"] = t1 - t0
        rec["out"] = {
            "injected": np.asarray(mt.injected[t0:t1], np.int64),
            "throughput": np.asarray(mt.throughput[t0:t1], np.float64),
            "latency": np.asarray(mt.latency[t0:t1], np.float64),
            "utilization": np.asarray(mt.utilization[t0:t1], np.float64),
            "deliveries": np.asarray(mt.deliveries[t0:t1], np.float64)}
        rec["end"] = _plan(router)
        rec["fsm_end"] = _fsm(router)
        rec["transfers"] = int(np.sum(mt.transfers[t0:t1]))
        rec["migration_bytes"] = int(np.sum(mt.migration_bytes[t0:t1]))
