"""Live-system checkpointing: snapshot/restore a running experiment.

``save_stream`` captures everything a :class:`~repro.streaming.engine.
StreamingEngine` + SWARM router pair needs to resume *exactly* where it
stopped — the global index (partition table + cell map), the statistics
banks (collectors ride inside them), the Fig-9 FSM, per-machine queues
and backpressure, the heartbeat table (including the adaptive
detector's learned gap windows and the sticky leader), the geo fault
state (pending link-delayed beats, in-flight transfer payloads, open
partitions, suspicions) and the source's RNG state.  A restored run's
metric rows are bit-identical to the continuous run's — the parity
test pins this on every data plane.

Layout mirrors ``checkpoint.checkpoint``: ``<dir>/step_<tick>/
{arrays.npz, manifest.json, COMMITTED}`` with the atomic COMMITTED
marker, so half-written snapshots are never restored.  Device-resident
fused state is *not* stored: collectors are drained to the host banks
before capture and the device mirror is rebuilt lazily on resume.
"""
from __future__ import annotations

import json
import os

import numpy as np

_PART_FIELDS = ("r0", "c0", "r1", "c1", "owner", "alive", "parent",
                "prev_machine", "birth_round")
_ENGINE_ARRAYS = ("queue_units", "queue_tuples", "alive", "cap_factor")
_FLIGHT_FIELDS = ("m_h", "m_l", "round_no", "moved_queries", "bytes",
                  "tuples", "sent", "arrive", "attempts")


def _swarm_of(router):
    sw = getattr(router, "swarm", None)
    if sw is None:
        raise TypeError(
            f"{type(router).__name__} is not checkpointable: live "
            "snapshots support SWARM routers (the protocol holds the "
            "mutable cluster state)")
    return sw


def save_stream(directory: str, engine, *, extra: dict | None = None) -> str:
    """Snapshot ``engine`` (and its SWARM router) at the current tick.
    Returns the checkpoint path; the tick number is the step."""
    from .checkpoint import save as _save  # same layout/markers

    router = engine.router
    sw = _swarm_of(router)
    # drain device-held collector deltas so the host banks are complete
    engine._fused_sync_collectors()

    arrays = {
        "index/cell_to_partition": sw.index.cell_to_partition,
        "stats/rows": sw.stats.rows,
        "stats/cols": sw.stats.cols,
        "swarm/cap_factor": sw.cap_factor,
        "router/qres": router.qres,
        "router/query_rects": router.query_rects,
        "engine/_acc": engine._acc,
    }
    for f in _PART_FIELDS:
        arrays[f"parts/{f}"] = getattr(sw.index.parts, f)
    for f in _ENGINE_ARRAYS:
        arrays[f"engine/{f}"] = getattr(engine, f)
    if getattr(router, "qres_kw", None) is not None:
        arrays["router/qres_kw"] = router.qres_kw
    if getattr(router, "sub_pivots", None) is not None:
        arrays["router/sub_pivots"] = router.sub_pivots
    store = getattr(router, "store", None)
    if store is not None:
        arrays["store/counts"] = store.counts

    coord = engine.coord
    state = {
        "tick_no": int(engine.tick_no),
        "lam_bp": float(engine.lam_bp),
        "coordinator": int(engine._coordinator),
        "was_infeasible": bool(engine.metrics.was_infeasible),
        "pending_detect": {str(k): int(v)
                           for k, v in engine._pending_detect.items()},
        "pending_beats": {str(k): [int(m) for m in v]
                          for k, v in engine._pending_beats.items()},
        "partitioned": {str(k): int(v)
                        for k, v in engine._partitioned.items()},
        "suspected": sorted(int(m) for m in engine._suspected),
        "in_flight": [{f: int(getattr(fl, f)) for f in _FLIGHT_FIELDS}
                      for fl in engine._in_flight],
        "transfer_stats": dict(engine.transfer_stats),
        "coord": {
            "clock": int(coord.clock),
            "leader": int(coord.leader),
            "last_beat": {str(k): int(v)
                          for k, v in coord.last_beat.items()},
            "gaps": {str(k): [int(g) for g in v]
                     for k, v in coord._gaps.items()},
        },
        "swarm": {
            "round_no": int(sw.round_no),
            "dead": sorted(int(m) for m in sw.dead),
            "standby": sorted(int(m) for m in sw.standby),
            "moved_tuples": int(sw._moved_tuples),
            "trend": [float(x) for x in sw._trend],
            "n_alloc": int(sw.index.parts.n_alloc),
            "fsm": {"stage": int(sw.decision.stage),
                    "decision": int(sw.decision.decision),
                    "same_count": int(sw.decision.same_count),
                    "pre_rs": float(sw.decision.pre_rs)},
        },
        "source_rng": engine.source.base.rng.bit_generator.state,
    }
    return _save(directory, int(engine.tick_no), params=arrays,
                 extra={"stream": state, **(extra or {})},
                 config_name="stream")


def restore_stream(directory: str, engine, step: int | None = None) -> int:
    """Load a snapshot into a freshly built engine (same experiment
    spec).  Returns the restored tick number; the next ``engine.run(n)``
    continues the timeline bit-exactly."""
    from .checkpoint import latest_step

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    state = manifest["extra"]["stream"]
    data = np.load(os.path.join(src, "arrays.npz"))
    arrays = {k[len("params['"):-len("']")]: data[k] for k in data.files}

    router = engine.router
    sw = _swarm_of(router)
    sw.index.cell_to_partition = arrays["index/cell_to_partition"].copy()
    for f in _PART_FIELDS:
        setattr(sw.index.parts, f, arrays[f"parts/{f}"].copy())
    sw.index.parts.n_alloc = int(state["swarm"]["n_alloc"])
    sw.stats.rows = arrays["stats/rows"].copy()
    sw.stats.cols = arrays["stats/cols"].copy()
    sw.cap_factor = arrays["swarm/cap_factor"].copy()
    sw.round_no = int(state["swarm"]["round_no"])
    sw.dead = set(state["swarm"]["dead"])
    sw.standby = set(state["swarm"]["standby"])
    sw._moved_tuples = int(state["swarm"]["moved_tuples"])
    sw._trend.clear()
    sw._trend.extend(state["swarm"]["trend"])
    fsm = state["swarm"]["fsm"]
    sw.decision = type(sw.decision)(
        stage=int(fsm["stage"]), decision=int(fsm["decision"]),
        same_count=int(fsm["same_count"]), pre_rs=float(fsm["pre_rs"]))

    router.qres = arrays["router/qres"].copy()
    router.query_rects = arrays["router/query_rects"].copy()
    if "router/qres_kw" in arrays:
        router.qres_kw = arrays["router/qres_kw"].copy()
    if "router/sub_pivots" in arrays:
        router.sub_pivots = arrays["router/sub_pivots"].copy()
    if "store/counts" in arrays and getattr(router, "store", None) is not None:
        router.store.counts = arrays["store/counts"].copy()

    for f in _ENGINE_ARRAYS:
        getattr(engine, f)[:] = arrays[f"engine/{f}"]
    engine._acc[:] = arrays["engine/_acc"]
    engine.tick_no = int(state["tick_no"])
    engine.lam_bp = float(state["lam_bp"])
    engine._coordinator = int(state["coordinator"])
    engine.metrics.was_infeasible = bool(state["was_infeasible"])
    engine._pending_detect = {int(k): int(v)
                              for k, v in state["pending_detect"].items()}
    engine._pending_beats = {int(k): list(v)
                             for k, v in state["pending_beats"].items()}
    engine._partitioned = {int(k): int(v)
                           for k, v in state["partitioned"].items()}
    engine._suspected = set(state["suspected"])
    from ..streaming.engine import _InFlight
    engine._in_flight = [_InFlight(**fl) for fl in state["in_flight"]]
    engine.transfer_stats = dict(state["transfer_stats"])

    coord = engine.coord
    coord.clock = int(state["coord"]["clock"])
    coord.leader = int(state["coord"]["leader"])
    coord.last_beat = {int(k): int(v)
                       for k, v in state["coord"]["last_beat"].items()}
    from collections import deque
    coord._gaps = {int(k): deque(v, maxlen=coord.window)
                   for k, v in state["coord"]["gaps"].items()}

    engine.source.base.rng.bit_generator.state = state["source_rng"]
    engine._fused = None   # device mirror rebuilds from the host state
    return int(state["tick_no"])
