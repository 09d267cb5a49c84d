"""Exporters: JSONL event stream + Chrome-trace/Perfetto JSON.

Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` both load
the legacy Chrome trace-event JSON format: ``{"traceEvents": [...]}``
with ``ph="X"`` complete spans (``ts``/``dur`` in µs), ``ph="i"``
instants, ``ph="C"`` counters and ``ph="M"`` metadata naming
processes/threads.  We map the control plane to pid 0 and the machine
tracks to pid 1 with ``tid = machine id``, so the UI shows one lane
per machine under a "machines" process plus a "control-plane" lane —
rebalances and failures appear as global instant markers.

``trace_schema``/``validate_trace_dict`` implement just enough JSON
Schema (type/properties/required/items/enum) to validate exported
traces against the checked-in ``perfetto_schema.json`` without a
jsonschema dependency — CI and the tests both run it.
"""
from __future__ import annotations

import json
import os

from .tracer import CONTROL, Tracer

_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                            "perfetto_schema.json")


def _machine_ids(tracer: Tracer):
    return sorted({e.track for e in tracer.events if e.track != CONTROL})


def to_chrome_trace(tracer: Tracer, label: str = "repro") -> dict:
    """Render the buffered events as a Chrome-trace/Perfetto dict."""
    ev = []
    ev.append({"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
               "args": {"name": "control-plane"}})
    ev.append({"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
               "args": {"name": label}})
    ev.append({"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
               "args": {"name": "machines"}})
    for m in _machine_ids(tracer):
        ev.append({"ph": "M", "pid": 1, "tid": m, "name": "thread_name",
                   "args": {"name": f"machine {m}"}})
    for e in tracer.events:
        pid, tid = (0, 0) if e.track == CONTROL else (1, e.track)
        ts = e.t0 / 1e3                      # ns → µs
        args = {k: v for k, v in e.args.items()}
        if e.tick >= 0:
            args["tick"] = e.tick
        if e.kind == "span":
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": e.name,
                       "cat": "span", "ts": ts, "dur": max(e.dur, 0) / 1e3,
                       "args": args})
        elif e.kind == "instant":
            ev.append({"ph": "i", "pid": pid, "tid": tid, "name": e.name,
                       "cat": "event", "ts": ts, "s": "g", "args": args})
        else:                                # counter
            ev.append({"ph": "C", "pid": pid, "tid": tid, "name":
                       (e.name if e.track == CONTROL
                        else f"{e.name}/m{e.track}"),
                       "ts": ts, "args": {"value": e.args["value"]}})
    # decision instants land at the timestamp of the matching round
    # tick's last event (fallback 0) so they sit on the timeline
    last_ts_by_tick = {}
    for e in tracer.events:
        last_ts_by_tick[e.tick] = e.t0 / 1e3
    for tick, rec in tracer.decisions:
        ev.append({"ph": "i", "pid": 0, "tid": 0,
                   "name": f"decision:{rec.kind}", "cat": "decision",
                   "ts": last_ts_by_tick.get(tick, 0.0), "s": "g",
                   "args": rec.to_dict()})
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"label": label}}


def write_trace(tracer: Tracer, directory: str,
                name: str) -> tuple[str, str]:
    """Write ``<name>.jsonl`` (meta + events + decisions, one JSON
    object per line) and ``<name>.trace.json`` (Perfetto-loadable)."""
    os.makedirs(directory, exist_ok=True)
    jsonl = os.path.join(directory, f"{name}.jsonl")
    with open(jsonl, "w") as f:
        f.write(json.dumps({"kind": "meta", "label": name,
                            "events": len(tracer.events),
                            "decisions": len(tracer.decisions)}) + "\n")
        for e in tracer.events:
            f.write(json.dumps({
                "kind": e.kind, "name": e.name, "track": e.track,
                "tick": e.tick, "seq": e.seq, "parent": e.parent,
                "t0_ns": e.t0, "dur_ns": e.dur, "args": e.args}) + "\n")
        for tick, rec in tracer.decisions:
            f.write(json.dumps({"kind": "decision", "tick": tick,
                                "record": rec.to_dict()}) + "\n")
    trace = os.path.join(directory, f"{name}.trace.json")
    with open(trace, "w") as f:
        json.dump(to_chrome_trace(tracer, label=name), f)
    return jsonl, trace


# ---------------------------------------------------------------- #
# Minimal JSON-Schema validation (no external deps allowed).        #
# ---------------------------------------------------------------- #

def trace_schema() -> dict:
    with open(_SCHEMA_PATH) as f:
        return json.load(f)


def _validate(value, schema, path, errors):
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        ok = any(_is_type(value, x) for x in types)
        if not ok:
            errors.append(f"{path}: expected {t}, got "
                          f"{type(value).__name__}")
            return
    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: {value!r} not in {schema['enum']}")
    if isinstance(value, dict):
        for key in schema.get("required", ()):
            if key not in value:
                errors.append(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        for k, v in value.items():
            if k in props:
                _validate(v, props[k], f"{path}.{k}", errors)
            elif schema.get("additionalProperties") is False:
                errors.append(f"{path}: unexpected key {k!r}")
    if isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            _validate(v, schema["items"], f"{path}[{i}]", errors)


def _is_type(value, t: str) -> bool:
    if t == "object":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "string":
        return isinstance(value, str)
    if t == "number":
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    return True


def validate_trace_dict(trace: dict, schema: dict | None = None) -> list:
    """Validate an exported Chrome-trace dict; returns a list of error
    strings (empty = valid)."""
    errors: list[str] = []
    _validate(trace, schema or trace_schema(), "$", errors)
    return errors


def validate_trace_file(path: str) -> list:
    with open(path) as f:
        return validate_trace_dict(json.load(f))
