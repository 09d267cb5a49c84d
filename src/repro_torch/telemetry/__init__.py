"""Flight-recorder telemetry: structured spans, planner decision
traces, and Perfetto export (DESIGN.md §9).

Dependency-free by design — ``core``/``ft``/``streaming`` all import
from here, and this package imports nothing from them.
"""
from .export import (to_chrome_trace, trace_schema, validate_trace_dict,
                     validate_trace_file, write_trace)
from .records import (CandidateDecision, DecisionRecord, FsmState,
                      SplitChoice, TransferTrace, candidates_from_plan,
                      transfer_traces)
from .timers import Stopwatch, time_once_us, time_us
from .tracer import (CONTROL, NOOP, TelemetryConfig, TraceEvent, Tracer,
                     activate, current)

__all__ = [
    "CONTROL", "NOOP", "TelemetryConfig", "TraceEvent", "Tracer",
    "activate", "current",
    "CandidateDecision", "DecisionRecord", "FsmState", "SplitChoice",
    "TransferTrace", "candidates_from_plan", "transfer_traces",
    "to_chrome_trace", "trace_schema", "validate_trace_dict",
    "validate_trace_file", "write_trace",
    "Stopwatch", "time_once_us", "time_us",
]
