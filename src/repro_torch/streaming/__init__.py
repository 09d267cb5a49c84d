"""Streaming substrate: the typed event/decision API (``api``), the
pluggable data planes (``planes``), the engine simulation, sources, the
four routing approaches of the paper's evaluation and the declarative
experiment suite (``experiments``).  Every router runs any (query model
× persistence model) workload from ``repro.queries`` (re-exported here
for convenience)."""
from ..queries import (PersistenceModel, QueryModel, SubscriptionIndex,
                       TermHasher, TupleStore, WorkloadSpec, all_workloads,
                       bucket_masks, bucket_onehot, tokenize)
from ..telemetry import DecisionRecord, TelemetryConfig, Tracer
from .api import (EventBatch, EventStream, MachineFailure, MachineJoin,
                  MachineSlow, MembershipChange, MemoryUsage, ProbeBatch,
                  QueryBatch, Router, RoundOutcome, RoutingDecision,
                  TupleBatch)
from .baselines import (ReplicatedRouter, RoundInfo, StaticHistoryRouter,
                        StaticUniformRouter, SwarmRouter)
from .engine import EngineConfig, Metrics, StreamingEngine, run_experiment
from .experiments import (Experiment, ExperimentResult, RouterSpec,
                          ScenarioSpec, run, run_suite, sweep,
                          workload_query_side)
from .fused import (DeviceState, EngineCarry, FusedHostState, FusedOutputs,
                    FusedParams)
from .planes import DataPlane, NumpyPlane, TorchPlane, available_planes, \
    get_plane
from .sharded import ShardedTorchPlane, sharded_plane
from .sources import (Hotspot, HotTerm, MembershipEvent, ReplaySource,
                      ScenarioSource, TwitterLikeSource, scenario)

__all__ = [
    # events / decisions
    "TupleBatch", "QueryBatch", "ProbeBatch", "MachineFailure",
    "MachineJoin", "MachineSlow", "MembershipChange", "EventBatch",
    "RoutingDecision", "RoundOutcome", "MemoryUsage", "Router", "EventStream",
    # data planes
    "DataPlane", "NumpyPlane", "TorchPlane", "ShardedTorchPlane",
    "sharded_plane", "get_plane", "available_planes",
    # device-resident fused ingest
    "DeviceState", "FusedHostState", "FusedParams", "EngineCarry",
    "FusedOutputs",
    # routers
    "ReplicatedRouter", "StaticUniformRouter", "StaticHistoryRouter",
    "SwarmRouter", "RoundInfo",
    # engine
    "EngineConfig", "Metrics", "StreamingEngine", "run_experiment",
    # experiment suite
    "Experiment", "ExperimentResult", "RouterSpec", "ScenarioSpec",
    "run", "run_suite", "sweep", "workload_query_side",
    # sources
    "Hotspot", "HotTerm", "MembershipEvent", "ReplaySource",
    "ScenarioSource", "TwitterLikeSource", "scenario",
    # workloads
    "QueryModel", "PersistenceModel", "WorkloadSpec", "TupleStore",
    "all_workloads",
    # spatial-keyword pub/sub
    "TermHasher", "SubscriptionIndex", "bucket_masks", "bucket_onehot",
    "tokenize",
    # telemetry (repro.telemetry re-exports)
    "TelemetryConfig", "Tracer", "DecisionRecord",
]
