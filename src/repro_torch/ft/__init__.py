"""Fault tolerance: failure detection, Coordinator failover, straggler
mitigation, geo link modelling and chaos injection — the paper's
§4.1.1/§5 guarantees plus the geo-distributed fault model (DESIGN.md
§12)."""
from .chaos import ChaosEvent, ChaosSchedule, ChaosSpec
from .coordinator import CoordinatorGroup
from .links import LinkModel, LinkSpec, two_region
from .straggler import StragglerMitigator

__all__ = ["ChaosEvent", "ChaosSchedule", "ChaosSpec", "CoordinatorGroup",
           "LinkModel", "LinkSpec", "StragglerMitigator", "two_region"]
