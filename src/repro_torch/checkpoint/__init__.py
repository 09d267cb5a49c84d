"""Checkpoint/restart with elastic resharding.

``checkpoint`` holds the generic tree/array layer (training-style
params + opt state); ``stream`` wires it into the live system —
snapshot/restore of a running StreamingEngine + SWARM router pair,
bit-exact on resume (see tests/test_faults.py parity pins).
"""
from .checkpoint import latest_step, restore, save
from .stream import restore_stream, save_stream

__all__ = ["save", "restore", "latest_step",
           "save_stream", "restore_stream"]
