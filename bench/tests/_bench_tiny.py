"""Tiny cells for the benchmark's CPU tests: the same files and code as
a run, shrunk so that a run takes seconds on the host's plain PyTorch
plane (``TorchPlane("cpu")``)."""
import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import load_cell  # noqa: E402

CELLS = ("range-hotspot", "pubsub-hashtags", "range-overload")


def tiny_cell(name: str):
    c = copy.deepcopy(load_cell(name))
    s = c.system
    if s["query_model"] == "range":
        s.update(grid=32, machines=4, queries=3000, lambda_max=2048,
                 round_every=4, fused_window=8)
        if name == "range-overload":
            s["cap_units"] = 5000.0
        c.traffic["cycle_ticks"] = 24
        for h in c.traffic["hotspots"]:
            h.update(start=8, duration=8, query_burst=200)
    else:
        s.update(grid=16, machines=4, queries=3000, lambda_max=800,
                 cap_units=2250.0)
        c.traffic["cycle_ticks"] = 12
        for h in c.traffic.get("hot_terms", []):
            h.update(start=2, duration=8)
    return c
