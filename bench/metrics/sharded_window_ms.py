"""Sharded data plane window (``ShardedTorchPlane.run_window``): host ms
per call, span ``sharded_window_dispatch`` (the enabled tracer waits for
every card at its end)."""


def read(trace):
    vals = [e.dur for e in trace.spans if e.name == "sharded_window_dispatch"]
    return sum(vals) / len(vals) / 1e6 if vals else None
