"""Data plane window (``TorchPlane.run_window``): host ms per call, span
``fused_window_dispatch`` (the enabled tracer waits for the device at
its end)."""


def read(trace):
    vals = [e.dur for e in trace.spans if e.name == "fused_window_dispatch"]
    return sum(vals) / len(vals) / 1e6 if vals else None
