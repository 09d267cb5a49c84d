"""Engine replay of a declined fused window (``engine._window_reference``,
the per-tick path after backpressure engaged inside a window): host ms
per declined window, span ``fused_window`` with ``ok`` false minus its
``fused_window_dispatch`` child."""


def read(trace):
    disp = {e.parent: e.dur for e in trace.spans
            if e.name == "fused_window_dispatch"}
    vals = [e.dur - disp.get(e.seq, 0) for e in trace.spans
            if e.name == "fused_window" and e.args.get("ok") is False]
    return sum(vals) / len(vals) / 1e6 if vals else None
