"""Event stream and staging (``engine.run_fused`` drawing and stacking a
window's batches, the state diff): host ms per accepted fused window,
span ``fused_window`` minus its ``fused_window_dispatch`` child.  A
declined window is left out: its per-tick replay is ``declined_window_ms``."""


def read(trace):
    disp = {e.parent: e.dur for e in trace.spans
            if e.name == "fused_window_dispatch"}
    vals = [e.dur - disp[e.seq] for e in trace.spans
            if e.name == "fused_window" and e.args.get("ok", True)
            and e.seq in disp]
    return sum(vals) / len(vals) / 1e6 if vals else None
