"""The main path's round close timed alone, from a given checkout.

    python3 scripts/close_phase.py CHECKOUT [RUNS]

Runs the ``chip_smoke.py`` and ``src/repro_torch`` of CHECKOUT (the
repository root, or a commit unpacked with ``git archive`` under the
gitignored ``_checkout/``) on one CUDA card: builds kernel K1, then
drives ``chip_smoke.py``'s main path (grid 512, 64 machines, 131 072
tuples a tick, 100 000 queries, 96 ticks) RUNS times (default 2) with
the engine's tracer on and nothing wrapped, and prints for each run one
JSON line: the host milliseconds per call of the spans ``stats_close``
(``TorchPlane.close_round``; mean and median) and ``round_close`` (the
whole round), K1's launches and the run's wall seconds.  The first run
of a process also pays the kernel's first load, and a run's first
round close on a plane that page-locks its banks pays for that.  Run
it for two commits in turns in one call (parent, change, change,
parent) to compare them on one card.
"""
import json
import os
import statistics
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as C
    import repro_torch.streaming as T
    from repro_torch.kernels import stats_update as SU
    if not torch.cuda.is_available():
        sys.exit("close_phase: needs a CUDA card")
    SU.ops.build()
    for k in range(runs):
        eng, _ = C._main_engine(T, T.TorchPlane("cuda"),
                                telemetry=T.TelemetryConfig(tick_spans=False))
        SU.ops.launches = 0
        wall = C._run(torch, np, eng)
        spans, _ = C._spans(eng.tracer)
        closes = [ev.dur / 1e6 for ev in eng.tracer.events
                  if ev.kind == "span" and ev.name == "stats_close"]
        per_call = {name: spans[name]["s"] / spans[name]["calls"] * 1e3
                    for name in ("stats_close", "round_close")}
        print(json.dumps({
            "checkout": root, "run": k, "card": C.nvidia_smi(),
            "rounds": eng.router.swarm.round_no,
            "k1_launches": SU.ops.launches,
            "stats_close_calls": spans["stats_close"]["calls"],
            "stats_close_ms_per_call": per_call["stats_close"],
            "stats_close_ms_median": statistics.median(closes),
            "stats_close_ms_first": closes[0],
            "round_close_ms_per_call": per_call["round_close"],
            "wall_s": wall}), flush=True)
        del eng


if __name__ == "__main__":
    main()
