"""Derive a cell's ``cap_units`` from the cost model, once, on the card:

    python3 bench/derive_capacity.py --workload range-overload --seeds 1 2 3

builds the cell's deployment with the configuration's own (unbounded)
capacity, runs the set-up cycle and one more, and reads each machine's
offered work a tick (its utilisation times the capacity: nothing queues
when capacity is unbounded).  The cluster's offered work before the
first surge opens (a hotspot or a trending term), a machine's share of
it averaged over those ticks, is what the capacity is set against:
``cap_units`` is that over the ``load_share`` of the cell's workload
file, so that the cluster as a whole is offered that share of its
capacity.  Prints the readings as JSON.
"""
import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def offered_work(cell, seed: int, device: str) -> np.ndarray:
    """(ticks before the hotspot, machines) offered work of the cycle
    after set-up."""
    import system as S
    from traffic import stream
    sysp = {**cell.system, "cap_units": cell.config["system"]["cap_units"]}
    traffic = stream.generate(cell.traffic, sysp, seed)
    eng = S.build(sysp, traffic, device, False, cell.chips)
    eng.run(S.warmup_ticks(traffic.cycle, int(sysp["round_every"])))
    t0 = eng.tick_no
    eng.run(traffic.cycle)
    start = min(int(h["start"]) for h in cell.traffic.get("hotspots", [])
                + cell.traffic.get("hot_terms", []))
    util = np.asarray(eng.metrics.utilization[t0:], np.float64)
    ticks = (t0 + np.arange(len(util))) % traffic.cycle
    return util[ticks < start] * float(sysp["cap_units"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from harness import load_cell
    cell = load_cell(args.workload)
    share = float(cell.workload["load_share"])
    mean = []
    for seed in args.seeds:
        work = offered_work(cell, seed, args.device)
        mean.append(float(work.mean()))
        print(json.dumps({"seed": seed, "machine_mean": mean[-1],
                          "hottest_mean": float(work.max(1).mean()),
                          "hottest_max": float(work.max())}),
              file=sys.stderr)
    print(json.dumps({"load_share": share, "machine_mean_per_seed": mean,
                      "cap_units": float(np.mean(mean)) / share}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
