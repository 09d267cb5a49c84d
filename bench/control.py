"""The readings that the limits of ``check.LIMITS`` are set from, at a
cell's own size, on the card:

    python3 bench/control.py --workload <cell> --seconds 5 --seeds 1 2 3 ...

For each seed it runs the cell as ``run.py`` does (set-up, a window of at
least one whole cycle, the sampled rounds captured) and prints, as one
JSON line, the numbers of the program against the float64 reference and
those of the control: the reference computed in bfloat16, the nearest
precision below the configurations' float32, put in the program's place.
The last line gives the largest program reading and the smallest control
reading of each number.  The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    from check import LIMITS, evaluate
    from harness import load_cell, run_cell
    cell = load_cell(args.workload)
    prog, ctrl = {}, {}
    for seed in args.seeds:
        st = {}
        out = run_cell(cell, seed, args.seconds, False, args.device,
                       stash=st)
        p = {k: out["checks"][k]["value"] for k in LIMITS}
        c = evaluate(st["rounds"], st["traffic"], cell.system, torch.bfloat16)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": p, "control": c,
                          "metrics": out["metrics"]}), flush=True)
        for k in LIMITS:
            prog[k] = max(prog.get(k, p[k]), p[k])
            ctrl[k] = min(ctrl.get(k, c[k]), c[k])
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "program_max": prog, "control_min": ctrl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
