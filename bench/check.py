"""The comparison that decides ``correct``: each sampled round of the
window against the plain reference (``reference/swarm_ref.py``), over
three layers — the data plane's per-tick outputs, the statistics banks
of the round close, and the plan the control plane reports.

The numbers compared, each with its limit (``LIMITS``; PERF.md gives the
readings they were set from):

* ``injected``   ticks whose injected count differs (exact, limit 0);
* ``tick_gap``   the widest gap of the per-tick outputs (throughput,
  each machine's utilisation, deliveries), as a share of the largest
  reference value of that output in the round;
* ``latency_gap`` the same of the per-tick latency, apart: it is the
  queue left after processing over the capacity, a difference of two
  near-equal sums, so float32 reads it far less closely than the rest;
* ``collectors`` entries of the N′, Q′ and spanQ′ collectors, as the
  round close found them, that differ from the counts of the round's
  injected tuples (exact, limit 0);
* ``bank_gap``   the widest gap of the statistics after the round close
  against Algorithm 2 applied to the banks the close found, as a share
  of the largest reference value of that channel;
* ``plan``       violations of the plan's guarantee, at the round's start
  and end (exact, limit 0);
* ``qres``       partitions whose resident-query counts, as the program
  priced the round with them, differ from the standing set's overlaps
  with the plan (exact, limit 0);
* ``decision``   cells of the grid whose partition (box and owner) at
  the round's end differs from the plan the reference decides from the
  banks after the close, plus the fields of the decision state (stage,
  decision, run of equal decisions) that differ (exact, limit 0);
* ``migration``  the gap in transfers plus the gap in standing queries
  moved (the migration bytes over a query's wire size) against the
  reference's decision (exact, limit 0).

A split within ``round_ref.TIE`` of the least |C_diff| counts as the
reference's own; a round whose decision rests on another near-tie reads
0 on ``decision`` and ``migration``.  ``rounds_tied`` counts both.

The reference follows the program from its own state where only that
state says where a round starts: the queue state, the plan and the
decision state at the round's start, and the maintained statistics the
close found; the round's decision is taken again from the banks the
close left, which ``bank_gap`` holds to the reference.  The stages this
skips are checked by themselves: the plan by ``plan`` and ``qres``, the
collectors by ``collectors``.
"""
from __future__ import annotations

import sys

import numpy as np

from reference import round_ref as rref
from reference import swarm_ref as ref

LIMITS = {"injected": 0, "tick_gap": 1e-4, "latency_gap": 1e-3,
          "collectors": 0, "bank_gap": 3e-5, "plan": 0, "qres": 0,
          "decision": 0, "migration": 0}


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max(initial=0.0))
    diff = float(np.abs(got - want).max(initial=0.0))
    return diff / scale if scale > 0 else diff


def query_cells(traffic, sysp: dict) -> dict:
    """The standing set (preload and burst) in cells, with pivots for a
    keyword deployment."""
    rects = [traffic.queries] + [r for r, _ in traffic.burst.values()]
    out = {"cells": ref.rect_cells(np.concatenate(rects), int(sysp["grid"]))}
    if sysp["query_model"] == "spatial_keyword":
        terms = [traffic.query_terms] + [k for _, k in traffic.burst.values()]
        out["pivots"] = ref.pivots(np.concatenate(terms),
                                   int(sysp["term_buckets"]))
    return out


def round_inputs(rec: dict, traffic) -> dict:
    ticks = [(rec["tick"] + i) % traffic.cycle for i in range(rec["ticks"])]
    return {"points": [traffic.points[t] for t in ticks],
            "terms": (None if traffic.terms is None
                      else [traffic.terms[t] for t in ticks]),
            "queue_units": rec["queue_units"],
            "queue_tuples": rec["queue_tuples"], "lam": rec["lam"],
            **rec["start"]}


def _decision(rec: dict, got: dict, sysp: dict, queries: dict) -> tuple:
    """``decision``, ``migration`` and a near-tie count of one round:
    ``got`` holds what stood in the program's place (its banks after the
    close, its plan, decision state, transfers and migration bytes at the
    round's end); the reference decides the round again from those banks
    and the state the round started from.  A split within ``TIE`` of the
    least |C_diff| is as good as the least; a round whose decision rests
    on any other near-tie is not compared."""
    import torch
    rows, cols = got["exit"]
    start = rec["start"]
    want = rref.plan_round({"rows": rows, "cols": cols, "start": start,
                            "fsm": rec["fsm"]}, sysp, queries, torch.float64)
    if want["tie"]:
        print(f"round at tick {rec['tick']}: a near-tie ({want['tie']}), "
              "decision not compared", file=sys.stderr)
        return 0, 0, 1
    moved = got["migration_bytes"] / float(sysp["query_bytes"])

    def gaps(cells, transfers, moved_want):
        bad = int((got["cells"] != cells).any(-1).sum())
        bad += sum(got["fsm"][k] != want["fsm"][k]
                   for k in ("stage", "decision", "same_count"))
        return bad, abs(got["transfers"] - transfers) \
            + abs(moved - moved_want)

    bad, mig = gaps(want["cells"], want["transfers"], want["moved"])
    if bad or mig:
        for made in want["alts"]:
            cells, m = rref.outcome(start, made, want["to"], queries)
            if gaps(cells, want["transfers"], m) == (0, 0):
                return 0, 0, 1
    return bad, mig, 0


def compare_round(rec: dict, traffic, sysp: dict, queries: dict,
                  dtype) -> dict:
    """The numbers of one captured round against the reference computed
    in ``dtype``; with a lower ``dtype`` the reference itself stands in
    the program's place (the control): its outputs are compared with the
    float64 reference's."""
    import torch
    want = ref.replay_round(round_inputs(rec, traffic), sysp, queries,
                            torch.float64)
    if dtype == torch.float64:
        got = rec["out"]
        cn = [(c["entry"][0][ref.C_N:], c["entry"][1][ref.C_N:])
              for c in rec["closes"]]
        closes = [(c["entry"], c["exit"], c["decay"]) for c in rec["closes"]]
        qres = rec["qres"]
        plan = [{"exit": c["exit"], "cells": rref.program_cells(rec["end"]),
                 "fsm": rec["fsm_end"], "transfers": rec["transfers"],
                 "migration_bytes": rec["migration_bytes"]}
                for c in rec["closes"][-1:]]
    else:
        low = ref.replay_round(round_inputs(rec, traffic), sysp, queries,
                               dtype)
        got = {k: low[k] for k in rec["out"]}
        live = rec["start"]["live"]
        zero = np.zeros((2,) + low["cn_rows"][live].shape)
        cn = [(np.concatenate([low["cn_rows"][live][None], zero]),
               np.concatenate([low["cn_cols"][live][None], zero]))]
        closes = [(c["entry"], tuple(ref.close_bank(b, c["decay"], dtype)
                                     for b in c["entry"]), c["decay"])
                  for c in rec["closes"]]
        qres = want["qres"]
        plan = []
        for _, exit_, _ in closes[-1:]:
            mine = rref.plan_round({"rows": exit_[0], "cols": exit_[1],
                                    "start": rec["start"], "fsm": rec["fsm"]},
                                   sysp, queries, dtype)
            plan.append({"exit": exit_, "cells": mine["cells"],
                         "fsm": mine["fsm"], "transfers": mine["transfers"],
                         "migration_bytes": mine["moved"]
                         * float(sysp["query_bytes"])})
    nums = {"injected": int((np.asarray(got["injected"])
                             != want["injected"]).sum())}
    nums["tick_gap"] = max(_gap(got[k], want[k]) for k in
                           ("throughput", "utilization", "deliveries"))
    nums["latency_gap"] = _gap(got["latency"], want["latency"])
    live = rec["start"]["live"]
    bad = 0
    if len(rec["closes"]) != 1:
        bad += 1
    for rows, cols in cn:
        for bank, counts in ((rows, want["cn_rows"]), (cols, want["cn_cols"])):
            bad += int((bank[0] != counts[live]).sum())
            bad += int((bank[1:] != 0).sum())
    nums["collectors"] = bad
    gaps = [0.0]
    for entry, out, decay in closes:
        for e, o in zip(entry, out):
            w = ref.close_bank(e, decay, torch.float64)
            gaps += [_gap(o[ch], w[ch]) for ch in ref.MAINTAINED]
            # a collector left uncleared reads against what it held
            gaps += [float(np.abs(o[ch]).max(initial=0.0))
                     / max(float(np.abs(e[ch]).max(initial=0.0)), 1.0)
                     for ch in ref.COLLECTORS]
    nums["bank_gap"] = max(gaps)
    m = int(sysp["machines"])
    nums["plan"] = sum(ref.plan_faults(p["grid"], p["boxes"], p["owner"],
                                       p["live"], m)
                       for p in (rec["start"], rec["end"]))
    nums["qres"] = int((np.asarray(qres)[live] != want["qres"][live]).sum())
    if rec["qres_kw"] is not None and dtype == torch.float64:
        _, kw = ref.resident_counts(queries["cells"],
                                    rec["start"]["boxes"][live],
                                    queries["pivots"],
                                    int(sysp["term_buckets"]) + 1)
        nums["qres"] += int((rec["qres_kw"][live] != kw).any(1).sum())
    nums["decision"], nums["migration"], nums["ties"] = 0, 0, 0
    for p in plan:
        d, mg, t = _decision(rec, p, sysp, queries)
        nums["decision"] += d
        nums["migration"] += mg
        nums["ties"] += t
    if not plan:
        nums["decision"] += 1
    return nums


def evaluate(rounds: list[dict], traffic, sysp: dict, dtype=None) -> dict:
    """The worst of each number over the sampled rounds."""
    import torch
    dtype = dtype or torch.float64
    queries = query_cells(traffic, sysp)
    worst = {k: 0 for k in LIMITS}
    worst["ties"] = 0
    for rec in rounds:
        nums = compare_round(rec, traffic, sysp, queries, dtype)
        worst["ties"] += nums.pop("ties")
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
    return worst


def verdict(nums: dict, sampled: int) -> tuple[bool, dict]:
    checks = {k: {"value": nums[k], "limit": LIMITS[k]} for k in LIMITS}
    checks["rounds_tied"] = {"value": nums.get("ties", 0),
                             "limit": "not compared"}
    checks["rounds_checked"] = {"value": sampled, "limit": ">= 1"}
    ok = sampled >= 1 and all(nums[k] <= LIMITS[k] for k in LIMITS)
    return ok, checks
