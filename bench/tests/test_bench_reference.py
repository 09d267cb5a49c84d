"""A whole run of each cell at a tiny size on the host's plain PyTorch
plane: the program's rounds agree with the plain reference on every
layer the check covers (exact numbers exactly), and the round-at-a-time
drive of the window changes nothing the engine computes."""
import numpy as np
import pytest

from _bench_tiny import CELLS, tiny_cell
from check import LIMITS, evaluate
from harness import run_cell

EXACT = [k for k, v in LIMITS.items() if v == 0]


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    st = {}
    out = run_cell(tiny_cell(name), 2**31 + 5, 0.5, False, "cpu", stash=st)
    assert out["correct"], out["checks"]
    assert out["checks"]["rounds_checked"]["value"] == 6
    for k in EXACT:
        assert out["checks"][k]["value"] == 0
    assert list(out["checks"])[-1] == "rounds_checked"
    assert set(out["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}
    rounds = st["rounds"]
    assert all(len(r["closes"]) == 1 for r in rounds)
    assert sum(r["out"]["injected"].sum() for r in rounds) > 0
    # the decision check is not idle: some checked round moved load
    assert sum(r["transfers"] for r in rounds) > 0


@pytest.mark.parametrize("total", (6, 7, 40, 500))
def test_checked_rounds_span_the_window(total):
    """Wherever the window ends, the checked rounds reach from its start
    to its last cycle, and the captures held at a time stay bounded."""
    from harness import CHECK_ROUNDS, Sampler
    per_cycle = 6
    s = Sampler(11, per_cycle)
    for k in range(total):
        if s.take(k):
            s.keep(k, {})
        assert len(s.spread) <= 2 * CHECK_ROUNDS
    ks = [r["k"] for r in s.chosen()]
    assert len(ks) == len(set(ks)) == min(CHECK_ROUNDS, total)
    assert ks == sorted(ks)
    assert ks[-1] >= total - 2 * per_cycle
    if total >= 40:
        assert ks[0] < total // 3


def test_overload_cell_declines_windows():
    """The tiny overload cell throttles: some ticks inject less than a
    full batch, so the check covers the declined windows' replay."""
    st = {}
    out = run_cell(tiny_cell("range-overload"), 17, 0.5, False, "cpu",
                   stash=st)
    assert out["correct"], out["checks"]
    inj = np.concatenate([r["out"]["injected"] for r in st["rounds"]])
    assert inj.min() < tiny_cell("range-overload").system["lambda_max"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_layers(name):
    out = run_cell(tiny_cell(name), 3, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    cell = tiny_cell(name)
    host = {m["name"] for m in cell.per_layer
            if m["source"] == "program_span"}
    assert host and host <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_round_at_a_time_equals_one_run(name):
    import system as S
    from traffic import stream
    cell = tiny_cell(name)
    traffic = stream.generate(cell.traffic, cell.system, 9)
    re = int(cell.system["round_every"])
    n = S.warmup_ticks(traffic.cycle, re) + 5 * re
    a = S.build(cell.system, traffic, "cpu", False, cell.chips)
    a.run(S.warmup_ticks(traffic.cycle, re))
    for _ in range(5):
        a.run(re)
    b = S.build(cell.system, traffic, "cpu", False, cell.chips)
    b.run(n)
    ma, mb = a.metrics.asarrays(), b.metrics.asarrays()
    assert ma.keys() == mb.keys()
    for k in ma:
        assert np.array_equal(ma[k], mb[k]), k
    assert a.router.swarm.round_no == b.router.swarm.round_no


def test_control_is_not_correct():
    """The reference in bfloat16, put in the program's place, fails."""
    import torch

    from check import verdict
    for name in CELLS:
        st = {}
        cell = tiny_cell(name)
        run_cell(cell, 23, 0.5, False, "cpu", stash=st)
        nums = evaluate(st["rounds"], st["traffic"], cell.system,
                        torch.bfloat16)
        ok, _ = verdict(nums, len(st["rounds"]))
        assert not ok, (name, nums)


def test_a_near_best_split_counts_as_the_references(monkeypatch):
    """A program that splits where |C_diff| is within ``TIE`` of the
    least is judged right; the same split, when it is not near, wrong."""
    import torch

    import check
    from reference import round_ref as rref
    for name in CELLS:
        st = {}
        cell = tiny_cell(name)
        run_cell(cell, 2**31 + 5, 0.5, False, "cpu", stash=st)
        queries = check.query_cells(st["traffic"], cell.system)
        for rec in st["rounds"]:
            rows, cols = rec["closes"][-1]["exit"]
            rnd = {"rows": rows, "cols": cols, "start": rec["start"],
                   "fsm": rec["fsm"]}
            monkeypatch.setattr(rref, "TIE", 1e9)    # every split is near
            want = rref.plan_round(rnd, cell.system, queries, torch.float64)
            if want["tie"] or not want["alts"]:
                continue
            cells, moved = rref.outcome(rec["start"], want["alts"][-1],
                                        want["to"], queries)
            got = {"exit": (rows, cols), "cells": cells, "fsm": want["fsm"],
                   "transfers": 1,
                   "migration_bytes": moved * cell.system["query_bytes"]}
            assert check._decision(rec, got, cell.system, queries) \
                == (0, 0, 1)
            monkeypatch.setattr(rref, "TIE", 0.0)
            assert check._decision(rec, got, cell.system, queries)[0] > 0
            return
    pytest.fail("no checked round split a partition")
