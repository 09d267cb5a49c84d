"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the tiny cells run on the
host's plain PyTorch plane) and the rest of a run is driven as it is.
The faults a cell on one card can have: a step that returns its state
unchanged, half of the batch left out with the rest standing in for it,
a tuple altered where it is produced, and a round that leaves the plan
as it was.  (A cell on one card has no exchange between cards to leave
out.)"""
import numpy as np
import pytest

from _bench_tiny import CELLS, tiny_cell
from harness import run_cell


def _close_unchanged(real):
    def close_round(self, stats, decay, live):
        return None
    return close_round


def _half_window(real):
    def run_window(self, state, cp, fp, carry, xy_stack, kw_stack=None,
                   cells=None):
        b = xy_stack.shape[1] // 2
        xy = np.concatenate([xy_stack[:, :b], xy_stack[:, :b]], 1)
        return real(self, state, cp, fp, carry, xy, kw_stack, cells)
    return run_window


def _moved_tuple(real):
    def run_window(self, state, cp, fp, carry, xy_stack, kw_stack=None,
                   cells=None):
        xy = xy_stack.copy()
        xy[0, 0] = 0.999 - xy[0, 0]
        return real(self, state, cp, fp, carry, xy, kw_stack, cells)
    return run_window


def _half_costs(real):
    """The per-call pricing (the per-tick path, and the replay of a
    declined window): the first half of the batch priced twice."""
    def costs(self, xy, *args):
        idx = np.arange(len(xy)) % ((len(xy) + 1) // 2)
        if args and len(args[0]) == len(xy):       # the keyword one-hots
            args = (args[0][idx],) + args[1:]
        return real(self, xy[idx], *args)
    return costs


def _moved_owner(real):
    """The per-call pricing with one tuple sent to another machine."""
    def costs(self, *args):
        out = list(real(self, *args))
        owners = out[1].copy()
        owners[0] = (owners[0] + 1) % (int(owners.max()) + 1)
        out[1] = owners
        return tuple(out)
    return costs


FAULTS = {
    "state_unchanged": {"close_round": _close_unchanged},
    "half_batch": {"run_window": _half_window, "tuple_costs": _half_costs,
                   "keyword_costs": _half_costs},
    "token_altered": {"run_window": _moved_tuple,
                      "tuple_costs": _moved_owner,
                      "keyword_costs": _moved_owner},
}


def _plan_unchanged(monkeypatch):
    """The planner decides no transfer, whatever the statistics say."""
    from repro_torch.core import planner

    def plan_round(stats, agg, parts, **kw):
        return planner.RoundPlan(agg.costs)
    monkeypatch.setattr(planner, "plan_round", plan_round)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS) + ["plan_unchanged"])
def test_fault_is_not_correct(name, fault, monkeypatch):
    from repro_torch.streaming.planes import TorchPlane
    cell = tiny_cell(name)
    if fault == "plan_unchanged":
        _plan_unchanged(monkeypatch)
    else:
        for method, make in FAULTS[fault].items():
            monkeypatch.setattr(TorchPlane, method,
                                make(getattr(TorchPlane, method)))
    out = run_cell(cell, 31, 0.5, False, "cpu")
    assert not out["correct"], out["checks"]
    if fault == "plan_unchanged":
        assert out["checks"]["decision"]["value"] > 0, out["checks"]
