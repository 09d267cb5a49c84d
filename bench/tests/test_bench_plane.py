"""The data plane of a cell's chips: the tiny ``range-hotspot`` cell on
four chips runs SWARM's sharded plane, four shards on the host standing
in for four cards, through the harness and is correct; with the exchange
between shards left out, or a fault of the one-card suite planted in the
sharded plane, it is not.  On one chip the cell keeps ``TorchPlane``.
The cards the harness synchronises, sizes and profiles are the ones the
built plane runs on."""
import dataclasses

import pytest

from _bench_tiny import tiny_cell
from check import LIMITS
from harness import run_cell
from test_bench_faults import FAULTS

CHIPS = 4


def sharded_cell():
    c = tiny_cell("range-hotspot")
    return dataclasses.replace(c, chips=CHIPS)


def _windows(monkeypatch) -> list:
    """Counts the sharded plane's fused windows and the shards they ran
    on."""
    from repro_torch.streaming import ShardedTorchPlane
    seen = []
    real = ShardedTorchPlane.run_window

    def run_window(self, *args, **kw):
        seen.append(self.devices)
        return real(self, *args, **kw)
    monkeypatch.setattr(ShardedTorchPlane, "run_window", run_window)
    return seen


def test_sharded_cell_is_correct(monkeypatch):
    seen = _windows(monkeypatch)
    out = run_cell(sharded_cell(), 2**31 + 5, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert seen and set(seen) == {CHIPS}
    assert out["device"]["count"] == 1        # the host
    for k in LIMITS:
        c = out["checks"][k]
        assert c["value"] <= c["limit"], (k, c)
    assert out["checks"]["rounds_checked"]["value"] == 6


def test_sharded_cell_traced(monkeypatch):
    """The readers of a traced run find the sharded plane's own span."""
    import readings
    seen, traces = _windows(monkeypatch), []

    class Trace(readings.Trace):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            traces.append(self)
    monkeypatch.setattr(readings, "Trace", Trace)
    out = run_cell(sharded_cell(), 7, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    assert seen
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    (tr,) = traces
    assert any(e.name == "sharded_window_dispatch" and
               e.args["devices"] == CHIPS for e in tr.spans)


def test_one_chip_builds_one_device():
    import system as S
    from repro_torch.streaming import ShardedTorchPlane, TorchPlane
    from traffic import stream
    cell = tiny_cell("range-hotspot")
    assert cell.chips == 1
    eng = S.build(cell.system, stream.generate(cell.traffic, cell.system, 1),
                  "cpu", False, cell.chips)
    got = eng.router.swarm.plane
    assert type(got) is TorchPlane
    assert not isinstance(got, ShardedTorchPlane)
    assert S.cards(eng) == ()


class _Plane:
    def __init__(self, devs, sharded):
        import torch
        devs = tuple(torch.device(d) for d in devs)
        if sharded:
            self.shards = devs
        self.device = devs[0]


@pytest.mark.parametrize("devs,sharded,want", [
    (("cuda:0",), False, (0,)),
    (("cuda:2",), False, (2,)),
    (("cuda:0", "cuda:1", "cuda:2", "cuda:3"), True, (0, 1, 2, 3)),
    (("cuda:1", "cuda:0", "cuda:1", "cuda:0"), True, (1, 0)),
    (("cpu",) * 4, True, ()),
])
def test_cards_are_the_planes(devs, sharded, want):
    """The harness's cards are the distinct cards the plane's shards
    name, whatever rule placed them."""
    import types

    import system as S
    eng = types.SimpleNamespace(router=types.SimpleNamespace(
        swarm=types.SimpleNamespace(plane=_Plane(devs, sharded))))
    assert S.cards(eng) == want


def _exchange_left_out(real):
    """Each destination shard keeps only the cells its own workers
    binned: nothing crosses between shards."""
    def _exchange(self, hists, route, j):
        return hists[j][:, route.cells[self._rep[j]]].to(self.shards[j]), 0
    return _exchange


SHARDED_FAULTS = {**FAULTS,
                  "exchange_left_out": {"_exchange": _exchange_left_out}}


@pytest.mark.parametrize("fault", sorted(SHARDED_FAULTS))
def test_sharded_fault_is_not_correct(fault, monkeypatch):
    from repro_torch.streaming import ShardedTorchPlane
    for method, make in SHARDED_FAULTS[fault].items():
        monkeypatch.setattr(ShardedTorchPlane, method,
                            make(getattr(ShardedTorchPlane, method)))
    out = run_cell(sharded_cell(), 31, 0.5, False, "cpu")
    assert not out["correct"], out["checks"]
