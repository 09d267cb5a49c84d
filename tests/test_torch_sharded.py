"""The port's sharded data plane (``repro_torch.streaming.sharded``)
against the JAX package: the slot layout (``machine_homes``,
``assign_slots``), the per-shard ingest histograms against
``fused.window_histograms``, ``tests/test_sharded.py``'s
rebalance-and-failure and keyword timelines at D = 1, 2 and 4 shards
against the reference NumPy plane, the port against
``ShardedJaxPlane`` window by window (slot layout and per-shard banks)
at D = 1 in process and at D = 4 in a child with four forced host
devices, reshard bytes against billed bytes (and no aliasing between
the sent and received buffers), the bank unscatter and re-layout, the
sanitizer's reshard-billing law, and the refusals (more shards than
cards, no card).  The torch side runs on the CPU (``"sharded-cpu"``)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.streaming as J  # noqa: E402
import repro_torch.streaming as T  # noqa: E402
from repro.streaming import fused as jfused  # noqa: E402
from repro.streaming import sharded as jsharded  # noqa: E402
from repro_torch.launch.mesh import streaming_mesh  # noqa: E402
from repro_torch.streaming import sharded as tsharded  # noqa: E402
# the timelines and their checks live in the card tests' module, which
# imports nothing of JAX, so the card runs the same timelines
from test_torch_cuda import _assert_parity, _banks, _drive, _record, \
    _timeline  # noqa: E402
from test_torch_cuda import SHARD_G as G, SHARD_M as M  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")

# tests/test_sharded.py's timelines, built from either package (see
# _timeline): at cap_units 3e3 backpressure declines every fused window
# of the rebalance timeline (each is replayed per tick), so
# "rebalance-idle" — the same timeline with backpressure idle — is the
# one whose windows carry the slot banks through its transfers
TIMELINES = ("rebalance", "rebalance-idle", "keyword")


def _assert_windows(ref: list, got: list):
    assert len(got) == len(ref) > 0
    for i, (r, g_) in enumerate(zip(ref, got)):
        for what, a, b in zip(("slot_pid", "cn_rows", "cn_cols"), r, g_):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"window {i}: {what}")


def _metrics(pkg, plane, name, devices=0):
    scen, cfg, wl = _timeline(pkg, name, devices)
    kw = {} if wl is None else {"workload": wl}
    return pkg.run(pkg.Experiment(
        router=pkg.RouterSpec("swarm", grid_size=G, beta=4), scenario=scen,
        engine=cfg, data_plane=plane, seed=0, **kw)).metrics.asarrays()


@pytest.fixture(scope="module")
def numpy_ref():
    return {name: _metrics(J, "numpy", name) for name in TIMELINES}


# ---------------------------------------------------------------------------
# slot layout and ingest histograms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("retired", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_homes_and_slots_match_the_reference(d, retired):
    rng = np.random.default_rng(d * 7 + retired)
    for m in (3, 8, 13):
        np.testing.assert_array_equal(tsharded.machine_homes(m, d),
                                      jsharded.machine_homes(m, d))
    owner = rng.integers(0, M, size=300).astype(np.int32)
    if retired:
        owner[rng.random(300) < 0.3] = -1
    home = jsharded.machine_homes(M, d)
    for got, want in zip(tsharded.assign_slots(owner, home, d),
                         jsharded.assign_slots(owner, home, d)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["points", "cells", "keyword",
                                  "keyword+cells"])
@pytest.mark.parametrize("d", [1, 3, 4])
def test_shard_histograms_equal_window_histograms(d, mode):
    rng = np.random.default_rng(d)
    g, w, b, t1 = 16, 3, 1001, 5
    xy = rng.uniform(0, 1, (w, b, 2)).astype(np.float32)
    xy[:, :200] = np.floor(xy[:, :200] * g) / g     # points on cell borders
    row = np.clip((xy[..., 1] * g).astype(np.int64), 0, g - 1)
    col = np.clip((xy[..., 0] * g).astype(np.int64), 0, g - 1)
    cells = list(row * g + col) if "cells" in mode else None
    kw = None
    if "keyword" in mode:
        kw = rng.integers(-1, t1, (w, b, 3)).astype(np.int32)
        kw[..., -1] = t1 - 1                        # the wildcard bucket
    want, want_kw = jfused.window_histograms(
        xy, g, devices=d, cells=cells, kw_stack=kw,
        t1=t1 if kw is not None else 0)
    got, got_kw = tsharded.shard_histograms(
        xy, g, (torch.device("cpu"),) * d, cells=cells, kw_stack=kw,
        t1=t1 if kw is not None else 0)
    np.testing.assert_array_equal(_banks(got), want)
    if kw is None:
        assert got_kw is None and want_kw is None
    else:
        np.testing.assert_array_equal(_banks(got_kw), want_kw)


# ---------------------------------------------------------------------------
# the timelines against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("name", TIMELINES)
def test_sharded_cpu_matches_the_numpy_plane(numpy_ref, name, d):
    got = _metrics(T, "sharded-cpu", name, devices=d)
    _assert_parity(numpy_ref[name], got,
                   rtol=1e-4 if name == "keyword" else 1e-3)
    if name != "keyword":
        assert sum(got["transfers"]) > 0


def _sharded_runs(pkg, make_plane) -> dict:
    """Both rebalance timelines through fresh planes: metrics, the
    accepted windows' layouts and banks, and the bytes resharded."""
    out = {}
    for name in TIMELINES[:2]:
        plane, log = make_plane(), []
        _record(plane, log)
        out[name] = (_drive(pkg, plane, name), log,
                     plane.reshard_bytes_total)
    return out


def _assert_runs(ref: dict, got: dict) -> None:
    for name in TIMELINES[:2]:
        (ref_m, ref_log, ref_b), (got_m, got_log, got_b) = ref[name], \
            got[name]
        _assert_parity(ref_m, got_m)
        assert got_b == ref_b == sum(ref_m["migration_bytes"]) > 0, name
        if name == "rebalance":
            # every window declined and replayed per tick (see TIMELINES)
            assert got_log == ref_log == []
        else:
            if ref_log[0][0].shape[0] > 1:      # one shard: one layout
                assert len({w[0].tobytes() for w in ref_log}) > 1, \
                    "the slot layout never changed; the check is vacuous"
            _assert_windows(ref_log, got_log)


def test_one_shard_matches_the_sharded_jax_plane_window_by_window():
    _assert_runs(_sharded_runs(J, lambda: jsharded.ShardedJaxPlane(1)),
                 _sharded_runs(T, lambda: tsharded.ShardedTorchPlane(
                     1, "cpu")))


# the child: the JAX package's sharded plane on four forced host devices
CHILD = r"""
import os, sys
import numpy as np
from repro.launch.mesh import force_host_device_count
force_host_device_count(int(os.environ["REPRO_HOST_DEVICES"]))
sys.path.insert(0, os.environ["TESTS_DIR"])
import repro.streaming as J
import test_torch_sharded as t
from repro.streaming.sharded import ShardedJaxPlane
assert ShardedJaxPlane(4).devices == 4
out = {}
for name, (metrics, log, moved) in t._sharded_runs(
        J, lambda: ShardedJaxPlane(4)).items():
    out[name + "/reshard"] = moved
    out[name + "/windows"] = len(log)
    for k, v in metrics.items():
        out[f"{name}/m/{k}"] = np.asarray(v)
    for i, w in enumerate(log):
        for what, a in zip(("slot_pid", "cn_rows", "cn_cols"), w):
            out[f"{name}/{i}/{what}"] = a
np.savez(sys.argv[1], **out)
"""


def test_four_shards_match_the_sharded_jax_plane_in_a_child(tmp_path):
    path = str(tmp_path / "jax_sharded.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_HOST_DEVICES="4", TESTS_DIR=TESTS)
    res = subprocess.run([sys.executable, "-c", CHILD, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    z = np.load(path)
    ref = {}
    for name in TIMELINES[:2]:
        metrics = {k.split("/")[-1]: z[k] for k in z.files
                   if k.startswith(name + "/m/")}
        log = [tuple(z[f"{name}/{i}/{what}"]
                     for what in ("slot_pid", "cn_rows", "cn_cols"))
               for i in range(int(z[name + "/windows"]))]
        ref[name] = (metrics, log, int(z[name + "/reshard"]))
    _assert_runs(ref, _sharded_runs(
        T, lambda: tsharded.ShardedTorchPlane(4, "cpu")))


# ---------------------------------------------------------------------------
# transfers as resharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4])
def test_reshard_bytes_equal_billed_bytes_in_fresh_buffers(monkeypatch, d):
    sends = []
    real = tsharded.send

    def kept(buf, src, dst):
        sent, got = real(buf, src, dst)
        sends.append((buf.nbytes, sent, got))
        return sent, got

    monkeypatch.setattr(tsharded, "send", kept)
    plane = tsharded.ShardedTorchPlane(d, "cpu")
    billed = int(sum(_drive(T, plane)["migration_bytes"]))
    assert billed > 0, "the timeline moved nothing; the check is vacuous"
    assert plane.reshard_bytes_total == billed
    assert sum(n for n, _, _ in sends) == billed
    for nbytes, sent, got in sends:
        assert got.numel() * got.element_size() == nbytes
        assert torch.equal(sent, got)
        assert (got.untyped_storage().data_ptr()
                != sent.untyped_storage().data_ptr())


def test_transfer_of_pids_past_the_resident_capacity(monkeypatch):
    """ROADMAP F8: on this timeline (the README's sharded example) a
    round's split allocates pids past the resident state's capacity and
    hands them to a transfer in the same round.  The reference reads
    their header columns from that state and raises; the port reads its
    router's plan, and reshards exactly the billed bytes."""
    def exp(pkg, plane, devices=0):
        return pkg.Experiment(
            router=pkg.RouterSpec("swarm", grid_size=G),
            scenario=pkg.ScenarioSpec("normal_normal", ticks=48),
            engine=pkg.EngineConfig(num_machines=M, fused_window=8,
                                    devices=devices),
            data_plane=plane)

    with pytest.raises(IndexError):
        J.run(exp(J, jsharded.ShardedJaxPlane(1)))
    ref = J.run(exp(J, "numpy")).metrics.asarrays()
    monkeypatch.setenv("REPRO_SANITIZE", "1")     # the reshard-billing law
    for d in (1, 4):
        plane = tsharded.ShardedTorchPlane(d, "cpu")
        got = T.run(exp(T, plane)).metrics.asarrays()
        _assert_parity(ref, got)
        assert plane.reshard_bytes_total == sum(got["migration_bytes"]) > 0


def test_sanitized_run_holds_the_reshard_billing_law(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    scen, cfg, _ = _timeline(T, "rebalance", devices=4)
    res = T.run(T.Experiment(
        router=T.RouterSpec("swarm", grid_size=G, beta=4), scenario=scen,
        engine=cfg, data_plane="sharded-cpu", seed=0))
    assert res.sanitizer_stats["reshards"] > 0
    assert res.sanitizer_stats["collector_drains"] > 0
    assert sum(res.metrics.asarrays()["migration_bytes"]) > 0


# ---------------------------------------------------------------------------
# banks, layout, single step, declined windows
# ---------------------------------------------------------------------------

def _router_state(seed=0):
    router = T.SwarmRouter(G, M, beta=4, data_plane="torch-cpu")
    rng = np.random.default_rng(seed)
    router.swarm.ingest_points(rng.uniform(0, 1, (3000, 2)).astype(
        np.float32))
    return router, router.fused_host_state()


def test_collector_banks_and_resync_slots_round_trip():
    plane = tsharded.ShardedTorchPlane(4, "cpu")
    _, host = _router_state()
    state = plane.make_state(host)
    rng = np.random.default_rng(1)
    g1 = G + 1
    full = [rng.integers(0, 50, (host.capacity, g1)).astype(np.float32)
            for _ in range(2)]
    # scatter partition-ordered banks into the slots, then read them back
    banks = []
    for bank in full:
        per = []
        for sp in state.slot_pid:
            rows = np.zeros((len(sp), g1), np.float32)
            rows[sp >= 0] = bank[sp[sp >= 0]]
            per.append(torch.from_numpy(rows))
        banks.append(tuple(per))
    state = state._replace(cn_rows=banks[0], cn_cols=banks[1])
    for got, want in zip(plane.collector_banks(state), full):
        np.testing.assert_array_equal(got, want)
    # move every partition of machine 0 (shard 0) to machine 7 (shard 3):
    # the layout changes and the banks follow their partitions
    owner = state.host_owner.copy()
    idx = np.flatnonzero(owner == 0)
    assert len(idx)
    old_slots = state.slot_pid.copy()
    state = plane.scatter_update(state, {"owner": (idx, np.full(len(idx), 7))})
    assert not np.array_equal(state.slot_pid, old_slots)
    for got, want in zip(plane.collector_banks(state), full):
        np.testing.assert_array_equal(got, want)
    assert all(t_.device.type == "cpu" for t_ in state.owner)
    np.testing.assert_array_equal(state.owner[0].numpy(), state.host_owner)
    want_slots = tsharded.assign_slots(state.host_owner, state.home, 4)
    np.testing.assert_array_equal(state.slot_pid, want_slots[0])
    # every cell is routed to the shard its partition's slot lives on
    for j, route in enumerate(state.routes):
        pids = state.host_grid.reshape(-1)[route.cells[0].numpy()]
        np.testing.assert_array_equal(route.pids.numpy()[route.slot.numpy()],
                                      pids)
    assert sum(len(r.slot) for r in state.routes) == G * G


@pytest.mark.parametrize("d", [1, 3])
def test_single_step_folds_into_the_owning_shards(d):
    router, host = _router_state(2)
    cp = router._cost_params()
    xy = np.random.default_rng(3).uniform(0, 1, (500, 2)).astype(np.float32)
    one = T.TorchPlane("cpu")
    ref_state, ref_out = one.step(one.make_state(host), cp, xy,
                                  track_stats=True)
    plane = tsharded.ShardedTorchPlane(d, "cpu")
    state, out = plane.step(plane.make_state(host), cp, xy,
                            track_stats=True)
    for a, b in zip(ref_out, out):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(one.collector_banks(ref_state),
                    plane.collector_banks(state)):
        np.testing.assert_array_equal(a, b)


def test_declined_window_leaves_the_state_untouched():
    plane = tsharded.ShardedTorchPlane(4, "cpu")
    router, host = _router_state()
    state = plane.make_state(host)
    before = [t_.clone() for t_ in state.cn_rows + state.cn_cols]
    xy = np.random.default_rng(0).uniform(0, 1, (4, 500, 2)).astype(
        np.float32)
    fp = T.FusedParams(cap_units=10.0, lambda_max=500.0, bp_high=2.0,
                       bp_dec=0.6, bp_inc=0.04, alive=np.ones(M),
                       track_stats=True, n_alloc=host.n_alloc)
    carry = T.EngineCarry(np.zeros(M), np.zeros(M), 500.0)
    new, _, outs, ok = plane.run_window(state, router._cost_params(), fp,
                                        carry, xy)
    assert not ok
    assert outs.injected[0] == 500 and outs.injected[-1] < 500
    for a, b in zip(state.cn_rows + state.cn_cols, before):
        assert torch.equal(a, b)
    # the throttled window's deposits live only in the returned banks,
    # and the counters of held windows did not move
    for got in plane.collector_banks(new):
        assert float(got.sum()) == float(outs.injected.sum())
    assert plane.windows == 0 and plane.exchange_bytes_total == 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_streaming_mesh_needs_colocate_for_more_shards_than_cards(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="colocate"):
        streaming_mesh(4, "cuda")
    assert streaming_mesh(None, "cuda") == (torch.device("cuda", 0),)
    assert streaming_mesh(4, "cuda", colocate=True) == \
        (torch.device("cuda", 0),) * 4
    assert streaming_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="shards requested"):
        streaming_mesh(0, "cpu")


def test_sharded_plane_on_the_card_or_raises_naming_cuda():
    if torch.cuda.is_available():
        assert T.get_plane("sharded").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.get_plane("sharded")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsharded.ShardedTorchPlane(2)
    assert T.sharded_plane(2, "cpu").devices == 2
    assert T.sharded_plane(2, "cpu") is T.sharded_plane(2, "cpu")
