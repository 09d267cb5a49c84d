"""``TorchPlane`` (the PyTorch port's data plane) against the JAX
package: golden routing parity through the port's routers, the per-call
routing/pricing surface and the fused single step against ``JaxPlane``,
scatter patching, the resident-state upload, the torch cell rule on
cell borders (ROADMAP F1) and exact window counts with TF32 enabled
(ROADMAP F2).  Inputs come from NumPy seeds and reach both sides as
NumPy arrays; the torch side runs on the CPU (``device="cpu"``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.streaming as J  # noqa: E402
import repro_torch.streaming as T  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.queries import all_workloads  # noqa: E402
from repro.streaming.baselines import force_rebalance_round as j_force  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.queries import all_workloads as t_all_workloads  # noqa: E402
from repro_torch.streaming import TorchPlane, planes as tplanes  # noqa: E402
from repro_torch.streaming.baselines import (  # noqa: E402
    force_rebalance_round as t_force)

G, M = 64, 8
GOLDEN = __file__.rsplit("/", 1)[0] + "/golden/routing_golden.npz"
CPU = TorchPlane("cpu")
JAX = J.get_plane("jax")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def assert_same_index(jr, tr):
    """The JAX package's router and the port's hold the same plan: the
    GlobalIndex grid and the partition owner table are identical."""
    np.testing.assert_array_equal(jr.index.cell_to_partition,
                                  tr.index.cell_to_partition)
    np.testing.assert_array_equal(jr.index.parts.owner, tr.index.parts.owner)


def twin_routers(seed: int, workload=None, t_plane=CPU):
    """The JAX package's SwarmRouter (on the JAX plane) and the port's
    (on ``t_plane``), driven from one NumPy seed through the same
    queries, points and one forced rebalance round — checked to hold the
    same index before any parity check uses them."""
    rng = np.random.default_rng(seed)
    kw = {} if workload is None else {"workload": workload}
    jr = J.SwarmRouter(G, M, beta=4, data_plane="jax", **kw)
    tr = T.SwarmRouter(G, M, beta=4, data_plane=t_plane, **kw)
    rects = np.clip(rng.uniform(0, 0.95, (300, 4)), 0, 0.999).astype(
        np.float32)
    rects[:, 2:] = rects[:, :2] + rng.uniform(0.005, 0.05, (300, 2))
    pts = np.concatenate([rng.uniform(0, 1, (2000, 2)),
                          rng.uniform(0.1, 0.3, (3000, 2))]).astype(
                              np.float32)
    for r, force in ((jr, j_force), (tr, t_force)):
        r.register_queries(rects)
        r.swarm.ingest_points(pts)
        force(r.swarm)
        r.reindex_all_queries()
    assert_same_index(jr, tr)
    return jr, tr, rng


# ---------------------------------------------------------------------------
# Golden parity through the port's routers (mirrors tests/test_api.py)
# ---------------------------------------------------------------------------

def _make_router(kind, wl, plane, golden):
    tag = "knn" if wl.query_model.value == "knn" else "range"
    if kind == "replicated":
        return T.ReplicatedRouter(M, G, workload=wl, data_plane=plane)
    if kind == "static_uniform":
        return T.StaticUniformRouter(G, M, workload=wl, data_plane=plane)
    if kind == "static_history":
        return T.StaticHistoryRouter(G, M, golden["hist_pts"],
                                     golden[f"hist_q_{tag}"], rounds=20,
                                     workload=wl, data_plane=plane)
    return T.SwarmRouter(G, M, beta=4, workload=wl, data_plane=plane)


@pytest.mark.parametrize("kind", ["replicated", "static_uniform",
                                  "static_history", "swarm"])
def test_golden_parity(kind, golden):
    assert [w.label for w in t_all_workloads()] == \
        [w.label for w in all_workloads()]
    for wl in t_all_workloads():
        tag = "knn" if wl.query_model.value == "knn" else "range"
        r = _make_router(kind, wl, CPU, golden)
        assert r.plane is CPU
        rec = {}
        if wl.spec.continuous:
            assert r.ingest(T.QueryBatch(golden[f"queries_{tag}"])) is None
        d = r.ingest(T.TupleBatch(golden["pts1"]))
        rec["o1"], rec["c1"] = d.owners, d.costs
        if wl.spec.snapshot:
            d = r.ingest(T.ProbeBatch(golden["probes"]))
            rec["po1"], rec["pc1"] = d.owners, d.costs
        if kind == "swarm":
            t_force(r.swarm)
        d = r.ingest(T.TupleBatch(golden["pts2"]))
        rec["o2"], rec["c2"] = d.owners, d.costs
        if wl.spec.snapshot:
            d = r.ingest(T.ProbeBatch(golden["probes"]))
            rec["po2"], rec["pc2"] = d.owners, d.costs
        for name, arr in rec.items():
            ref = golden[f"{kind}/{wl.label}/{name}"]
            if name.startswith(("o", "po")):   # owners: exact
                np.testing.assert_array_equal(arr, ref,
                                              err_msg=f"{wl.label}/{name}")
            else:                              # costs: ≤1e-4 relative
                np.testing.assert_allclose(arr.astype(np.float64), ref,
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"{wl.label}/{name}")


# ---------------------------------------------------------------------------
# Per-call routing and pricing against JaxPlane
# ---------------------------------------------------------------------------

def _state(jr):
    return (jr.index.cell_to_partition, jr.index.parts.owner, jr.qres,
            jr.resident_counts(), jr._area_frac())


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("tuple_driven", [True, False])
def test_tuple_costs_and_match_terms_match_jax_plane(seed, tuple_driven):
    jr, tr, rng = twin_routers(seed)
    xy = rng.uniform(0, 1, (777, 2)).astype(np.float32)
    grid, owner, qres, qm, af = _state(jr)
    cp = dataclasses.replace(jr._cost_params(), tuple_driven=tuple_driven,
                             store_cost=0.25)
    want = JAX.tuple_costs(xy, grid, owner, qres, qm, af, cp)
    got = CPU.tuple_costs(xy, grid, owner, qres, qm, af,
                          tplanes.CostParams(**dataclasses.asdict(cp)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32 and got[2].dtype == np.float32
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)
    jm = JAX.match_terms(xy, grid, qres, af, 4e-4, 1.5)
    tm = CPU.match_terms(xy, grid, qres, af, 4e-4, 1.5)
    np.testing.assert_array_equal(tm[0], jm[0])
    np.testing.assert_allclose(tm[1], jm[1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [1, 6])
def test_keyword_costs_and_match_terms_match_jax_plane(seed):
    jr, tr, rng = twin_routers(seed)
    grid, owner, qres, qm, af = _state(jr)
    t1 = 9
    qres_kw = rng.integers(0, 30, (len(owner), t1)).astype(np.float64)
    ids = rng.integers(-1, t1 - 1, (500, 3))
    ids[:, -1] = t1 - 1                           # wildcard bucket
    from repro.queries import bucket_onehot
    onehot = bucket_onehot(ids, t1 - 1)
    xy = rng.uniform(0, 1, (500, 2)).astype(np.float32)
    cp = dataclasses.replace(jr._cost_params(), delivery_cost=0.3,
                             keyword=True)
    want = JAX.keyword_costs(xy, onehot, grid, owner, qres_kw, qm, af, cp)
    got = CPU.keyword_costs(xy, onehot, grid, owner, qres_kw, qm, af,
                            tplanes.CostParams(**dataclasses.asdict(cp)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    jm = JAX.keyword_match_terms(xy, onehot, grid, qres_kw, af, 4e-4, 1.5)
    tm = CPU.keyword_match_terms(xy, onehot, grid, qres_kw, af, 4e-4, 1.5)
    np.testing.assert_array_equal(tm[0], jm[0])
    for a, b in zip(tm[1:], jm[1:]):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("routed", [False, True])
def test_probe_costs_match_jax_plane(routed):
    jr, tr, rng = twin_routers(2)
    grid, owner, _, _, af = _state(jr)
    c = rng.uniform(0, 0.9, (300, 2))
    rects = np.concatenate([c, c + rng.uniform(0.001, 0.05, (300, 2))],
                           1).astype(np.float32)
    store = rng.integers(0, 500, len(owner)).astype(np.float64)
    d_machine = rng.integers(0, 10_000, M).astype(np.float64)
    cp = dataclasses.replace(jr._cost_params(), scan_kappa=0.7)
    pids = owners = None
    if routed:
        pids, owners = JAX.probe_costs(rects, grid, owner, store, d_machine,
                                       af, cp)[:2]
    want = JAX.probe_costs(rects, grid, owner, store, d_machine, af, cp,
                           pids=pids, owners=owners)
    got = CPU.probe_costs(rects, grid, owner, store, d_machine, af,
                          tplanes.CostParams(**dataclasses.asdict(cp)),
                          pids=pids, owners=owners)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)


def test_probe_term_torch_form_matches_numpy():
    q = np.array([0.0, 10.0, 1500.0, 1501.0, 9e4], np.float32)
    want = tplanes.probe_term(np, q, 1.0, 1500.0)
    got = tplanes.probe_term(torch, torch.from_numpy(q), 1.0, 1500.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The fused single step and the resident state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keyword", [False, True])
def test_step_with_collectors_matches_jax_plane(keyword):
    jr, tr, rng = twin_routers(7)
    host = jr.fused_host_state()
    kw = None
    if keyword:
        t1 = 5
        host = dataclasses.replace(host, qres_kw=rng.integers(
            0, 20, (host.capacity, t1)).astype(np.float64))
        kw = rng.integers(-1, t1, (1000, 2)).astype(np.int32)
    cp = jr._cost_params()
    xy = rng.uniform(0, 1, (1000, 2)).astype(np.float32)
    st_j, out_j = JAX.step(JAX.make_state(host), cp, xy, track_stats=True,
                           kw=kw)
    st_t, out_t = CPU.step(tplanes.state_from_numpy(host, "cpu"),
                           tplanes.CostParams(**dataclasses.asdict(cp)), xy,
                           track_stats=True, kw=kw)
    assert len(out_t) == len(out_j)
    np.testing.assert_array_equal(out_t[0], out_j[0])
    np.testing.assert_array_equal(out_t[1], out_j[1])
    for a, b in zip(out_t[2:], out_j[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # collector banks: integer counts, exact across planes
    cn_r, cn_c = CPU.collector_banks(st_t)
    assert cn_r.dtype == np.float64
    np.testing.assert_array_equal(cn_r, np.asarray(st_j.cn_rows))
    np.testing.assert_array_equal(cn_c, np.asarray(st_j.cn_cols))
    assert cn_r.sum() == len(xy)


def test_step_rejects_query_batches():
    router = T.SwarmRouter(G, M, data_plane=CPU)
    st = CPU.make_state(router.fused_host_state())
    with pytest.raises(NotImplementedError, match="host-boundary"):
        CPU.step(st, router._cost_params(),
                 np.zeros((4, 2), np.float32),
                 query_batch=np.zeros((1, 4), np.float32))


def test_state_from_numpy_takes_the_jax_package_snapshot():
    jr, tr, _ = twin_routers(3)
    st = tplanes.state_from_numpy(jr.fused_host_state(), "cpu")
    ref = CPU.make_state(tr.fused_host_state())
    for name, a, b in zip(st._fields, st, ref):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.device.type == "cpu", name
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert st.grid.dtype == torch.int64 and st.qres.dtype == torch.float32
    assert not st.cn_rows.any()


def test_scatter_update_patches_device_state():
    router = T.SwarmRouter(G, M, data_plane=CPU)
    host = router.fused_host_state()
    st = CPU.make_state(host)
    grid_before = st.grid
    new_owner = host.owner.copy()
    new_owner[[2, 5]] = [7, 1]
    new_grid = host.grid.copy()
    new_grid[0, :5] = 3
    new_qres = host.qres.copy()
    new_qres[4] = 11
    updates = host.diff(dataclasses.replace(host, owner=new_owner,
                                            grid=new_grid, qres=new_qres))
    st = CPU.scatter_update(st, updates)
    assert st.grid is grid_before                 # patched, not rebuilt
    np.testing.assert_array_equal(st.owner.numpy(), new_owner)
    np.testing.assert_array_equal(st.grid.numpy(), new_grid)
    np.testing.assert_array_equal(st.qres.numpy(), new_qres)


# ---------------------------------------------------------------------------
# F1: the torch cell rule, F2: exact counts with TF32 enabled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [7, 64, 512])
def test_points_to_cells_torch_matches_numpy_on_cell_borders(g):
    k = np.arange(g + 1, dtype=np.float64)
    border = k / g
    near = np.concatenate([border, np.nextafter(border, 2.0),
                           np.nextafter(border, -1.0), [-0.25, 1.5]])
    x = np.repeat(near, 3)
    y = np.tile(near, 3)[:len(x)]
    xy64 = np.stack([x, y], 1)
    xy = xy64.astype(np.float32)
    row_n, col_n = tgeo.points_to_cells(xy, g)
    # float64 input is cast to float32 first (the device planes' rule)
    for arr in (xy, xy64):
        row_t, col_t = tgeo.points_to_cells(torch.from_numpy(arr), g)
        assert row_t.dtype == torch.int32
        np.testing.assert_array_equal(row_t.numpy(), row_n)
        np.testing.assert_array_equal(col_t.numpy(), col_n)
    # the JAX package's jnp path puts them in the same cells
    row_j, col_j = jgeo.points_to_cells(jnp.asarray(xy), g)
    np.testing.assert_array_equal(np.asarray(row_j), row_n)
    np.testing.assert_array_equal(np.asarray(col_j), col_n)
    # and the numpy path of the port is the JAX package's numpy path
    np.testing.assert_array_equal(jgeo.points_to_cells(xy, g)[0], row_n)


def test_rects_to_cells_torch_matches_numpy():
    rng = np.random.default_rng(0)
    c = rng.uniform(-0.1, 1.0, (400, 2))
    rects = np.concatenate([c, c + rng.uniform(-0.01, 0.3, (400, 2))],
                           1).astype(np.float32)
    rects[:10] = np.arange(10)[:, None] / 8.0      # on cell borders
    want = tgeo.rects_to_cells(rects, 8)
    got = tgeo.rects_to_cells(torch.from_numpy(rects), 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def _hot_window(seed=0, w=2, b=6000):
    """A window whose busiest cells hold more than 2048 tuples per tick
    (TF32's 10-bit mantissa would round such counts)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (w, b, 2)).astype(np.float32)
    xy[:, :2500] = rng.uniform(0.5, 0.5 + 0.9 / G, (w, 2500, 2))
    xy[:, 2500:5000] = rng.uniform(0.1, 0.1 + 0.9 / G, (w, 2500, 2))
    return xy


def _window_banks(plane, host, xy, cp, mod=T):
    fp = mod.FusedParams(cap_units=1e12, lambda_max=float(xy.shape[1]),
                         bp_high=2.0, bp_dec=0.6, bp_inc=0.04,
                         alive=np.ones(M), track_stats=True,
                         n_alloc=host.n_alloc)
    carry = mod.EngineCarry(np.zeros(M), np.zeros(M), float(xy.shape[1]))
    st, carry, outs, ok = plane.run_window(plane.make_state(host), cp, fp,
                                           carry, xy)
    assert ok
    return plane.collector_banks(st), outs


def _assert_f2(device):
    router = T.SwarmRouter(G, M, beta=4, data_plane="numpy")
    host = router.fused_host_state()
    xy = _hot_window()
    row, col = tgeo.points_to_cells(xy[0], G)
    assert np.bincount(row * G + col).max() > 2048
    cp = router._cost_params()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        (tr, tc), outs = _window_banks(TorchPlane(device), host, xy, cp)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (nr, nc), ref = _window_banks(tplanes.get_plane("numpy"), host, xy, cp)
    np.testing.assert_array_equal(tr, nr)
    np.testing.assert_array_equal(tc, nc)
    np.testing.assert_array_equal(outs.injected, ref.injected)
    np.testing.assert_allclose(outs.throughput, ref.throughput, rtol=1e-6)


def test_window_counts_exact_above_2048_with_tf32_enabled():
    _assert_f2("cpu")


# ---------------------------------------------------------------------------
# No fallback that hides the device, and the stubs off the main path
# ---------------------------------------------------------------------------

def test_torch_plane_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TorchPlane().device.type == "cuda"
        assert T.get_plane(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchPlane()
        with pytest.raises(RuntimeError, match="CUDA"):
            T.SwarmRouter(G, M)             # no plane named: the card
    assert T.Experiment().data_plane == "torch"
    assert CPU.device.type == "cpu"
    assert T.get_plane("torch-cpu").device.type == "cpu"
    assert set(T.available_planes()) == {"numpy", "torch", "torch-cpu"}


@pytest.mark.parametrize("call,kernel", [
    (lambda p: p.match_counts(np.zeros((4, 2)), np.zeros((2, 4))), "K2"),
    (lambda p: p.keyword_match_counts(np.zeros((4, 2)), np.zeros((4, 3)),
                                      np.zeros((2, 4)), np.zeros((2, 3))),
     "K3"),
    (lambda p: p.knn_distances(np.zeros((4, 2)), np.zeros((2, 2))), "K4"),
])
def test_unported_match_kernels_raise_naming_the_roadmap(call, kernel):
    with pytest.raises(NotImplementedError, match=f"{kernel}.*Queue 2"):
        call(CPU)


def test_sharded_plane_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        T.get_plane("sharded")
    with pytest.raises(ValueError, match="unknown data plane"):
        T.get_plane("jax")


def test_window_over_the_unpadded_allocated_prefix_matches_jax_plane():
    """The port sizes a window's partition axis at ``n_alloc`` exactly,
    where the JAX plane pads it to a 64-row recompile bucket: the two
    windows agree all the same."""
    xy = np.random.default_rng(3).uniform(0, 1, (3, 1000, 2)).astype(
        np.float32)
    out = {}
    for mod, plane in ((T, CPU), (J, JAX)):
        router = mod.SwarmRouter(G, M, beta=4, data_plane="numpy")
        host = router.fused_host_state()
        assert host.n_alloc % 64
        out[mod] = _window_banks(plane, host, xy, router._cost_params(), mod)
    (tr, tc), got = out[T]
    (jr, jc), ref = out[J]
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(got.injected, ref.injected)
    for name in ("throughput", "latency", "utilization"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, err_msg=name)
