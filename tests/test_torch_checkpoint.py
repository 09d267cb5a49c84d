"""Live-stream checkpointing in the PyTorch port
(``repro_torch.checkpoint.stream``, a copy of the JAX package's, on the
port's ``checkpoint.save``): a mid-run snapshot resumes bit-exactly on
the NumPy plane and the port's CPU plane, fused windows or not (the twin
of ``tests/test_faults.py``'s pins), a snapshot's keys and arrays are
the ones the JAX package writes, and only SWARM routers are
checkpointable.  Model checkpoints of the recurrent families (jamba's
Mamba, attention, MLP and MoE leaves; xlstm's sLSTM and mLSTM leaves)
cross the packages bit for bit in both directions."""
import dataclasses
import tempfile

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as RCK
import repro.models.model as RM
from repro import configs as RC
from repro_torch import configs as PC
from repro_torch import tree as T
from repro_torch.checkpoint import restore, save
from repro_torch.models import (abstract_params, from_jax_layout,
                                init_params, to_jax_layout)
import repro.streaming.engine as RE
import repro.streaming.experiments as RX
from repro_torch.checkpoint import restore_stream, save_stream
from repro_torch.ft import ChaosSpec, two_region
from repro_torch.streaming.engine import EngineConfig, StreamingEngine
from repro_torch.streaming.experiments import (Experiment, RouterSpec,
                                               ScenarioSpec)

M = 8
LINKS = two_region(M, inter_ms=25.0, jitter_ms=10.0, tick_ms=10.0, seed=1)
CHAOS = ChaosSpec(seed=2, ticks=60, drop_beats=0.05, delay_beats=0.1,
                  partitions=1, partition_len=4, interrupts=2)


def _geo_exp(X=None, **over):
    """The geo experiment of tests/test_faults.py, from the port's
    experiment module (or ``X``, the JAX package's)."""
    X = X or dict(Experiment=Experiment, RouterSpec=RouterSpec,
                  ScenarioSpec=ScenarioSpec, EngineConfig=EngineConfig)
    kw = dict(
        scenario=X["ScenarioSpec"](name="two_overlapping", ticks=60,
                                   preload_queries=1500, chaos=CHAOS),
        router=X["RouterSpec"](kind="swarm", link_aware=True,
                               trend_window=6),
        engine=X["EngineConfig"](num_machines=M, links=LINKS,
                                 adaptive_detector=True),
    )
    kw.update(over)
    return X["Experiment"](**kw)


def _build(exp, Engine=StreamingEngine):
    src = exp.scenario.build(seed=exp.seed, workload=exp.workload)
    router = exp.router.build(num_machines=exp.engine.num_machines,
                              workload=exp.workload,
                              data_plane=exp.data_plane, seed=exp.seed,
                              standby=exp.engine.standby_machines)
    eng = Engine(router, src, exp.engine)
    pre = eng.stream.preload(exp.scenario.preload_queries)
    if pre is not None:
        router.ingest(pre)
    return eng


def _with_window(exp, window):
    if not window:
        return exp
    return dataclasses.replace(exp, engine=dataclasses.replace(
        exp.engine, fused_window=window))


@pytest.mark.parametrize("plane,window", [("numpy", 0), ("numpy", 8),
                                          ("torch-cpu", 0),
                                          ("torch-cpu", 8)])
def test_checkpoint_resume_matches_continuous_run(plane, window):
    exp = _with_window(_geo_exp(data_plane=plane), window)
    cont = _build(exp)
    cont.run(40)
    half = _build(exp)
    half.run(20)
    with tempfile.TemporaryDirectory() as d:
        save_stream(d, half)
        fresh = _build(exp)
        assert restore_stream(d, fresh) == 20
        fresh.run(20)
    a, b = cont.metrics.asarrays(), fresh.metrics.asarrays()
    for k in a:
        assert np.array_equal(a[k][20:], b[k]), k


def test_checkpoint_requires_swarm_router():
    exp = _geo_exp(router=RouterSpec(kind="static_uniform"),
                   data_plane="torch-cpu")
    eng = _build(exp)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(TypeError):
            save_stream(d, eng)


def test_stream_snapshot_crosses_packages():
    """The port's snapshot at tick 20 holds the JAX package's keys and
    arrays (NumPy plane, the same run), and the port resumes from the
    JAX package's snapshot to the port's continuous run, bit for bit."""
    ref_x = dict(Experiment=RX.Experiment, RouterSpec=RX.RouterSpec,
                 ScenarioSpec=RX.ScenarioSpec, EngineConfig=RE.EngineConfig)
    exp = _geo_exp(data_plane="numpy")
    ref_exp = _geo_exp(ref_x, data_plane="numpy")
    ref = _build(ref_exp, RE.StreamingEngine)
    ref.run(20)
    port = _build(exp)
    port.run(20)
    cont = _build(exp)
    cont.run(40)
    with tempfile.TemporaryDirectory() as dr, \
            tempfile.TemporaryDirectory() as dp:
        RCK.save_stream(dr, ref)
        save_stream(dp, port)
        a = np.load(f"{dr}/step_00000020/arrays.npz")
        b = np.load(f"{dp}/step_00000020/arrays.npz")
        assert sorted(a.files) == sorted(b.files)
        assert "params['index/cell_to_partition']" in b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        fresh = _build(exp)
        assert restore_stream(dr, fresh) == 20
        fresh.run(20)
    x, y = cont.metrics.asarrays(), fresh.metrics.asarrays()
    for k in x:
        assert np.array_equal(x[k][20:], y[k]), k


def _model_configs(arch):
    return (dataclasses.replace(RC.get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(PC.get_smoke_config(arch), dtype="float32"))


def _assert_port_tree_is(cfg, params, ref):
    """The port's ``params`` in the reference's layout equal ``ref``
    (a tree of arrays) leaf for leaf, bit for bit, types included."""
    ours = jax.tree.map(lambda t: t.numpy(), to_jax_layout(cfg, params))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(T.leaves(ours))
    for path, want in flat:
        got = ours
        for key in path:
            got = got[key.key]
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_1_3b"])
def test_a_recurrent_model_checkpoint_crosses_the_packages(arch):
    ref_cfg, cfg = _model_configs(arch)
    rp = RM.init_params(ref_cfg, jax.random.PRNGKey(4))
    with tempfile.TemporaryDirectory() as d:     # JAX → port
        RCK.save(d, 3, params=rp, config_name=ref_cfg.name)
        pp, _, man = restore(d, 3, abstract_params=abstract_params(cfg),
                             cfg=cfg, device="cpu")
    assert man["config"] == ref_cfg.name
    _assert_port_tree_is(cfg, pp, rp)
    params = init_params(cfg, 5, device="cpu", dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:     # port → JAX
        save(d, 7, params=params, config_name=cfg.name, cfg=cfg)
        back, _, _ = RCK.restore(d, 7,
                                 abstract_params=RM.abstract_params(ref_cfg))
    _assert_port_tree_is(cfg, params, back)


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_1_3b"])
def test_recurrent_layouts_round_trip(arch):
    """The port's tree → the reference's layout → back is the identity
    on every leaf (the Mamba, mLSTM and sLSTM leaves included), two
    periods deep; the meta template has the same shapes and types."""
    _, cfg = _model_configs(arch)
    cfg = dataclasses.replace(cfg, num_layers=2 * cfg.num_layers)
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    back = from_jax_layout(cfg, to_jax_layout(cfg, params))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params),
                                                 T.leaves(back)))
    assert [(t.shape, t.dtype) for t in T.leaves(abstract_params(cfg))] == \
        [(t.shape, t.dtype) for t in T.leaves(params)]
