"""Live-stream checkpointing in the PyTorch port
(``repro_torch.checkpoint.stream``, a copy of the JAX package's, on the
port's ``checkpoint.save``): a mid-run snapshot resumes bit-exactly on
the NumPy plane and the port's CPU plane, fused windows or not (the twin
of ``tests/test_faults.py``'s pins), a snapshot's keys and arrays are
the ones the JAX package writes, and only SWARM routers are
checkpointable."""
import dataclasses
import tempfile

import numpy as np
import pytest

import repro.checkpoint as RCK
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
