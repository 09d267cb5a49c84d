"""The port's dry run (``repro_torch.launch.dryrun``) on a 2×4 mesh of a
fake process group (``launch.mesh.fake_world(8)``), in subprocesses: a
process has one default group.

The five cells of ``tests/test_dryrun_small.py`` with its assertions
(the eager peak standing for XLA's peak), the skip record, the record's
file name and fields against the reference's (those without a twin
named, not filled), per-device parameter bytes equal to the sharding
rules' arithmetic, and the K5/K6 ops traced: the attention op twice per
layer and microbatch in a train step (forward and the remat
recompute), the histogram op in every MoE layer.
"""
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest
from jax.sharding import AbstractMesh

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.distributed import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.models import abstract_params
from repro_torch.models.model import keeps_float32, layer_kinds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
CELLS = [
    ("internlm2_1_8b", "decode_32k"),
    ("qwen2_moe_a2_7b", "train_4k"),
    ("jamba_v0_1_52b", "long_500k"),
    ("hubert_xlarge", "prefill_32k"),
    ("hubert_xlarge", "decode_32k"),      # a skip record
]
# the reference's record keys of an "ok" cell
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "multi_pod", "remat",
                  "zero1", "tag", "microbatches", "layout", "memory",
                  "analytic", "roofline", "model", "tokens_per_step", "kind",
                  "status"}
BATCH = r"""
import json, sys
from repro_torch.launch.dryrun import run_one
out = sys.argv[1]
for cell in json.loads(sys.argv[2]):
    run_one(*cell, multi_pod=False, out_dir=out,
            mesh_dims=((2, 4), ("data", "model")))
"""


def _load(out, arch, shape):
    with open(os.path.join(out, f"{arch}__{shape}__2x4.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def records():
    """Every cell's record: internlm2_1_8b × train_4k through the
    command line, the others in one process."""
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "internlm2_1_8b", "--shape", "train_4k", "--mesh-shape", "2x4",
             "--out", d], env=ENV, capture_output=True, text=True,
            timeout=540, cwd=ROOT)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        assert "[dryrun] internlm2_1_8b × train_4k × 2x4: OK" in res.stdout
        res = subprocess.run(
            [sys.executable, "-c", BATCH, d, json.dumps(CELLS)], env=ENV,
            capture_output=True, text=True, timeout=540, cwd=ROOT)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        return {cell: _load(d, *cell)
                for cell in [("internlm2_1_8b", "train_4k")] + CELLS}


@pytest.mark.parametrize("arch,shape", [("internlm2_1_8b", "train_4k")]
                         + CELLS[:4])
def test_cell_traces(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["eager_peak_bytes"] > rec["memory"]["argument_bytes"]
    rl = rec["roofline"]
    assert rl["t_compute"] > 0 and rl["t_memory"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["model"]["useful_fraction"] <= 1.5
    assert rl["traced_flops_per_device"] > 0
    assert rec["kernel_calls"].get("flash_attention", 0) > 0


def test_record_fields_match_the_reference(records):
    rec = records[("internlm2_1_8b", "train_4k")]
    assert REFERENCE_KEYS <= set(rec)
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    assert rec["microbatches"] == 2 and rec["kind"] == "train"
    assert rec["roofline"]["no_twin"] == RL.NO_TWIN["roofline"]
    assert rec["memory"]["no_twin"] == RL.NO_TWIN["memory"]
    for absent in ("xla_flops_undercount", "xla_flops_per_device"):
        assert absent not in rec["roofline"]
    assert rec["roofline"]["collective_bytes_per_device"] > 0


def test_skip_rules_emit_skip_records(records):
    rec = records[("hubert_xlarge", "decode_32k")]
    assert rec["status"] == "skip" and "encoder-only" in rec["reason"]


@pytest.mark.parametrize("arch,shape,dtype", [
    ("internlm2_1_8b", "train_4k", None),
    ("qwen2_moe_a2_7b", "train_4k", None),
    ("jamba_v0_1_52b", "long_500k", "serve"),
])
def test_per_device_parameter_bytes_are_the_rules(records, arch, shape,
                                                  dtype):
    """Each leaf's elements over the product of the mesh axes its spec
    names (the rules' specs divide their dims), at the cell's types:
    float32 masters to train, ``init_params``'s types to serve."""
    cfg = configs.get_config(arch)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    sizes = {"data": 2, "model": 4}
    total = 0
    for (path, leaf), (_, sh) in zip(T.items(abstract_params(cfg)),
                                     T.items(SH.param_shardings(cfg, mesh))):
        split = math.prod(sizes[a] for entry in sh.spec if entry
                          for a in (entry if isinstance(entry, tuple)
                                    else (entry,)))
        keys = tuple(k for k in path if isinstance(k, str))
        width = 4 if dtype is None or keeps_float32(keys) else 2
        total += leaf.numel() // split * width
    rec = records[(arch, shape)]
    assert rec["memory"]["argument_bytes_by_group"]["params"] == total


def test_kernel_ops_in_the_trace(records):
    """K6 twice per attention layer and microbatch in a train step (the
    forward and remat "nothing"'s recompute); K5 as often per MoE
    layer; once per layer in serving."""
    cfg = configs.get_config("internlm2_1_8b")
    rec = records[("internlm2_1_8b", "train_4k")]
    assert rec["kernel_calls"] == {"flash_attention":
                                   2 * 2 * cfg.num_layers}
    cfg = configs.get_config("qwen2_moe_a2_7b")
    calls = records[("qwen2_moe_a2_7b", "train_4k")]["kernel_calls"]
    assert calls == {"flash_attention": 4 * cfg.num_layers,
                     "moe_histogram": 4 * cfg.num_layers}
    cfg = configs.get_config("jamba_v0_1_52b")
    kinds = layer_kinds(cfg)
    calls = records[("jamba_v0_1_52b", "long_500k")]["kernel_calls"]
    assert calls == {
        "flash_attention": sum(m == "attn" for m, _, _ in kinds),
        "moe_histogram": sum(f == "moe" for _, f, _ in kinds)}


def test_fake_world_refuses_a_second_size():
    code = ("from repro_torch.launch.mesh import fake_world\n"
            "fake_world(8); fake_world(8)\n"
            "try:\n    fake_world(4)\nexcept RuntimeError as e:\n"
            "    print('refused', e)\n")
    res = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "refused" in res.stdout and "8 ranks" in res.stdout


def test_model_flops_and_active_params_equal_the_jax_package():
    from repro import configs as RC
    from repro.launch import roofline as RRL
    for arch in configs.ARCH_IDS:
        for kind in ("train", "decode"):
            assert (RL.model_flops(configs.get_config(arch), kind, 4096)
                    == RRL.model_flops(RC.get_config(arch), kind, 4096))
    assert RL.PEAK_FLOPS == 989e12 and RL.HBM_BW == 3.35e12
