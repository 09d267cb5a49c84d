"""The dry run of the recurrent families with their scans as ops
(``models/scan_ops.py``), on a 2×4 mesh of a fake process group, in a
subprocess (a process has one default group).

jamba × prefill_32k and xlstm × train_4k — 32 768- and 4096-step scans,
which did not trace as loops of fake DTensor ops — give status ok,
per-device parameter bytes equal to the sharding rules' arithmetic and
their K5/K6 op calls; each scan op is one call a layer (its backward one
more in training).  xlstm × long_500k, a recurrent cell that traced
before the ops, keeps the traced FLOPs of everything but its scans
(1700560896, the products ``aten.mm`` counted then), and its scans count
their FLOP formula at the local shapes its rules give them.  (The scans'
own share moved: the loops' per-step einsums were placed by DTensor op
by op.)"""
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
from repro_torch.models import abstract_params, scan_ops
from repro_torch.models.model import keeps_float32, layer_kinds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
CELLS = [("jamba_v0_1_52b", "prefill_32k"), ("xlstm_1_3b", "train_4k"),
         ("xlstm_1_3b", "long_500k")]
# the traced FLOPs of xlstm × long_500k at 2×4 outside its scans, as the
# dry run counted them with the scans as loops
XLSTM_LONG_MM_FLOPS = 1700560896
BATCH = r"""
import collections, json, os, sys
from repro_torch.launch import specs
from repro_torch.launch.dryrun import run_one
by_op = collections.Counter()
calls = collections.Counter()
count = specs.TraceCounters.__torch_dispatch__

def split(self, func, types, args=(), kwargs=None):
    before = self.flops
    out = count(self, func, types, args, kwargs)
    if self.flops != before:
        by_op[str(func)] += self.flops - before
    if (out is not NotImplemented and "scan" in str(func)
            and len(self.fake_mode.enter_stack) == 1):
        calls[str(func)] += 1
    return out

specs.TraceCounters.__torch_dispatch__ = split
out = sys.argv[1]
for arch, shape in json.loads(sys.argv[2]):
    by_op.clear(); calls.clear()
    run_one(arch, shape, multi_pod=False, out_dir=out,
            mesh_dims=((2, 4), ("data", "model")))
    with open(os.path.join(out, f"{arch}__{shape}__ops.json"), "w") as f:
        json.dump({"flops": by_op, "calls": calls}, f)
"""


@pytest.fixture(scope="module")
def records():
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run(
            [sys.executable, "-c", BATCH, d, json.dumps(CELLS)], env=ENV,
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        out = {}
        for arch, shape in CELLS:
            with open(os.path.join(d, f"{arch}__{shape}__2x4.json")) as f:
                rec = json.load(f)
            with open(os.path.join(d, f"{arch}__{shape}__ops.json")) as f:
                rec["by_op"] = json.load(f)
            out[(arch, shape)] = rec
        return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_recurrent_cells_trace(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["traced_flops_per_device"] > 0
    assert 0 < rec["model"]["useful_fraction"] <= 1.5


@pytest.mark.parametrize("arch,shape,dtype", [
    ("jamba_v0_1_52b", "prefill_32k", "serve"),
    ("xlstm_1_3b", "train_4k", None),
])
def test_per_device_parameter_bytes_are_the_rules(records, arch, shape,
                                                  dtype):
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


def _mixers(arch):
    return [m for m, _, _ in layer_kinds(configs.get_config(arch))]


def test_kernel_and_scan_ops_in_the_trace(records):
    """jamba's prefill: K6 once per attention layer, K5 once per MoE
    layer, the Mamba scan op once per Mamba layer.  xlstm's train step
    (two microbatches, remat "nothing"): each scan op runs in the
    forward and in the recompute, its backward op once, per layer and
    microbatch; no K5 or K6."""
    kinds = layer_kinds(configs.get_config("jamba_v0_1_52b"))
    rec = records[("jamba_v0_1_52b", "prefill_32k")]
    assert rec["kernel_calls"] == {
        "flash_attention": sum(m == "attn" for m, _, _ in kinds),
        "moe_histogram": sum(f == "moe" for _, f, _ in kinds)}
    assert rec["by_op"]["calls"] == {
        "repro_torch.mamba_scan.default": _mixers("jamba_v0_1_52b")
        .count("mamba")}
    rec = records[("xlstm_1_3b", "train_4k")]
    assert rec["kernel_calls"] == {}
    mixers = _mixers("xlstm_1_3b")
    want = {}
    for kind in ("mlstm", "slstm"):
        n = mixers.count(kind) * rec["microbatches"]
        want[f"repro_torch.{kind}_scan.default"] = 2 * n
        want[f"repro_torch.{kind}_scan_backward.default"] = n
    assert rec["by_op"]["calls"] == want


def test_a_cell_that_traced_before_keeps_its_traced_flops(records):
    cfg = configs.get_config("xlstm_1_3b")
    rec = records[("xlstm_1_3b", "long_500k")]
    flops = rec["by_op"]["flops"]
    assert flops["aten.mm.default"] == XLSTM_LONG_MM_FLOPS
    # one decode step of batch 1; heads split over "model" (4), the
    # batch row on data rank 0
    h = cfg.num_heads // 4
    x = cfg.xlstm
    up = int(cfg.d_model * x.proj_factor)
    dk, dv = int(up * x.qk_dim_factor) // cfg.num_heads, up // cfg.num_heads
    d, dh = cfg.d_model // 4, cfg.d_model // cfg.num_heads
    mixers = _mixers("xlstm_1_3b")
    mlstm = scan_ops.OPS["mlstm_scan"].flops(
        (1, 1, h, dk), (1, 1, h, dk), (1, 1, h, dv), (1, 1, h), (1, 1, h),
        (1, h, dk, dv), (1, h, dk), (1, h))
    slstm = scan_ops.OPS["slstm_scan"].flops(
        *[(1, 1, d)] * 4, *[(h, dh, dh)] * 4, *[(1, d)] * 4)
    assert flops["repro_torch.mlstm_scan.default"] == \
        mixers.count("mlstm") * mlstm
    assert flops["repro_torch.slstm_scan.default"] == \
        mixers.count("slstm") * slstm
    assert sum(flops.values()) == rec["roofline"]["traced_flops_per_device"]
