"""The port's sharding (``repro_torch.distributed.sharding``, the serve
engine's ``cache_shardings``, ZeRO-1 ``opt_state_shardings``) against
the JAX package's, and the sharded path against the unsharded one.

Rules: every arch × mesh {2×4, 16×16, 2×16×16} × layout {tp, tp_zero3,
fsdp, dp}, leaf for leaf, both sides given a device-free
``jax.sharding.AbstractMesh`` (a ``shape`` dict and ``axis_names``): the
reference's stacked specs equal the port's ``stacked_param_shardings``,
and each of the port's per-layer specs is the stacked one without its
periods entry.

On a real 2×2 ("data", "model") mesh — four processes of a ``gloo``
group, ``tests/_torch_mesh_worker.py``, timeout 300 s — the dense, moe
and hybrid smoke configs' forward and prefill + decode, sharded, equal
the unsharded port (float32, 1e-5) and the JAX package (1e-4, the
bound of ``test_torch_models.py``); one train step with ZeRO-1 state
equals the unsharded step (1e-5); and a checkpoint written on one
device restores onto the mesh (elastic restore) whole and split.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.serve.engine as RE
import repro.train.optimizer as RO
from repro import configs as RC
from repro.distributed import sharding as RS
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.models.model import abstract_params as j_abstract
from repro_torch import checkpoint as CKPT
from repro_torch import configs as PC
from repro_torch import tree as T
from repro_torch.data import make_batch_iterator
from repro_torch.distributed import sharding as PS
from repro_torch.launch import mesh as PM
from repro_torch.models import from_jax_params, init_params
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.engine import cache_shardings
from repro_torch.train import opt_state_shardings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
LAYOUTS = ("tp", "tp_zero3", "fsdp", "dp")


def _mesh(shape, axes):
    return AbstractMesh(shape, axes)


def _ref_shardings(cfg, mesh, layout):
    if layout == "fsdp":
        return RS.param_shardings_fsdp(cfg, mesh)
    if layout == "dp":
        return RS.param_shardings_replicated(cfg, mesh)
    return RS.param_shardings(cfg, mesh, zero3=layout == "tp_zero3")


def _port_shardings(cfg, mesh, layout):
    if layout == "fsdp":
        return PS.param_shardings_fsdp(cfg, mesh)
    if layout == "dp":
        return PS.param_shardings_replicated(cfg, mesh)
    return PS.param_shardings(cfg, mesh, zero3=layout == "tp_zero3")


def _flat_ref(tree):
    """spec path → PartitionSpec tuple of a reference sharding tree."""
    return {tuple(k.key for k in path): tuple(ns.spec) for path, ns in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _padded(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def _check_per_layer(cfg, ref_flat, port_tree):
    """Each of the port's leaves (``layers[i]`` for a block leaf) holds
    the reference's stacked spec, without the periods entry."""
    n_pos = len(M.period_pattern(cfg))
    seen = 0
    for path, lf in L.spec_items(M.param_spec(cfg)):
        want = _padded(ref_flat[path], len(lf["shape"]))
        if path[0] != "blocks":
            node = port_tree
            for key in path:
                node = node[key]
            assert _padded(node.spec, len(lf["shape"])) == want, path
            seen += 1
            continue
        for period in range(lf["shape"][0]):
            node = port_tree["layers"][period * n_pos + int(path[1][3:])]
            for key in path[2:]:
                node = node[key]
            assert _padded(node.spec, len(lf["shape"]) - 1) == want[1:], \
                (path, period)
            assert node.stacked == lf["shape"][0]
            seen += 1
    assert seen == len(T.leaves(port_tree))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_shardings_equal_the_jax_package(arch):
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for shape, axes in MESHES:
        mesh = _mesh(shape, axes)
        rules_p, rules_r = PS.resolve_rules(mesh), RS.resolve_rules(mesh)
        assert rules_p == rules_r
        for path, lf in L.spec_items(M.param_spec(cfg)):
            assert (PS.spec_to_pspec(lf, mesh, rules_p)
                    == tuple(RS.spec_to_pspec(lf, mesh, rules_r))), path
        for layout in LAYOUTS:
            ref = _flat_ref(_ref_shardings(rcfg, mesh, layout))
            if layout in ("tp", "tp_zero3"):
                stacked = PS.stacked_param_shardings(
                    cfg, mesh, zero3=layout == "tp_zero3")
                assert {p: s.spec for p, s in stacked.items()} == ref
            _check_per_layer(cfg, ref, _port_shardings(cfg, mesh, layout))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_opt_state_shardings_equal_the_jax_package(arch):
    """ZeRO-1: m and v take the reference's spec (chosen on the stacked
    shape) without its periods entry; where the reference puts "data"
    on that entry the port's per-layer leaf keeps the parameter's
    spec."""
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for shape, axes in MESHES:
        mesh = _mesh(shape, axes)
        for zero1 in (True, False):
            ref = RO.opt_state_shardings(
                j_abstract(rcfg), RS.param_shardings(rcfg, mesh), mesh,
                zero1=zero1)
            port = opt_state_shardings(
                M.abstract_params(cfg), PS.param_shardings(cfg, mesh), mesh,
                zero1=zero1)
            assert port["count"].spec == tuple(ref["count"].spec) == ()
            # the reference adds "data" to one dim; on the periods entry
            # the rest of the spec is the parameter's, as the port keeps
            _check_per_layer(cfg, _flat_ref(ref["m"]), port["m"])
            assert port["m"] is port["v"]


def _ref_cache_in_port_layout(name, spec, ndim_ref):
    """A reference cache spec (periods, n, B, …) in the port's (layers,
    B, …) layout, K and V's (…, S, Hkv, Dh) as (…, Hkv, S, Dh)."""
    spec = _padded(spec, ndim_ref)
    assert spec[0] is None and spec[1] is None
    out = spec[2:]
    if name in ("kv_k", "kv_v"):
        out = (out[0], out[2], out[1], out[3])
    return (None,) + tuple(out)


@pytest.mark.parametrize("arch", [a for a in RC.ARCH_IDS
                                  if RC.get_config(a).has_decode])
def test_cache_shardings_equal_the_jax_package(arch):
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for shape, axes in MESHES:
        mesh = _mesh(shape, axes)
        for batch, seq in ((128, 32_768), (1, 524_288)):
            ref = RE.cache_shardings(rcfg, mesh, batch, seq)
            port = cache_shardings(cfg, mesh, batch, seq)
            shapes = dict(M.cache_spec(cfg, batch, seq))
            assert set(port) == set(ref) - {"offset"}
            for name, ns in port.items():
                n_ref = len(shapes[name][0]) + 1
                assert (_padded(ns.spec, n_ref - 1) ==
                        _ref_cache_in_port_layout(name, tuple(ref[name].spec),
                                                  n_ref)), (name, batch)


def test_placements_and_mesh_helpers():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
    assert PM.mesh_shape(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert PM.data_parallel_size(mesh) == 32
    assert PS.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert PS.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="twice"):
        PS.placements(("model", "model"), mesh)
    assert PM.parse_mesh_shape("2x4") == ((2, 4), ("data", "model"))
    assert PM.parse_mesh_shape("2x2x2")[1] == ("pod", "data", "model")
    with pytest.raises(ValueError):
        PM.parse_mesh_shape("8")
    x = torch.ones(4, 8)     # a plain tensor passes a constraint untouched
    assert PS.make_constraint(mesh)(x, ("batch", "embed")) is x


# ---------------------------------------------------------------------------
# The 2×2 mesh: four gloo processes
# ---------------------------------------------------------------------------

ARCHS = ("internlm2_1_8b", "qwen2_moe_a2_7b", "jamba_v0_1_52b")
B, PROMPT, DECODES, MAX_SEQ, SEQ = 4, 8, 2, 12, 10
KEY = jax.random.PRNGKey(0)


def _f32(arch, ref=False):
    return dataclasses.replace((RC if ref else PC).get_smoke_config(arch),
                               dtype="float32")


@pytest.fixture(scope="module")
def mesh_run():
    """Write the inputs, run the four ranks, return their results and
    the JAX parameters."""
    with tempfile.TemporaryDirectory() as d:
        jparams = {}
        for arch in ARCHS:
            jp = j_init(_f32(arch, ref=True), KEY)
            jparams[arch] = jp
            torch.save(from_jax_params(_f32(arch), jax.tree.map(np.asarray,
                                                                jp),
                                       device="cpu", dtype=torch.float32),
                       os.path.join(d, f"{arch}.pt"))
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, 128, (B, SEQ)).astype(np.int32)
        np.save(os.path.join(d, "tokens.npy"), tokens)
        cfg = _f32("internlm2_1_8b")
        batch = next(make_batch_iterator(cfg, B, 16, seed=0))
        torch.save({k: torch.from_numpy(v) for k, v in batch.items()},
                   os.path.join(d, "train_batch.pt"))
        ckpt_params = init_params(cfg, 3, device="cpu", dtype=torch.float32)
        CKPT.save(os.path.join(d, "ckpt"), 1, params=ckpt_params, cfg=cfg)
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_mesh_worker.py"), d],
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        out = torch.load(os.path.join(d, "out.pt"), weights_only=False)
    return out, jparams, tokens, ckpt_params


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_equals_unsharded_and_jax(mesh_run, arch):
    out, jparams, tokens, _ = mesh_run
    got = out[arch]
    np.testing.assert_allclose(_np(got["forward"]), _np(got["forward_plain"]),
                               atol=1e-5, rtol=1e-5)
    want, _ = j_forward(jparams[arch], _f32(arch, ref=True),
                        token_ids=tokens)
    np.testing.assert_allclose(_np(got["forward"]), np.asarray(want),
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_equals_unsharded_and_jax(mesh_run, arch):
    """Prefill and two teacher-forced decode steps on the sharded cache
    (``cache_shardings``)."""
    out, jparams, tokens, _ = mesh_run
    got = out[arch]
    for a, b in zip(got["serve"], got["serve_plain"]):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)
    rcfg = _f32(arch, ref=True)
    logits, cache, _ = j_prefill(jparams[arch], rcfg,
                                 token_ids=tokens[:, :PROMPT],
                                 max_seq=MAX_SEQ)
    want = [logits]
    for i in range(DECODES):
        logits, cache, _ = j_decode(jparams[arch], rcfg, cache,
                                    tokens[:, PROMPT + i:PROMPT + i + 1])
        want.append(logits)
    for a, w in zip(got["serve"], want):
        np.testing.assert_allclose(_np(a), np.asarray(w), atol=1e-4)


def test_sharded_train_step_equals_unsharded(mesh_run):
    """One AdamW step of the dense smoke config with ZeRO-1 m and v: the
    loss and every updated parameter as the unsharded step's."""
    train = mesh_run[0]["train"]
    np.testing.assert_allclose(float(train["loss"]),
                               float(train["plain_loss"]), rtol=1e-5)
    for (path, a), b in zip(T.items(train["params"]),
                            T.leaves(train["plain_params"])):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5,
                                   err_msg=str(path))
    assert any("Shard" in p for p in train["m_placements"])


def test_elastic_restore_onto_a_2x2_mesh(mesh_run):
    """A checkpoint written on one device restores onto the 2×2 mesh:
    each rank holds its piece and the whole equals what was written."""
    out, _, _, written = mesh_run
    got = out["restore"]
    for a, b in zip(T.leaves(got["params"]), T.leaves(written)):
        assert torch.equal(a, b)
    assert got["w_up_local"] != got["w_up_global"]
    assert "Shard" in got["placements"]
    assert got["manifest"]["mesh"] is None


def test_checkpoint_records_the_mesh():
    """``save(mesh=…)`` writes the mesh's axes and sizes, as the
    reference's manifest has them."""
    cfg = PC.get_smoke_config("internlm2_1_8b")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    mesh = _mesh((2, 4), ("data", "model"))
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, 1, params=params, cfg=cfg, mesh=mesh)
        _, _, manifest = CKPT.restore(d, 1,
                                      abstract_params=M.abstract_params(cfg),
                                      cfg=cfg, device="cpu")
    assert manifest["mesh"] == [["data", 2], ["model", 4]]


RECOMPUTE = r"""
import torch, torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.data import make_batch_iterator
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params, layers as L, moe as MOE
from repro_torch.train import make_grad_fn
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
cfg = configs.get_smoke_config("qwen2_moe_a2_7b")
calls = {"k5": 0, "k6": 0}
k5, k6 = MOE.moe_histogram, L.flash_attention
def spy5(*a, **kw):
    calls["k5"] += 1
    return k5(*a, **kw)
def spy6(*a, **kw):
    calls["k6"] += 1
    return k6(*a, **kw)
MOE.moe_histogram, L.flash_attention = spy5, spy6
params = SH.shard_params(init_params(cfg, 0, device="cpu",
                                     dtype=torch.float32),
                         SH.param_shardings(cfg, mesh))
batch = {k: SH.shard_tensor(torch.from_numpy(v),
                            SH.batch_sharding(mesh, v.ndim))
         for k, v in next(make_batch_iterator(cfg, 2, 64, seed=0)).items()}
with implicit_replication():
    make_grad_fn(cfg, "dots_no_batch", SH.make_constraint(mesh))(params,
                                                                 batch)
print("CALLS", calls["k5"], calls["k6"], cfg.num_layers)
"""


def test_selective_remat_recomputes_once_on_a_one_device_mesh():
    """``dots_no_batch`` on DTensors (a (1, 1) mesh): K5 and K6 run twice
    a block, forward and recompute, as on plain tensors
    (``test_torch_train.py``) — DTensor's decomposition saves no other
    product."""
    res = subprocess.run([sys.executable, "-c", RECOMPUTE],
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(ROOT, "src")},
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    k5, k6, layers = map(int, res.stdout.split("CALLS")[1].split())
    assert k5 == k6 == 2 * layers
