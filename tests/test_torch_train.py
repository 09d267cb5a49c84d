"""Training on the PyTorch port against the JAX package, on the CPU.

The same inputs, made from a seed with NumPy, go through both packages:
the loss (1e-4; MoE expert counts exact) and its gradient leaf by leaf
(rtol 1e-3, atol 1e-5) from the same float32 master weights, one AdamW
step, the attention gradient of the reference's XLA attention and of
K6's autograd path, the training loop (loss falls, microbatching,
resume), checkpoints crossing packages in both directions, the launcher
and ``launch.analytic`` (all ten configs).  The JAX side runs as the JAX package's own
tests run it."""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RCK
import repro.models.layers as RL
import repro.models.model as RM
import repro.train as RT
from repro import configs as RC
from repro.launch.analytic import analytic_cost as ref_analytic_cost
from repro_torch import checkpoint as CKPT
from repro_torch import configs as PC
from repro_torch import tree as T
from repro_torch.data import make_batch_iterator
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.launch.analytic import analytic_cost
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import (abstract_params, from_jax_layout,
                                from_jax_params, init_params, to_jax_layout)
from repro_torch.train import (AdamWConfig, abstract_opt_state,
                               adamw_update, init_opt_state, make_grad_fn,
                               make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2_1_8b", "qwen2_moe_a2_7b")


def _configs(arch, **over):
    """The float32 smoke config of ``arch`` in both packages."""
    ref = dataclasses.replace(RC.get_smoke_config(arch), dtype="float32",
                              **over)
    port = dataclasses.replace(PC.get_smoke_config(arch), dtype="float32",
                               **over)
    return ref, port


def _moe_over(capacity_factor):
    """Overrides of the qwen2-moe smoke config's MoE capacity factor."""
    ref = RC.get_smoke_config("qwen2_moe_a2_7b").moe
    port = PC.get_smoke_config("qwen2_moe_a2_7b").moe
    return (dataclasses.replace(ref, capacity_factor=capacity_factor),
            dataclasses.replace(port, capacity_factor=capacity_factor))


def _same_weights(ref_cfg, port_cfg, seed=0):
    rp = RM.init_params(ref_cfg, jax.random.PRNGKey(seed))
    pp = from_jax_params(port_cfg, jax.tree.map(np.asarray, rp),
                         device="cpu", dtype=torch.float32)
    return rp, pp


def _batch(cfg, batch, seq, seed=0):
    b = next(make_batch_iterator(cfg, batch, seq, seed=seed))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _ref_tree_of(port_cfg, tree):
    """A port model tree of tensors in the reference's layout, as
    NumPy arrays."""
    return jax.tree.map(lambda t: t.detach().numpy(),
                        to_jax_layout(port_cfg, tree))


def _assert_tree_close(ref_tree, port_ref_tree, rtol, atol):
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert len(flat) == len(jax.tree.leaves(port_ref_tree))
    for path, a in flat:
        b = port_ref_tree
        for key in path:
            b = b[key.key]
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# Loss and gradient parity
# ---------------------------------------------------------------------------

LOSS_CASES = [("internlm2_1_8b", 64, None), ("qwen2_moe_a2_7b", 64, None),
              # past SDPA_DIRECT_MAX: the reference's chunked attention,
              # and three CE chunks
              ("internlm2_1_8b", 1536, None),
              # an MoE capacity that drops slots, both directions
              ("qwen2_moe_a2_7b", 64, 0.5),
              # the recurrent families at two 256-step segments: each
              # segment of segmented_scan checkpointed inside the
              # block's own checkpoint
              ("jamba_v0_1_52b", 512, None), ("xlstm_1_3b", 512, None)]


@pytest.mark.parametrize("arch,seq,capacity", LOSS_CASES)
def test_loss_and_gradients_match_the_jax_package(arch, seq, capacity):
    ref_cfg, port_cfg = _configs(arch)
    if capacity is not None:
        rm, pm = _moe_over(capacity)
        ref_cfg = dataclasses.replace(ref_cfg, moe=rm)
        port_cfg = dataclasses.replace(port_cfg, moe=pm)
    rp, pp = _same_weights(ref_cfg, port_cfg)
    rb, pb = _batch(port_cfg, 2, seq)
    (rl, raux), rg = jax.value_and_grad(
        lambda p: RM.loss_fn(p, ref_cfg, rb, remat="dots_no_batch"),
        has_aux=True)(rp)
    (pl, paux), pg = make_grad_fn(port_cfg)(pp, pb)
    assert abs(float(pl) - float(rl)) < 1e-4
    np.testing.assert_array_equal(paux["expert_counts"].numpy(),
                                  np.asarray(raux["expert_counts"]))
    _assert_tree_close(rg, _ref_tree_of(port_cfg, pg), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("remat", ["none", "dots", "dots_no_batch",
                                   "nothing", "everything"])
def test_every_remat_policy_gives_the_same_gradient(remat):
    """Checkpointing changes what is kept, not what is computed: each
    policy's loss and gradients equal the unchecked ones (MoE, so the
    batched expert products meet ``dots``)."""
    _, cfg = _configs("qwen2_moe_a2_7b")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    _, batch = _batch(cfg, 2, 64)
    (l0, _), g0 = make_grad_fn(cfg, remat=None)(params, batch)
    (l1, _), g1 = make_grad_fn(cfg, remat=remat)(params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(T.leaves(g0), T.leaves(g1)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_remat_recomputes_k5_and_attention_once_per_block(monkeypatch):
    """Under ``dots_no_batch`` each block's K5 and K6 calls run twice a
    step, in the forward and in the backward's recompute — the counts
    ``chip_smoke.py`` expects on the card — and nothing differentiable
    reads K5: its gates arrive detached and its counts carry no
    gradient."""
    _, cfg = _configs("qwen2_moe_a2_7b")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    _, batch = _batch(cfg, 2, 64)
    calls = {"k5": 0, "k6": 0, "gates_grad": False, "counts_grad": False}
    k5, k6 = MOE.moe_histogram, L.flash_attention

    def spy_k5(idx, gates, *, num_experts):
        calls["k5"] += 1
        calls["gates_grad"] |= gates.requires_grad
        out = k5(idx, gates, num_experts=num_experts)
        calls["counts_grad"] |= out[0].requires_grad
        return out

    def spy_k6(*a, **kw):
        calls["k6"] += 1
        return k6(*a, **kw)

    monkeypatch.setattr(MOE, "moe_histogram", spy_k5)
    monkeypatch.setattr(L, "flash_attention", spy_k6)
    make_grad_fn(cfg, remat="dots_no_batch")(params, batch)
    assert calls["k5"] == calls["k6"] == 2 * cfg.num_layers
    assert not calls["gates_grad"] and not calls["counts_grad"]


# ---------------------------------------------------------------------------
# Attention: the reference's XLA attention, its gradient, K6 under autograd
# ---------------------------------------------------------------------------

ATTN_CASES = [  # B, S, H, Hkv, D, window
    (2, 1536, 4, 2, 16, None),      # GQA, chunked
    (1, 1536, 4, 4, 16, 300),       # a sliding window, chunked
    (2, 1000, 4, 2, 16, None),      # off a chunk multiple: direct
    (2, 256, 4, 1, 32, 64),         # GQA to one kv head, windowed, direct
]


def _attn_inputs(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, s, h, d), (b, s, hkv, d),
                                (b, s, hkv, d), (b, s, h, d)))
    return q, k, v, g


def _ref_attention_grads(q, k, v, g, window):
    def f(q, k, v):
        o = RL._sdpa(q, k, v, causal=True, window=window, q_offset=0)
        return jnp.sum(o * g)
    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("b,s,h,hkv,d,window", ATTN_CASES)
def test_attention_twins_and_their_gradients_match_jax(b, s, h, hkv, d,
                                                       window):
    q, k, v, g = _attn_inputs(b, s, h, hkv, d)
    kw = dict(causal=True, window=window, q_offset=0)
    want_o = np.asarray(RL._sdpa(q, k, v, **kw))
    want = _ref_attention_grads(q, k, v, g, window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    direct = s <= L.SDPA_DIRECT_MAX or s % L.SDPA_CHUNK
    fn = L._sdpa_direct if direct else L._sdpa_chunked
    o = fn(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.detach().numpy(), want_o, rtol=1e-5,
                               atol=1e-5)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    via = L.sdpa_grad(*(torch.from_numpy(x) for x in (q, k, v, g)), **kw)
    for a, c, w in zip(got, via, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(c.numpy(), w, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("b,s,h,hkv,d,window", ATTN_CASES[::2])
def test_flash_attention_fn_backward_on_the_cpu(b, s, h, hkv, d, window):
    """K6's autograd path with the plain forward injected in place of the
    kernel: its output is the plain version's and its gradient the
    reference's, in K6's (B, H, S, D) layout."""
    q, k, v, g = _attn_inputs(b, s, h, hkv, d, seed=1)
    want = _ref_attention_grads(q, k, v, g, window)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    o = FlashAttentionFn.apply(tq, tk, tv, True, window, 0, attention_ref)
    torch.testing.assert_close(
        o, attention_ref(tq, tk, tv, causal=True, window=window))
    got = torch.autograd.grad(o, (tq, tk, tv),
                              torch.from_numpy(g).transpose(1, 2))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.transpose(1, 2).numpy(), w, rtol=1e-3,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_one_adamw_step_matches_the_jax_package():
    """From the same params, gradients and state (two steps in, so bias
    correction and warm-up both act): grad norm and lr within float32
    rounding (rtol 1e-6), m and v within 1e-5 relative or 1e-9 absolute
    (m's two terms nearly cancel on a few entries, where the clip
    scale's last bit shows; max |m| is about 1e-3), count exact; the
    params after the step within 1e-6 absolute (the 1/sqrt(v̂) normalizer
    amplifies ulp-level differences, tests/test_train.py:55-57)."""
    ref_cfg, port_cfg = _configs("internlm2_1_8b")
    rp, pp = _same_weights(ref_cfg, port_cfg)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 0.3, rp) for _ in range(2)]
    oc = AdamWConfig(lr=1e-2, warmup_steps=4, total_steps=10)
    roc = RT.AdamWConfig(lr=1e-2, warmup_steps=4, total_steps=10)
    r_state, p_state = RT.init_opt_state(rp), init_opt_state(pp)
    for g in grads:
        rp, r_state, rm = RT.adamw_update(roc, rp, g, r_state)
        pg = from_jax_layout(port_cfg, jax.tree.map(torch.from_numpy, g))
        pp, p_state, pmet = adamw_update(oc, pp, pg, p_state)
        np.testing.assert_allclose(float(pmet["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pmet["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(p_state["count"]) == int(r_state["count"]) == 2
    assert p_state["count"].dtype == torch.int32
    for name in ("m", "v"):
        _assert_tree_close(r_state[name],
                           _ref_tree_of(port_cfg, p_state[name]),
                           rtol=1e-5, atol=1e-9)
    _assert_tree_close(rp, _ref_tree_of(port_cfg, pp), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The training loop (twins of tests/test_train.py)
# ---------------------------------------------------------------------------

def _train(cfg, steps=40, microbatches=1, seed=0):
    params = init_params(cfg, seed, device="cpu", dtype=torch.float32)
    opt = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=5,
                                            total_steps=steps),
                           microbatches=microbatches)
    it = make_batch_iterator(cfg, batch=8, seq=64, seed=seed)
    losses = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return params, opt, losses


def test_loss_decreases_dense():
    _, _, losses = _train(PC.get_smoke_config("internlm2_1_8b"))
    assert losses[-1] < losses[0] - 0.5


def test_loss_decreases_moe():
    _, _, losses = _train(PC.get_smoke_config("qwen2_moe_a2_7b"), steps=30)
    assert losses[-1] < losses[0] - 0.3


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatching_matches_full_batch(arch):
    """Dense: loss and gradient norm as tests/test_train.py holds them.
    MoE: the expert counts are summed over the microbatches exactly; its
    loss is not compared, since the load-balancing loss of a batch is not
    the mean of its halves' (the same holds in the JAX package)."""
    cfg = PC.get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    opt = init_opt_state(params)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=1e9)
    s1 = make_train_step(cfg, oc, microbatches=1)
    s2 = make_train_step(cfg, oc, microbatches=2)
    it = make_batch_iterator(cfg, batch=8, seq=64, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
    _, _, m1 = s1(T.map(torch.clone, params), T.map(torch.clone, opt), batch)
    _, _, m2 = s2(params, opt, batch)
    if cfg.moe is not None:
        assert torch.equal(m1["expert_counts"], m2["expert_counts"])
        assert float(m2["expert_counts"].sum()) == 8 * 64 * cfg.moe.top_k \
            * cfg.num_layers
        return
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-3)


def test_train_step_updates_the_trees_in_place():
    """The step updates the float32 masters and the optimizer state in
    place, as the reference's launcher donates both trees: it returns
    the tensors it was given, changed."""
    cfg = PC.get_smoke_config("internlm2_1_8b")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    opt = init_opt_state(params)
    before = [t.clone() for t in T.leaves(params)]
    step = make_train_step(cfg, AdamWConfig())
    _, b = _batch(cfg, 2, 32)
    new, new_opt, _ = step(params, opt, b)
    assert all(a is c for a, c in zip(T.leaves(new), T.leaves(params)))
    for buf in ("m", "v"):
        assert all(a is c for a, c in zip(T.leaves(new_opt[buf]),
                                          T.leaves(opt[buf])))
    assert int(new_opt["count"]) == 1
    assert not all(torch.equal(a, c)
                   for a, c in zip(before, T.leaves(new)))


def test_checkpoint_restart_resumes_identically():
    """Restored params and state are bit-identical, and the next step
    from them gives the continuous run's loss and parameters exactly."""
    cfg = PC.get_smoke_config("internlm2_1_8b")
    params, opt, _ = _train(cfg, steps=10)
    oc = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=20)
    _, batch = _batch(cfg, 8, 64, seed=9)
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, 10, params=params, opt_state=opt, config_name=cfg.name,
                  cfg=cfg)
        assert CKPT.latest_step(d) == 10
        aps = abstract_params(cfg)
        p2, o2, man = CKPT.restore(d, 10, abstract_params=aps,
                                   abstract_opt=abstract_opt_state(aps),
                                   cfg=cfg, device="cpu")
    assert man["config"] == cfg.name
    for a, b in zip(T.leaves((params, opt)), T.leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(o2["count"]) == int(opt["count"]) == 10
    step = make_train_step(cfg, oc)
    p1, _, m1 = step(params, opt, batch)
    p2, _, m2 = step(p2, o2, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(p1),
                                                 T.leaves(p2)))


def test_uncommitted_checkpoints_ignored():
    cfg = PC.get_smoke_config("internlm2_1_8b")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, 5, params=params, cfg=cfg)
        os.makedirs(os.path.join(d, "step_00000009"))  # torn write
        assert CKPT.latest_step(d) == 5


SHARDED_CKPT = r"""
import sys, tempfile, torch, torch.distributed as dist
from repro_torch import checkpoint as CKPT, configs, tree as T
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import abstract_params, init_params
from repro_torch.train import (abstract_opt_state, init_opt_state,
                               opt_state_shardings)
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
cfg = configs.get_smoke_config("internlm2_1_8b")
params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
opt = init_opt_state(params)
p_sh = SH.param_shardings(cfg, mesh)
o_sh = opt_state_shardings(params, p_sh, mesh)
with tempfile.TemporaryDirectory() as d:
    CKPT.save(d, 1, params=SH.shard_params(params, p_sh),
              opt_state=SH.shard_params(opt, o_sh), cfg=cfg, mesh=mesh)
    aps = abstract_params(cfg)
    got, got_opt, manifest = CKPT.restore(
        d, 1, abstract_params=aps, abstract_opt=abstract_opt_state(aps),
        cfg=cfg, device="cpu", param_shardings=p_sh, opt_shardings=o_sh)
assert manifest["mesh"] == [["data", 1], ["model", 1]], manifest["mesh"]
for (path, a), b, sh in zip(T.items(got), T.leaves(params), T.leaves(p_sh)):
    assert tuple(a.placements) == sh.placements, path
    assert torch.equal(a.full_tensor(), b), path
assert all(torch.equal(a.full_tensor(), b) for a, b in
           zip(T.leaves(got_opt["m"]), T.leaves(opt["m"])))
print("OK")
"""


def test_sharded_checkpoints_are_not_ported():
    """(The name is the item-9e refusal pin's; meshes are now ported.)
    ``save(mesh=…)`` writes the mesh into the manifest, DTensor leaves
    whole; ``restore(param_shardings=…, opt_shardings=…)`` returns each
    leaf as a DTensor placed by its sharding (a (1, 1) mesh of a
    one-rank gloo group, in a child: a process has one default group)."""
    res = _run([sys.executable, "-c", SHARDED_CKPT], timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, (
        res.stdout[-2000:] + res.stderr[-2000:])


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def _ref_loss(cfg, params, batch):
    return float(RM.loss_fn(params, cfg, batch)[0])


def _port_loss(cfg, params, batch):
    with torch.no_grad():
        return float(M.loss_fn(params, cfg, batch)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_jax_checkpoint_restores_into_the_port(arch):
    ref_cfg, port_cfg = _configs(arch)
    rp = RM.init_params(ref_cfg, jax.random.PRNGKey(1))
    step = jax.jit(RT.make_train_step(ref_cfg, RT.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=4)))
    ro = RT.init_opt_state(rp)
    rb, pb = _batch(port_cfg, 4, 32, seed=2)
    for _ in range(2):
        rp, ro, _ = step(rp, ro, rb)
    rb2, pb2 = _batch(port_cfg, 4, 32, seed=3)
    with tempfile.TemporaryDirectory() as d:
        RCK.save(d, 2, params=rp, opt_state=ro, config_name=ref_cfg.name)
        aps = abstract_params(port_cfg)
        pp, po, man = CKPT.restore(d, 2, abstract_params=aps,
                                   abstract_opt=abstract_opt_state(aps),
                                   cfg=port_cfg, device="cpu")
    assert man["config"] == ref_cfg.name and int(po["count"]) == 2
    _assert_tree_close(rp, _ref_tree_of(port_cfg, pp), rtol=0, atol=0)
    for name in ("m", "v"):
        _assert_tree_close(ro[name], _ref_tree_of(port_cfg, po[name]),
                           rtol=0, atol=0)
    assert abs(_port_loss(port_cfg, pp, pb2)
               - _ref_loss(ref_cfg, rp, rb2)) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_a_port_checkpoint_restores_into_the_jax_package(arch):
    ref_cfg, port_cfg = _configs(arch)
    params = init_params(port_cfg, 1, device="cpu", dtype=torch.float32)
    opt = init_opt_state(params)
    step = make_train_step(port_cfg, AdamWConfig(lr=1e-2, warmup_steps=1,
                                                 total_steps=4))
    _, pb = _batch(port_cfg, 4, 32, seed=2)
    for _ in range(2):
        params, opt, _ = step(params, opt, pb)
    rb2, pb2 = _batch(port_cfg, 4, 32, seed=3)
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, 2, params=params, opt_state=opt,
                  config_name=port_cfg.name, cfg=port_cfg)
        aps = RM.abstract_params(ref_cfg)
        rp, ro, man = RCK.restore(d, 2, abstract_params=aps,
                                  abstract_opt=RT.abstract_opt_state(aps))
    assert man["config"] == port_cfg.name and int(ro["count"]) == 2
    _assert_tree_close(rp, _ref_tree_of(port_cfg, params), rtol=0, atol=0)
    for name in ("m", "v"):
        _assert_tree_close(ro[name], _ref_tree_of(port_cfg, opt[name]),
                           rtol=0, atol=0)
    rp = jax.tree.map(jnp.asarray, rp)
    assert abs(_port_loss(port_cfg, params, pb2)
               - _ref_loss(ref_cfg, rp, rb2)) < 1e-4


def test_layouts_round_trip():
    _, cfg = _configs("qwen2_moe_a2_7b")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    back = from_jax_layout(cfg, to_jax_layout(cfg, params))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params),
                                                 T.leaves(back)))
    meta = abstract_params(cfg)
    assert [(t.shape, t.dtype) for t in T.leaves(meta)] == \
        [(t.shape, t.dtype) for t in T.leaves(params)]
    assert all(t.device.type == "meta" for t in T.leaves(meta))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}


def _run(cmd, timeout=420):
    return subprocess.run(cmd, env=ENV, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)


def test_train_launcher_smoke_and_resume():
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "internlm2_1_8b", "--smoke", "--batch", "4", "--seq", "32",
            "--device", "cpu"]
    with tempfile.TemporaryDirectory() as d:
        res = _run(base + ["--steps", "12", "--ckpt-dir", d,
                           "--ckpt-every", "8"])
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        assert "final checkpoint" in res.stdout
        assert "[train] step    11 loss=" in res.stdout
        res = _run(base + ["--steps", "14", "--ckpt-dir", d, "--resume"])
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        assert "resumed from step 12" in res.stdout


def test_train_launcher_refuses_a_mesh_and_needs_a_card():
    """(The name is the item-9e refusal pin's.)  ``--mesh-shape 2x4``
    without eight ranks is refused, naming WORLD_SIZE;
    ``--mesh-shape 1x1`` trains in one process, its losses those of the
    run without a mesh; no card and no ``--device cpu`` fails."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--batch", "4", "--seq", "32"]
    env = {k: v for k, v in ENV.items() if k != "WORLD_SIZE"}
    res = subprocess.run(base + ["--steps", "1", "--mesh-shape", "2x4",
                                 "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=420,
                         cwd=ROOT)
    assert res.returncode != 0
    assert "WORLD_SIZE is 1" in res.stderr and "8 ranks" in res.stderr
    runs = [_run(base + ["--steps", "3", "--device", "cpu"] + mesh)
            for mesh in ([], ["--mesh-shape", "1x1"])]
    for res in runs:
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "mesh=1x1" in runs[1].stdout

    def losses(out):
        return [line.split("loss=")[1].split()[0] for line in
                out.splitlines() if "loss=" in line]
    assert losses(runs[0].stdout) == losses(runs[1].stdout)
    if not torch.cuda.is_available():
        res = _run(base + ["--steps", "1"])
        assert res.returncode != 0 and "no CUDA card" in res.stderr


# ---------------------------------------------------------------------------
# launch.analytic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_analytic_cost_equals_the_jax_package(arch):
    for kind in ("train", "prefill", "decode"):
        for remat in ("nothing", "dots_no_batch"):
            assert analytic_cost(PC.get_config(arch), kind, 4, 2048,
                                 remat=remat) == ref_analytic_cost(
                RC.get_config(arch), kind, 4, 2048, remat=remat)


def test_trainer_balances_experts_as_the_reference_launcher_does():
    """The trainer builds ExpertBalancer(E, min(8, E)), as the JAX
    launcher does: it balances eight experts over eight shards, and like
    the reference's it asserts where eight does not divide E (qwen2-moe-
    a2.7b's E = 60; ROADMAP F7)."""
    import dataclasses
    from repro.distributed import ExpertBalancer as RefBalancer
    from repro_torch.launch.train import Trainer
    cfg = PC.get_smoke_config("qwen2_moe_a2_7b")
    run = Trainer(cfg, batch=2, seq=16, steps=1, device="cpu")
    try:
        assert run.balancer.num_shards == min(8, cfg.moe.num_experts) == 8
    finally:
        run.close()
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            num_experts=60))
    with pytest.raises(AssertionError):
        RefBalancer(60, min(8, 60))
    with pytest.raises(AssertionError):
        Trainer(wide, batch=2, seq=16, steps=1, device="cpu")
