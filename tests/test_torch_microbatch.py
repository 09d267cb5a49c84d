"""Microbatched training on the port against the JAX package, on the CPU.

A microbatched step splits the batch into the reference's consecutive
blocks (``train/train_step.py``): the same numpy-seeded batch and the
same float32 weights give the reference's loss (1e-4) and its
accumulated gradients (rtol 1e-3), read where each package hands them
to AdamW.  The MoE case is the one the split decides, since its
load-balancing loss is a product of two means over a microbatch's rows.
A 2×2 gloo mesh (``tests/_torch_gloo_worker.py``, four processes) runs
the same microbatched MoE step sharded: its loss and the gradients it
hands to AdamW held to 1e-5 of the unsharded port's."""
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

import repro.models.model as RM
import repro.train.train_step as RTS
from repro import configs as RC
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import init_opt_state as r_init_opt_state
from repro_torch import configs as PC
from repro_torch import tree as T
from repro_torch.data import make_batch_iterator
from repro_torch.models import from_jax_params, to_jax_layout
from repro_torch.train import AdamWConfig, init_opt_state
from repro_torch.train import train_step as PTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ, MICRO = 8, 64, 2


def _configs(arch):
    return (dataclasses.replace(RC.get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(PC.get_smoke_config(arch), dtype="float32"))


def _spy(monkeypatch, module, seen):
    """Record the gradients ``module``'s step hands to AdamW."""
    real = module.adamw_update

    def spy(opt_cfg, params, grads, opt_state):
        seen.append(grads)
        return real(opt_cfg, params, grads, opt_state)

    monkeypatch.setattr(module, "adamw_update", spy)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "internlm2_1_8b"])
def test_microbatched_step_matches_the_jax_package(arch, monkeypatch):
    ref_cfg, port_cfg = _configs(arch)
    rp = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    pp = from_jax_params(port_cfg, jax.tree.map(np.asarray, rp),
                         device="cpu", dtype=torch.float32)
    batch = next(make_batch_iterator(port_cfg, BATCH, SEQ, seed=0))
    r_seen, p_seen = [], []
    _spy(monkeypatch, RTS, r_seen)
    _spy(monkeypatch, PTS, p_seen)
    _, _, rm = RTS.make_train_step(ref_cfg, RAdamWConfig(),
                                   microbatches=MICRO)(
        rp, r_init_opt_state(rp), {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    _, _, pm = PTS.make_train_step(port_cfg, AdamWConfig(),
                                   microbatches=MICRO)(
        pp, init_opt_state(pp), {k: torch.from_numpy(v) for k, v in
                                 batch.items()})
    assert abs(float(pm["loss"]) - float(rm["loss"])) < 1e-4
    np.testing.assert_array_equal(pm["expert_counts"].numpy(),
                                  np.asarray(rm["expert_counts"]))
    rg = r_seen[0]
    pg = jax.tree.map(lambda t: t.detach().numpy(),
                      to_jax_layout(port_cfg, p_seen[0]))
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(flat) == len(jax.tree.leaves(pg))
    for path, a in flat:
        b = pg
        for key in path:
            b = b[key.key]
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_microbatches_are_the_reference_blocks():
    """Block i holds rows [i·B/m, (i+1)·B/m), as the reference's
    reshape (m, B/m, …) gives them."""
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3),
             "labels": torch.arange(8)}
    blocks = PTS.microbatches_of(batch, 4)
    ref = np.arange(8 * 3).reshape(4, 2, 3)
    for i, mb in enumerate(blocks):
        np.testing.assert_array_equal(mb["tokens"].numpy(), ref[i])
        np.testing.assert_array_equal(mb["labels"].numpy(),
                                      np.arange(8).reshape(4, 2)[i])


def test_sharded_microbatched_step_equals_unsharded():
    _, cfg = _configs("qwen2_moe_a2_7b")
    from repro_torch.models import init_params
    with tempfile.TemporaryDirectory() as d:
        torch.save(init_params(cfg, 0, device="cpu", dtype=torch.float32),
                   os.path.join(d, "params.pt"))
        batch = next(make_batch_iterator(cfg, BATCH, SEQ, seed=1))
        torch.save({k: torch.from_numpy(v) for k, v in batch.items()},
                   os.path.join(d, "batch.pt"))
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_gloo_worker.py"),
             "microbatch", d],
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        out = torch.load(os.path.join(d, "out.pt"))
    assert abs(float(out["loss"]) - float(out["plain_loss"])) < 1e-5
    assert torch.equal(out["counts"], out["plain_counts"])
    for a, b in zip(T.leaves(out["grads"]), T.leaves(out["plain_grads"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
