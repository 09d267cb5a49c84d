"""The PyTorch port's serving path against the JAX package at smoke
sizes: ``greedy_generate`` gives the reference's tokens in float32 on
the same weights; ``launch.serve`` runs on ``--device cpu`` (its
function for the attention, MoE, hybrid and ssm families, its
config-taking ``serve_config`` and its command line) and routes and rebalances exactly as
the reference's flow does; ``SwarmRequestRouter`` and ``ExpertBalancer``
(copies of the reference's modules) fed the same inputs give the same
outputs as the reference's, the balancer on expert counts from the
port's kernel-K5 path."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import ExpertBalancer as JBalancer  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serve import SwarmRequestRouter as JRouter  # noqa: E402
from repro.serve import greedy_generate as j_generate  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import ExpertBalancer  # noqa: E402
from repro_torch.launch.serve import serve, serve_config  # noqa: E402
from repro_torch.models import from_jax_params, prefill  # noqa: E402
from repro_torch.models.model import layer_kinds  # noqa: E402
from repro_torch.serve import (SwarmRequestRouter, greedy_generate,  # noqa: E402
                               make_prefill_step, make_serve_step)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _f32(arch):
    return (dataclasses.replace(configs.get_smoke_config(arch),
                                dtype="float32"),
            dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype="float32"))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_moe_a2_7b"])
def test_greedy_generate_matches_the_reference_in_float32(arch):
    cfg, jcfg = _f32(arch)
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    tp = from_jax_params(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32)
    want = np.asarray(j_generate(jcfg, jp, jnp.asarray(toks), steps=6))
    got = greedy_generate(cfg, tp, torch.from_numpy(toks), steps=6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_builders_match_the_model_functions():
    cfg, _ = _f32("internlm2_1_8b")
    from repro_torch.models import decode_step, init_params
    params = init_params(cfg, 2, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5), dtype=torch.int32)
    a, cache_a = make_prefill_step(cfg, max_seq=8)(params, token_ids=toks)
    b, cache_b, _ = prefill(params, cfg, token_ids=toks, max_seq=8)
    assert torch.equal(a, b) and cache_a["offset"] == 5
    tok = torch.argmax(a[:, -1], -1).to(torch.int32)[:, None]
    c, cache_c = make_serve_step(cfg)(params, cache_a, tok)
    d, _, _ = decode_step(params, cfg, cache_b, tok)
    assert torch.equal(c, d) and cache_c["offset"] == 6


def _reference_flow(sessions, replicas, steps):
    """The reference launcher's routing flow, model aside."""
    router = JRouter(num_replicas=replicas, beta=4)
    ids = np.arange(sessions)
    assignment = router.admit(ids)
    local = ids[assignment == 0]
    if len(local) == 0:
        local = ids[:1]
    actions = []
    for _ in range(steps - 1):
        router.step_tokens(local)
        actions.append(router.rebalance().action)
    loads = router.replica_loads()
    return (np.bincount(assignment, minlength=replicas).tolist(), len(local),
            sum(a != "none" for a in actions),
            float(loads.std() / (loads.mean() + 1e-9)))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_moe_a2_7b",
                                  "jamba_v0_1_52b", "xlstm_1_3b"])
def test_serve_runs_on_the_cpu_and_routes_as_the_reference(arch):
    out = serve(arch, smoke=True, sessions=24, prompt_len=8, steps=5,
                replicas=4, device="cpu", log=lambda *_: None)
    cfg = configs.get_smoke_config(arch)
    spread, batch, rebalances, cv = _reference_flow(24, 4, 5)
    assert out["initial_spread"] == spread and out["batch"] == batch
    assert out["rebalances"] == rebalances
    assert out["replica_load_cv"] == pytest.approx(cv, rel=1e-12)
    assert out["tokens"].shape == (batch, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert out["logits_finite"] and out["decode_calls"] == 4
    assert out["d_model"] == cfg.d_model and out["layers"] == cfg.num_layers
    if cfg.moe is not None:
        # one histogram per call: prefill's batch·prompt·top_k, then
        # batch·top_k per decode step, summed over the MoE layers
        per_call = out["expert_counts"].sum(1)
        k = cfg.moe.top_k
        layers = sum(ffn == "moe" for _, ffn, _ in layer_kinds(cfg))
        assert per_call[0] == batch * 8 * k * layers
        assert (per_call[1:] == batch * k * layers).all()
        assert out["ep_shards"] == 4


def test_serve_config_runs_a_config_the_caller_cut():
    """``serve_config`` takes a ``ModelConfig``: jamba's smoke config
    cut to one period gives what ``serve`` gives on the same config."""
    cfg = configs.get_smoke_config("jamba_v0_1_52b")
    assert cfg.num_layers == 8          # one period already: cut nothing
    kw = dict(sessions=12, prompt_len=6, steps=3, device="cpu",
              log=lambda *_: None)
    a = serve("jamba_v0_1_52b", smoke=True, **kw)
    b = serve_config(cfg, **kw)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["expert_counts"], b["expert_counts"])
    wide = dataclasses.replace(cfg, num_layers=16)
    c = serve_config(wide, **kw)
    assert c["layers"] == 16 and c["logits_finite"]


def test_serve_command_line_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "h2o_danube_1_8b", "--smoke", "--sessions", "12", "--prompt-len",
         "6", "--steps", "3", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "replica load CV" in res.stdout


def test_serve_refuses_an_encoder_only_arch():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve("hubert_xlarge", smoke=True, device="cpu")


def test_request_router_matches_the_reference():
    rng = np.random.default_rng(5)
    ours, ref = SwarmRequestRouter(4, beta=2), JRouter(4, beta=2)
    ids = rng.permutation(200)[:120]
    np.testing.assert_array_equal(ours.admit(ids), ref.admit(ids))
    for step in range(12):
        hot = rng.choice(ids, 40 if step < 6 else 10)
        np.testing.assert_array_equal(ours.step_tokens(hot),
                                      ref.step_tokens(hot))
        a, b = ours.rebalance(), ref.rebalance()
        assert (a.action, a.m_h, a.m_l) == (b.action, b.m_h, b.m_l)
        np.testing.assert_allclose(ours.replica_loads(), ref.replica_loads())
    np.testing.assert_array_equal(ours.route(ids), ref.route(ids))


def test_expert_balancer_on_the_port_counts_matches_the_reference():
    """SWARM-EP fed the expert histograms of the port's MoE prefill and
    decode path (kernel K5's plain version on the CPU) makes the
    reference balancer's decisions."""
    cfg = configs.get_smoke_config("qwen2_moe_a2_7b")
    out = serve("qwen2_moe_a2_7b", smoke=True, sessions=40, prompt_len=8,
                steps=6, device="cpu", log=lambda *_: None)
    counts = list(out["expert_counts"])
    skew = np.zeros(cfg.moe.num_experts)
    skew[:2] = 50.0                                # a hot pair of experts
    counts += [c + skew for c in counts]
    ours, ref = (ExpertBalancer(cfg.moe.num_experts, 4, beta=2),
                 JBalancer(cfg.moe.num_experts, 4, beta=2))
    for c in counts:
        a, b = ours.update(c), ref.update(c)
        assert a == b
        np.testing.assert_array_equal(ours.placement, ref.placement)
        assert ours.imbalance(c) == ref.imbalance(c)
    assert ours.moves == ref.moves > 0
