"""The PyTorch port's models (``repro_torch.models``) against the JAX
package's (``repro.models``) at smoke sizes: the JAX ``init_params``
carried over by ``from_jax_params``, then prefill logits, every decode
step's logits (teacher-forced: both sides get the reference's greedy
token), the KV cache and the MoE ``expert_counts`` against the JAX
``prefill`` / ``decode_step``, for GQA (internlm2), sliding window
(h2o-danube), tanh GELU + tied head + D = 16 (gemma), a plain GELU MLP
(starcoder2), two MoE archs (qwen2-moe, deepseek-moe) and the recurrent
families — jamba (attention, Mamba, MLP and MoE layers; also at 16
layers, two periods) and xlstm (sLSTM and mLSTM) — with every cache
tensor against the reference's; ``forward`` for the frontend stubs
(pixtral, hubert).

Tolerances: float32 atol 1e-4 on logits (two BLAS libraries summing in
other orders), expert counts exact.  bfloat16 atol 4e-2 on the dense
archs: their smoke logits reach |3.2|, where one bfloat16 step is 1/64,
and the two libraries round differently at several places — XLA's
bfloat16 sigmoid, silu and tanh-GELU differ from PyTorch's by one step
(the products agree bit for bit), and the reference rounds the softmax
to bfloat16 before its P·V product while kernel K6 keeps it in float32
— which adds up to one or two steps at the logits (0.031 at most on
these inputs).  MoE (jamba included) is held in float32 only, where no
expert choice flips.  xlstm in bfloat16: XLSTM_BF16_TOL, see there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_histogram as MH  # noqa: E402
from repro_torch.models import (decode_step, forward, from_jax_params,  # noqa: E402
                                init_params, param_spec, prefill)
from repro_torch.models.model import PORTED_FAMILIES, period_pattern  # noqa: E402

KEY = jax.random.PRNGKey(0)
DENSE = ["internlm2_1_8b", "h2o_danube_1_8b", "gemma_7b", "starcoder2_7b"]
MOE = ["qwen2_moe_a2_7b", "deepseek_moe_16b"]
RECURRENT = ["jamba_v0_1_52b", "xlstm_1_3b"]
PROMPT, STEPS, MAX_SEQ = 10, 4, 16


def _cfg(arch, dtype, **over):
    return dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype,
                               **over)


def _pair(arch, dtype="float32", **over):
    """(cfg, JAX params, the port's params carried over from them);
    ``over`` replaces fields of the smoke config on both sides."""
    cfg = _cfg(arch, dtype, **over)
    jp = j_init(dataclasses.replace(jconfigs.get_smoke_config(arch),
                                    dtype=dtype, **over), KEY)
    tree = jax.tree.map(np.asarray, jp)
    return cfg, jp, from_jax_params(cfg, tree, device="cpu")


def _reference_cache(name, value):
    """The reference's cache tensor in the port's layout: (periods, n,
    …) → (periods · n, …), K and V (…, B, S, Hkv, Dh) → (…, B, Hkv, S,
    Dh) (``models.model.cache_spec``)."""
    a = _np(value)
    a = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
    return a.transpose(0, 1, 3, 2, 4) if name in ("kv_k", "kv_v") else a


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get_config(a).family
                                  in PORTED_FAMILIES])
def test_from_jax_params_unstacks_every_leaf(arch):
    cfg, jp, tp = _pair(arch)
    n = 0
    n_pos = len(period_pattern(cfg))
    for path, arr in _leaves(jax.tree.map(np.asarray, jp)):
        if path[0] == "blocks":     # period i's position j: layer i·n_pos + j
            for i in range(arr.shape[0]):
                got = tp["layers"][i * n_pos + int(path[1][3:])]
                for key in path[2:]:
                    got = got[key]
                np.testing.assert_array_equal(got.numpy(), arr[i])
                n += 1
        else:
            got = tp
            for key in path:
                got = got[key]
            np.testing.assert_array_equal(got.numpy(), arr)
            n += 1
    assert n == sum(1 for _ in _leaves(tp))      # nothing more in the port
    assert cfg.param_count() == jconfigs.get_smoke_config(arch).param_count()


def test_model_entry_points_default_to_the_card():
    """Parameters and caches land on the card unless the caller names
    the CPU, whether made by the port or carried over from JAX."""
    import inspect

    from repro_torch.launch.serve import serve
    from repro_torch.models import init_cache
    for fn in (init_params, init_cache, from_jax_params, serve):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get_config(a).family
                                  in PORTED_FAMILIES])
def test_param_count_of_the_full_config_matches_the_reference(arch):
    assert (configs.get_config(arch).param_count()
            == jconfigs.get_config(arch).param_count())


def _check_serving(arch, dtype, atol, state_atol=1e-5, **over):
    """Prefill and STEPS teacher-forced decode steps on both packages:
    logits within ``atol``, every cache tensor in the end within
    ``max(atol, 1e-5)`` (K and V) or ``state_atol`` (the recurrent
    states).  Returns the (JAX, port) aux pairs of every call."""
    cfg, jp, tp = _pair(arch, dtype, **over)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype,
                               **over)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    j_logits, j_cache, j_aux = j_prefill(jp, jcfg, token_ids=jnp.asarray(toks),
                                         max_seq=MAX_SEQ)
    f0, h0 = FA.ops.launches, MH.ops.launches
    t_logits, t_cache, t_aux = prefill(tp, cfg,
                                       token_ids=torch.from_numpy(toks),
                                       max_seq=MAX_SEQ)
    assert (FA.ops.launches, MH.ops.launches) == (f0, h0)   # CPU tensors
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), rtol=0,
                               atol=atol)
    counts = [(j_aux, t_aux)]
    for step in range(STEPS):
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1), np.int32)[:, None]
        j_logits, j_cache, j_aux = j_decode(jp, jcfg, j_cache,
                                            jnp.asarray(tok))
        t_logits, t_cache, t_aux = decode_step(tp, cfg, t_cache,
                                               torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), rtol=0,
                                   atol=atol, err_msg=f"decode {step}")
        counts.append((j_aux, t_aux))
    assert t_cache["offset"] == int(j_cache["offset"]) == PROMPT + STEPS
    assert sorted(t_cache) == sorted(j_cache)
    for name in sorted(j_cache):
        if name == "offset":
            continue
        tol = max(atol, 1e-5) if name in ("kv_k", "kv_v") else state_atol
        np.testing.assert_allclose(_np(t_cache[name]),
                                   _reference_cache(name, j_cache[name]),
                                   rtol=0, atol=tol, err_msg=name)
    return counts


def _check_counts(counts):
    for j_aux, t_aux in counts:
        np.testing.assert_array_equal(_np(t_aux["expert_counts"]),
                                      _np(j_aux["expert_counts"]))
        np.testing.assert_allclose(_np(t_aux["aux_loss"]),
                                   _np(j_aux["aux_loss"]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_prefill_and_decode_match_the_reference_in_float32(arch):
    """Logits 1e-4, K and V 1e-4, recurrent states 1e-4 (float32 states
    after 14 steps of the two libraries' exp and log1p), expert counts
    exact."""
    _check_counts(_check_serving(arch, "float32", 1e-4, state_atol=1e-4))


def test_jamba_over_two_periods_matches_the_reference_in_float32():
    """jamba's smoke config at 16 layers, two periods: the second
    period's attention layer reads K and V row 1, its Mamba layers state
    rows 7–13, its MoE layers add to the same counts."""
    _check_counts(_check_serving("jamba_v0_1_52b", "float32", 1e-4,
                                 state_atol=1e-4, num_layers=16))


# xlstm's bfloat16 logits: 16 bfloat16 steps at their scale (|logit| < 4,
# a step 1/64), not the dense archs' 4e-2.  The blocks round where the
# reference rounds (tests/test_torch_recurrent.py holds each within two
# bf16 steps), but the two libraries' float32 exp, log1p and tanh differ
# by an ulp, which flips a bfloat16 rounding in about one output in a
# thousand, and this model carries such a flip to the logits far more
# than the dense archs do: the reference's own logits move by more than
# 4e-2 when one element of its embedding moves by one bfloat16 step
# (test_xlstm_bfloat16_logits_move_past_4e_2_under_one_step).  Measured
# here: 0.133 at most.  The recurrent states (float32) are held to the
# same bound.
XLSTM_BF16_TOL = 16 / 64


@pytest.mark.parametrize("arch,atol", [(a, 4e-2) for a in DENSE]
                         + [("xlstm_1_3b", XLSTM_BF16_TOL)])
def test_prefill_and_decode_match_the_reference_in_bfloat16(arch, atol):
    _check_serving(arch, "bfloat16", atol, state_atol=atol)


def test_xlstm_bfloat16_logits_move_past_4e_2_under_one_step():
    """The reference alone: xlstm's bfloat16 smoke logits (prefill and
    four decode steps on _check_serving's tokens) move by more than
    4e-2 when one element of one prompt token's embedding row moves by
    one bfloat16 step; internlm2's by less.  This sensitivity, not a
    rounding point, sets XLSTM_BF16_TOL."""
    def moved(arch):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   dtype="bfloat16")
        jp = j_init(jcfg, KEY)
        toks = np.random.default_rng(len(arch)).integers(
            0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
        tok = np.asarray(jp["embed"]["tok"], np.float32)
        row = toks[0, 3]
        bumped = tok.copy()
        bumped[row, 5] = float(jnp.asarray(tok[row, 5], jnp.bfloat16)) * (
            1 + 2.0 ** -7)
        outs = []
        for table in (tok, bumped):
            params = dict(jp, embed={"tok": jnp.asarray(table)})
            logits, cache, _ = j_prefill(params, jcfg,
                                         token_ids=jnp.asarray(toks),
                                         max_seq=MAX_SEQ)
            got = [_np(logits)]
            for t in range(STEPS):
                step = jnp.full((2, 1), t + 1, jnp.int32)
                logits, cache, _ = j_decode(params, jcfg, cache, step)
                got.append(_np(logits))
            outs.append(got)
        return max(float(np.abs(a - b).max()) for a, b in zip(*outs))

    assert moved("xlstm_1_3b") > 4e-2 > moved("internlm2_1_8b")


@pytest.mark.parametrize("arch", ["pixtral_12b", "hubert_xlarge",
                                  "qwen2_moe_a2_7b"])
def test_forward_matches_the_reference_in_float32(arch):
    cfg, jp, tp = _pair(arch)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32")
    rng = np.random.default_rng(7)
    if cfg.frontend:
        emb = rng.normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
        j_out, j_aux = j_forward(jp, jcfg, embeds=jnp.asarray(emb))
        t_out, t_aux = forward(tp, cfg, embeds=torch.from_numpy(emb))
    else:
        toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        j_out, j_aux = j_forward(jp, jcfg, token_ids=jnp.asarray(toks))
        t_out, t_aux = forward(tp, cfg, token_ids=torch.from_numpy(toks))
    assert t_out.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_np(t_aux["expert_counts"]),
                                  _np(j_aux["expert_counts"]))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "h2o_danube_1_8b",
                                  "gemma_7b", "xlstm_1_3b",
                                  "jamba_v0_1_52b"])
def test_decode_matches_forward(arch):
    """Cache consistency on the port alone, as tests/test_models.py
    holds the reference (atol 2e-2, bfloat16): a prefill of 8 tokens
    and 4 decode steps against a forward over the 12.  jamba with its
    capacity factor raised to 8, so that no token drops, as there."""
    cfg = configs.get_smoke_config(arch)
    if cfg.moe is not None and cfg.family == "hybrid":
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32))
    full, _ = forward(params, cfg, token_ids=toks)
    _, cache, _ = prefill(params, cfg, token_ids=toks[:, :8], max_seq=16)
    for t in range(8, 12):
        logits, cache, _ = decode_step(params, cfg, cache, toks[:, t:t + 1])
    err = float((logits[:, 0].float() - full[:, 11].float()).abs().max())
    assert err < 2e-2, (arch, err)


def test_moe_placement_permutation_is_transparent():
    """Permuting experts and their weights identically leaves the output
    unchanged (the SWARM-EP migration invariant, tests/test_models.py)."""
    cfg = configs.get_smoke_config("qwen2_moe_a2_7b")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)))
    base, base_aux = forward(params, cfg, token_ids=toks)
    perm = torch.from_numpy(rng.permutation(cfg.moe.num_experts))
    inv = torch.argsort(perm)
    for lp in params["layers"]:
        for k in ("w_gate", "w_up", "w_down"):
            lp["ffn"][k] = lp["ffn"][k][inv]
    out, aux = forward(params, cfg, token_ids=toks, placement=perm)
    np.testing.assert_allclose(_np(out), _np(base), atol=1e-3)
    # counts are per physical slot: the logical histogram, permuted
    np.testing.assert_array_equal(_np(aux["expert_counts"])[perm.numpy()],
                                  _np(base_aux["expert_counts"]))


def test_init_params_follows_the_reference_rule():
    """Shapes and types of the spec, norm scales 0, embeddings at 0.02,
    every other leaf at 1/sqrt(fan_in) of the stacked leaf."""
    cfg = configs.get_smoke_config("qwen2_moe_a2_7b")
    params = init_params(cfg, 3, device="cpu")
    lp = params["layers"][1]
    assert lp["ffn"]["router"].dtype == torch.float32
    assert lp["norm1"]["scale"].dtype == torch.float32
    assert lp["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(lp["norm2"]["scale"], torch.zeros(cfg.d_model))
    spec = param_spec(cfg)["blocks"]["pos0"]["ffn"]["w_gate"]["shape"]
    fan_in = spec[0] * spec[1] * spec[2]        # periods · E · D
    std = float(lp["ffn"]["w_gate"].float().std())
    assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05
    assert abs(float(params["embed"]["tok"].float().std()) / 0.02 - 1) < 0.1
    again = init_params(cfg, 3, device="cpu")
    assert torch.equal(again["lm_head"]["w"], params["lm_head"]["w"])
