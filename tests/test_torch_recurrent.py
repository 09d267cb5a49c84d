"""The PyTorch port's recurrent mixers (``repro_torch.models.mamba``,
``repro_torch.models.xlstm``) and ``layers.segmented_scan`` against the
JAX package's, on the CPU.

Block level: ``mamba_block``, ``mlstm_block`` and ``slstm_block`` on the
same inputs (NumPy seed) and the same weights (the JAX ``init_params``
carried over by ``from_jax_params``), over the full sequence and then
one step at a time from the returned state; float32 within atol 1e-5
(the two libraries' exp, log1p and tanh differ by an ulp or two, and
the recurrences sum in other orders).  bfloat16: every output element
within two bfloat16 steps at its reference value, the rounding points
("xs ride in bf16", ``jax.nn.sigmoid``'s formula) being the same.
``segmented_scan``: the loop equals the reference's ``lax.scan`` and,
where autograd records past one segment, checkpoints each segment with
the same gradient.  The cache layout converts to the reference's by a
reshape, and ``init_params`` keeps the reference's fixed values."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.layers as JL  # noqa: E402
import repro.models.mamba as JM  # noqa: E402
import repro.models.model as JMOD  # noqa: E402
import repro.models.xlstm as JX  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.models import from_jax_params, init_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import model as MOD  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402

KEY = jax.random.PRNGKey(0)
# (arch, mixer, position in the period, JAX block, port block)
BLOCKS = [("jamba_v0_1_52b", "mamba", 1, JM.mamba_block, M.mamba_block),
          ("xlstm_1_3b", "mlstm", 1, JX.mlstm_block, X.mlstm_block),
          ("xlstm_1_3b", "slstm", 0, JX.slstm_block, X.slstm_block)]
B, S = 2, 12


def _pair(arch, dtype):
    """(port cfg, JAX cfg, JAX params, port params) of the smoke config."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype)
    jp = j_init(jcfg)
    return cfg, jcfg, jp, from_jax_params(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")


def j_init(jcfg):
    return JMOD.init_params(jcfg, KEY)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _block_params(jp, tp, mixer, pos):
    """The mixer's weights of the first period's layer at ``pos``."""
    jpp = jax.tree.map(lambda a: a[0], jp["blocks"][f"pos{pos}"][mixer])
    return jpp, tp["layers"][pos][mixer]


def _bf16_steps(got, want):
    """The largest |got − want| in bfloat16 steps at |want| (2^-126 at
    zero)."""
    w = np.abs(want).astype(np.float32)
    step = 2.0 ** (np.floor(np.log2(np.maximum(w, 2.0 ** -126))) - 7)
    return float((np.abs(got - want) / step).max())


@pytest.mark.parametrize("arch,mixer,pos,jblock,tblock", BLOCKS)
def test_block_matches_the_reference_in_float32(arch, mixer, pos, jblock,
                                                tblock):
    """Full sequence, then the same sequence one step at a time from
    the state the first half left: outputs and states within 1e-5."""
    cfg, jcfg, jp, tp = _pair(arch, "float32")
    jpp, tpp = _block_params(jp, tp, mixer, pos)
    x = np.random.default_rng(len(mixer)).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)
    j_out, j_state = jblock(jpp, jnp.asarray(x), jcfg)
    t_out, t_state = tblock(tpp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=0, atol=1e-5)
    for a, b in zip(t_state, j_state):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)
    # the first half at once, then step by step from its state, on both
    half = S // 2
    _, j_st = jblock(jpp, jnp.asarray(x[:, :half]), jcfg)
    _, t_st = tblock(tpp, torch.from_numpy(x[:, :half]), cfg)
    for t in range(half, S):
        j_o, j_st = jblock(jpp, jnp.asarray(x[:, t:t + 1]), jcfg,
                           state=j_st)
        t_o, t_st = tblock(tpp, torch.from_numpy(x[:, t:t + 1]), cfg,
                           state=t_st)
        np.testing.assert_allclose(_np(t_o), _np(j_o), rtol=0, atol=1e-5)
        # and the stepped output equals the full sequence's position t
        np.testing.assert_allclose(_np(t_o)[:, 0], _np(t_out)[:, t],
                                   rtol=0, atol=1e-5)
    for a, b in zip(t_st, j_st):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,mixer,pos,jblock,tblock", BLOCKS)
def test_block_matches_the_reference_in_bfloat16(arch, mixer, pos, jblock,
                                                 tblock):
    """bfloat16 blocks round where the reference rounds: every output
    element within two bfloat16 steps of the reference's (a float32 ulp
    in the recurrence may flip a rounding)."""
    cfg, jcfg, jp, tp = _pair(arch, "bfloat16")
    jpp, tpp = _block_params(jp, tp, mixer, pos)
    x = np.random.default_rng(len(mixer)).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)
    j_out, _ = jblock(jpp, jnp.asarray(x, jnp.bfloat16), jcfg)
    t_out, _ = tblock(tpp, torch.from_numpy(x).bfloat16(), cfg)
    assert t_out.dtype == torch.bfloat16
    assert _bf16_steps(_np(t_out), _np(j_out)) <= 2.0


def test_mlstm_key_scale_is_sqrt_dk_in_the_compute_type():
    """At full width dk = 512: sqrt(512) is 22.625 in bfloat16 (the
    reference divides by ``jnp.sqrt(jnp.asarray(dk, dtype))``), a host
    float, exact in float32 too."""
    for dk in (16, 512):
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            want = float(jnp.sqrt(jnp.asarray(dk, jdt)))
            assert X._sqrt_in(dk, tdt) == want
    assert X._sqrt_in(512, torch.bfloat16) == 22.625
    full = configs.get_config("xlstm_1_3b")
    assert X._dims(full)[2] == 512


def test_sigmoid_and_silu_round_as_the_reference():
    """``layers.sigmoid`` / ``silu`` equal ``jax.nn.sigmoid`` / ``silu``
    bit for bit in bfloat16 and within an ulp in float32."""
    x = np.random.default_rng(0).normal(0, 4, 4096).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    jb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(_np(L.sigmoid(xb)),
                                  _np(jax.nn.sigmoid(jb)))
    np.testing.assert_array_equal(_np(L.silu(xb)), _np(jax.nn.silu(jb)))
    np.testing.assert_allclose(_np(L.sigmoid(torch.from_numpy(x))),
                               _np(jax.nn.sigmoid(jnp.asarray(x))),
                               rtol=2e-7, atol=0)


def _step(h, x_t):
    """A small recurrence with a tuple carry and a dict input."""
    a, b = h
    a = torch.tanh(a * x_t["u"] + b)
    b = b + 0.5 * a * x_t["v"]
    return (a, b), a * b


def _jstep(h, x_t):
    a, b = h
    a = jnp.tanh(a * x_t["u"] + b)
    b = b + 0.5 * a * x_t["v"]
    return (a, b), a * b


@pytest.mark.parametrize("length", [5, 256, 512, 768])
def test_segmented_scan_matches_lax_scan(length):
    rng = np.random.default_rng(length)
    u, v = (rng.normal(0, 0.5, (length, 3)).astype(np.float32)
            for _ in range(2))
    h = (np.zeros(3, np.float32), np.full(3, 0.1, np.float32))
    (ja, jb), jy = JL.segmented_scan(
        _jstep, tuple(map(jnp.asarray, h)),
        {"u": jnp.asarray(u), "v": jnp.asarray(v)})
    (ta, tb), ty = L.segmented_scan(
        _step, tuple(map(torch.from_numpy, h)),
        {"u": torch.from_numpy(u), "v": torch.from_numpy(v)})
    assert ty.shape == (length, 3)
    for a, b in ((ta, ja), (tb, jb), (ty, jy)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("length,checkpointed", [(512, True), (768, True),
                                                 (256, False), (300, False)])
def test_segmented_scan_checkpoints_segments_when_autograd_records(
        length, checkpointed, monkeypatch):
    """Past one segment and on a multiple of it, each segment runs under
    ``torch.utils.checkpoint`` when autograd records (and never without
    grad); the gradient equals the unsegmented loop's."""
    calls = []
    real = L.checkpoint

    def spy(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *a, **kw)

    monkeypatch.setattr(L, "checkpoint", spy)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.normal(0, 0.5, (length, 3)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 0.5, (length, 3)).astype(np.float32))
    h = (torch.zeros(3), torch.full((3,), 0.1))
    with torch.no_grad():
        L.segmented_scan(_step, h, {"u": u, "v": v})
    assert calls == []
    u.requires_grad_(True)
    (a, b), y = L.segmented_scan(_step, h, {"u": u, "v": v})
    g_seg = torch.autograd.grad(y.sum() + a.sum() + b.sum(), u)[0]
    assert calls == ([False] * (length // 256) if checkpointed else [])
    (a, b), y = L._scan(_step, h, {"u": u, "v": v})
    g_loop = torch.autograd.grad(y.sum() + a.sum() + b.sum(), u)[0]
    torch.testing.assert_close(g_seg, g_loop, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_1_3b"])
def test_cache_spec_is_the_references_reshaped(arch):
    """Every state of the reference's cache has the port's counterpart:
    (periods, n, …) → (periods · n, …), K and V with their sequence and
    head axes swapped; the types are the reference's, and the
    stabilisers start at −1e30."""
    cfg = configs.get_config(arch)
    jspec = JMOD.cache_spec(jconfigs.get_config(arch), 3, 40)
    tspec = MOD.cache_spec(cfg, 3, 40)
    assert sorted(jspec) == sorted(tspec)
    for name, (shape, dt) in jspec.items():
        tshape, tdt = tspec[name]
        if name == "offset":
            continue
        want = (shape[0] * shape[1], *shape[2:])
        if name in ("kv_k", "kv_v"):
            want = (want[0], want[1], want[3], want[2], want[4])
        assert tshape == want, name
        assert str(tdt).split(".")[-1] == np.dtype(dt).name, name
    small = configs.get_smoke_config(arch)
    cache = MOD.init_cache(small, 2, 8, device="cpu")
    for name in ("mlstm_m", "slstm_m"):
        if name in cache:
            assert bool((cache[name] == -1e30).all())


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_1_3b"])
def test_init_params_keeps_the_references_fixed_values(arch):
    """Biases 0 (conv, dt, sLSTM z/i/o), the forget bias 1, ``a_log`` =
    log(1 … d_state), ``d_skip`` 1, norm scales 0, all equal to the JAX
    package's; the recurrences' float32 leaves stay float32 in a
    bfloat16 model; the random leaves keep their 1/sqrt(fan_in) scale;
    and every leaf has storage of its own, float32 masters of two
    periods on the CPU included (an in-place optimizer step must not
    update two layers' norm scales at once)."""
    cfg = configs.get_smoke_config(arch)
    jp = jax.tree.map(np.asarray, j_init(jconfigs.get_smoke_config(arch)))
    tp = init_params(cfg, 3, device="cpu")
    two = dataclasses.replace(cfg, num_layers=2 * cfg.num_layers)
    masters = init_params(two, 3, device="cpu", dtype=torch.float32)
    ptrs = [t.data_ptr() for t in T.leaves(masters)]
    assert len(set(ptrs)) == len(ptrs)
    fixed = ("conv_b", "dt_proj_b", "b_z", "b_i", "b_o", "b_f", "a_log",
             "d_skip", "scale")
    float32 = ("a_log", "d_skip", "dt_proj_b", "r_z", "r_i", "r_f", "r_o",
               "scale", "router")
    n_pos = len(MOD.period_pattern(cfg))
    seen = set()
    for path, _ in L.spec_items(MOD.param_spec(cfg)):
        if path[0] != "blocks":
            continue
        ref = jp
        for key in path:
            ref = ref[key]
        for period in range(ref.shape[0]):
            got = tp["layers"][period * n_pos + int(path[1][3:])]
            for key in path[2:]:
                got = got[key]
            name = path[-1]
            assert got.dtype == (torch.float32 if name in float32
                                 else torch.bfloat16), path
            if name in fixed:
                np.testing.assert_array_equal(_np(got), ref[period])
                seen.add(name)
    want = ({"conv_b", "dt_proj_b", "a_log", "d_skip", "scale"}
            if cfg.family == "hybrid"
            else {"b_z", "b_i", "b_o", "b_f", "scale"})
    assert seen == want
    w = tp["layers"][1][("mamba" if cfg.family == "hybrid" else "mlstm")]
    lead = "in_proj" if cfg.family == "hybrid" else "up_proj"
    fan_in = MOD.num_periods(cfg) * w[lead].shape[0]
    assert abs(float(w[lead].float().std()) * np.sqrt(fan_in) - 1) < 0.1
