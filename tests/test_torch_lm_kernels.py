"""The PyTorch port's LM kernels (K5 ``moe_histogram``, K6
``flash_attention``) against the JAX package: each plain PyTorch
version, and each wrapper on a CPU tensor, against the JAX kernel in
interpret mode and its JAX reference, on the sweeps of
``tests/test_kernels.py`` (GQA, sliding window, decode offset, bf16,
lengths that are not a block multiple).  Tolerances are the JAX
package's own: attention float32 atol 2e-5, bfloat16 atol 3e-2; the
histogram's counts exact, its load rtol 1e-5.  Inputs come from NumPy
seeds and reach both sides as NumPy arrays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.moe_histogram import moe_histogram as j_hist  # noqa: E402
from repro.kernels.moe_histogram import moe_histogram_ref as j_hist_ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_histogram as MH  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, b, h, hkv, s, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same inputs as JAX arrays and torch tensors of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


ATTN_CASES = [
    # (b, h, hkv, s, skv, d, window, q_offset) — test_kernels.py's sweeps
    (1, 2, 1, 64, 64, 32, None, 0),
    (2, 4, 2, 130, 130, 64, None, 0),
    (1, 8, 2, 256, 256, 128, None, 0),
    (1, 2, 2, 128, 128, 32, 16, 0),
    (1, 2, 2, 128, 128, 32, 100, 0),
    (2, 4, 2, 1, 96, 32, None, 95),
    (1, 2, 1, 64, 64, 32, None, 0),
    # beyond them: GQA decode at mid-cache offsets, odd D, a window
    (2, 4, 2, 1, 50, 16, None, 20),
    (1, 4, 1, 3, 70, 80, 24, 40),
    (1, 6, 2, 40, 40, 12, None, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,skv,d,window,q_offset", ATTN_CASES)
def test_attention_plain_version_and_cpu_wrapper_match_jax(
        dtype, b, h, hkv, s, skv, d, window, q_offset):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b + s + d, b, h, hkv, s, skv, d),
                                       dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want = _f32(j_attention_ref(jq, jk, jv, **kw))
    pallas = _f32(j_flash(jq, jk, jv, interpret=True, **kw))
    before = FA.ops.launches
    plain = FA.attention_ref(tq, tk, tv, **kw)
    wrapped = FA.flash_attention(tq, tk, tv, **kw)
    assert FA.ops.launches == before          # a CPU tensor never launches
    assert plain.dtype == wrapped.dtype == tq.dtype
    assert plain.shape == (b, h, s, d)
    for got in (plain, wrapped):
        np.testing.assert_allclose(_f32(got), want, rtol=0, atol=TOL[dtype])
        np.testing.assert_allclose(_f32(got), pallas, rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("s,skv", [(77, 77), (5, 40)])
def test_non_causal_attention_matches_the_jax_reference(s, skv):
    """Non-causal attention (the encoder-only archs): the JAX wrapper
    refuses to pad it, so the JAX reference alone is the oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, 2, 4, 2, s, skv, 16),
                                       "float32")
    want = _f32(j_attention_ref(jq, jk, jv, causal=False))
    got = FA.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=2e-5)


def test_attention_reads_a_cache_view_and_masks_what_it_cannot_see():
    """The first Skv rows of a longer cache give what the cache cut to
    Skv gives, and rows past the causal edge do not matter (up to the
    float32 rounding of a product over 31 or 64 keys)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 1, 64, 16))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 31:], v2[:, :, 31:] = 1e4, -1e4
    a = FA.flash_attention(q, k[:, :, :31], v[:, :, :31], q_offset=30)
    b = FA.flash_attention(q, k2, v2, q_offset=30)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_attention_row_without_a_key_is_zero():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 2, 4, 8, 16))
    out = FA.flash_attention(q, k, v, q_offset=-2)    # rows 0, 1 see none
    assert torch.equal(out[:, :, :2], torch.zeros_like(out[:, :, :2]))
    assert torch.isfinite(out).all()


def test_attention_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 3, 2, 4, 4, 16))
    with pytest.raises(ValueError, match="H % Hkv"):
        FA.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 2, 2, 4, 4, 16))
    with pytest.raises(TypeError, match="one type"):
        FA.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, v, window=0)


def _assignments(seed, t, k, e, pad=0.0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, e, (t, k)).astype(np.int32)
    idx[rng.random((t, k)) < pad] = -1
    return idx, rng.uniform(0, 1, (t, k)).astype(np.float32)


@pytest.mark.parametrize("t,k,e,pad", [(1, 1, 4, 0.0), (300, 4, 60, 0.0),
                                       (512, 6, 64, 0.0), (1000, 2, 16, 0.0),
                                       (257, 4, 60, 0.2)])
def test_histogram_plain_version_and_cpu_wrapper_match_jax(t, k, e, pad):
    idx, gates = _assignments(t + e, t, k, e, pad)
    jc, jl = j_hist(jnp.asarray(idx), jnp.asarray(gates), num_experts=e,
                    interpret=True)
    rc, rl = j_hist_ref(jnp.asarray(idx), jnp.asarray(gates), e)
    ti, tg = torch.from_numpy(idx), torch.from_numpy(gates)
    before = MH.ops.launches
    outs = [MH.moe_histogram_ref(ti, tg, e),
            MH.moe_histogram(ti, tg, num_experts=e)]
    assert MH.ops.launches == before
    for c, load in outs:
        assert c.dtype == load.dtype == torch.float32
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        np.testing.assert_allclose(load.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(load.numpy(), np.asarray(rl), rtol=1e-5)
        assert float(c.sum()) == int((idx >= 0).sum())


def test_histogram_wrapper_rejects_bad_inputs():
    idx, gates = (torch.from_numpy(a) for a in _assignments(0, 8, 2, 4))
    with pytest.raises(ValueError, match="4096 experts"):
        MH.moe_histogram(idx, gates, num_experts=MH.MAX_EXPERTS + 1)
    with pytest.raises(TypeError, match="int32"):
        MH.moe_histogram(idx.long(), gates, num_experts=4)
    with pytest.raises(ValueError, match=r"\(T, K\)"):
        MH.moe_histogram(idx, gates[:, :1], num_experts=4)
