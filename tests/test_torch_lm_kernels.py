"""The PyTorch port's LM kernels (K5 ``moe_histogram``, K6
``flash_attention``) against the JAX package: each plain PyTorch
version, and each wrapper on a CPU tensor, against the JAX kernel in
interpret mode and its JAX reference, on the sweeps of
``tests/test_kernels.py`` (GQA, sliding window, decode offset, bf16,
lengths that are not a block multiple).  Tolerances are the JAX
package's own: attention float32 atol 2e-5, bfloat16 atol 3e-2; the
histogram's counts exact, its load rtol 1e-5.  Inputs come from NumPy
seeds and reach both sides as NumPy arrays.  An emulation of the
arithmetic of K6's bf16 tensor-core kernel (``flash_mma``) pins why its
P·V takes P as two bf16 terms."""
import math

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


# ---------------------------------------------------------------------------
# the arithmetic of K6's bf16 tensor-core kernel (flash_mma), emulated
# ---------------------------------------------------------------------------

MMA_BQ, MMA_BK = 64, 32      # flash_mma's query rows a block, keys a tile


def _mma_emulation(q, k, v, *, causal, window, q_offset, two_term=True):
    """What ``flash_mma`` computes from bf16 q, k, v, in float32 on the
    CPU: for each block of MMA_BQ query rows, the kv tiles of MMA_BK keys
    from the first key the block can see to the last; scores as float32
    products of the bf16 operands, scaled after the product; an online
    softmax from a running max of -1e30 with masked scores at -inf; P·V
    with P rounded to bf16 as two terms, hi = bf16(p) and
    lo = bf16(p - hi) (one term, hi, when not ``two_term``), each product
    summed in float32; the row sum over the float32 p; the output divided
    by max(l, 1e-30) and rounded to bf16 once."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    out = torch.zeros((b, h, s, d))
    for q0 in range(0, s, MMA_BQ):
        qf = q[:, :, q0:q0 + MMA_BQ].float()
        n = qf.shape[2]
        rows = torch.arange(q0, q0 + n)[:, None] + q_offset
        last = q0 + n - 1 + q_offset
        kv_end = min(skv, last + 1) if causal else skv
        kv_begin = max(0, q0 + q_offset - window + 1) if window else 0
        m = torch.full((b, h, n, 1), -1e30)
        l = torch.zeros((b, h, n, 1))
        acc = torch.zeros((b, h, n, d))
        for j0 in range(kv_begin, kv_end, MMA_BK):
            j1 = min(j0 + MMA_BK, kv_end)
            cols = torch.arange(j0, j1)[None, :]
            mask = torch.ones((n, j1 - j0), dtype=torch.bool)
            if causal:
                mask &= cols <= rows
            if window:
                mask &= cols > rows - window
            sc = (qf @ kf[:, :, j0:j1].transpose(-1, -2)) * scale
            sc = sc.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            terms = [hi, (p - hi).bfloat16().float()] if two_term else [hi]
            acc = acc * alpha
            for term in terms:
                acc = acc + term @ vf[:, :, j0:j1]
            m = m_new
        out[:, :, q0:q0 + n] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _bf16_step_worst(got, want):
    """The largest |got − want| over its per-element bound, two bfloat16
    steps at the want value plus 2e-5 (the card tests' and chip_smoke's
    bound for K6's bf16 outputs): at most 1 where the bound holds."""
    w = torch.as_tensor(np.asarray(want, np.float32))
    _, e = torch.frexp(w)
    step = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 8))
    diff = (torch.as_tensor(np.asarray(got, np.float32)) - w).abs()
    return float((diff / (2 * step + TOL["float32"])).max())


MMA_CASES = [
    # (b, h, hkv, s, skv, d, causal, window, q_offset)
    (1, 4, 1, 130, 130, 16, True, None, 0),      # GQA group 4
    (1, 4, 2, 200, 200, 80, True, 100, 0),       # window
    (1, 4, 4, 256, 256, 128, True, None, 0),
    (1, 2, 2, 150, 250, 256, True, None, 100),   # q_offset
    (1, 4, 2, 77, 150, 80, False, None, 0),      # non-causal, Skv > S
    (1, 8, 1, 65, 65, 128, True, 10, 0),         # GQA 8, window < a tile
]


@pytest.mark.parametrize("b,h,hkv,s,skv,d,causal,window,q_offset",
                         MMA_CASES)
def test_tensor_core_numerics_hold_two_bf16_steps(
        b, h, hkv, s, skv, d, causal, window, q_offset):
    """flash_mma's arithmetic, P as two bf16 terms, within two bf16 steps
    (+ 2e-5) of the port's plain version and of the JAX reference on
    every element.  The JAX reference takes the bf16 values widened to
    float32 and its output is rounded to bf16 once: given bf16 arrays it
    rounds its scale 1/sqrt(D) to bf16 as well, which at D = 80 and 128
    (not bf16 numbers) moves outputs by up to ~3.2 of this bound, while
    the Pallas kernel, the port's plain version and flash_mma scale in
    float32."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s + d, b, h, hkv, s, skv, d),
                                       "bfloat16")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _f32(_mma_emulation(tq, tk, tv, **kw))
    assert _bf16_step_worst(got, _f32(FA.attention_ref(tq, tk, tv, **kw))
                            ) <= 1.0
    wide = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    want = j_attention_ref(*wide, **kw).astype(jnp.bfloat16)
    assert _bf16_step_worst(got, _f32(want)) <= 1.0


@pytest.mark.parametrize("b,h,hkv,s,skv,d,causal,window,q_offset", [
    (1, 4, 2, 200, 200, 80, True, 100, 0),
    (1, 4, 4, 256, 256, 128, True, None, 0),
    (1, 2, 2, 150, 250, 256, True, None, 100),
    (1, 4, 2, 77, 150, 80, False, None, 0),
])
def test_one_term_p_breaks_the_bf16_step_bound(
        b, h, hkv, s, skv, d, causal, window, q_offset):
    """The counter-case: P rounded to bf16 once before P·V puts outputs
    past two bf16 steps of the plain value, which is why flash_mma
    splits P into two terms."""
    _, (tq, tk, tv) = _both(_qkv(s + d, b, h, hkv, s, skv, d), "bfloat16")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _f32(_mma_emulation(tq, tk, tv, two_term=False, **kw))
    assert _bf16_step_worst(got, _f32(FA.attention_ref(tq, tk, tv, **kw))
                            ) > 1.0


def test_tensor_core_rows_must_start_on_16_bytes():
    """The card wrapper's check before the tensor-core kernel (it runs on
    CUDA tensors only; here it is called on host tensors): bf16 rows on
    16 bytes pass, a view shifted by one element or with a row stride off
    a multiple of 8 elements raises, and a size-1 dimension's stride does
    not matter."""
    wide = torch.zeros((2, 3, 40, 136), dtype=torch.bfloat16)
    FA.ops._check_aligned(wide[..., :128], wide[..., 8:136],
                          wide[:1, :1, :, :128].transpose(1, 2))
    for bad in (wide[..., 1:129], torch.zeros((2, 3, 40, 132),
                                              dtype=torch.bfloat16)[..., :128]):
        with pytest.raises(ValueError, match="16 bytes"):
            FA.ops._check_aligned(wide[..., :128], bad, wide[..., :128])


def test_tuning_variants_edit_the_shipped_kernel():
    """Each variant of K6's tuning script (run on a card) is one edit of
    text that the shipped source still holds."""
    from repro_torch.kernels.flash_attention import variants
    with open(FA.ops.SOURCE) as f:
        text = f.read()
    for name, edit in variants.VARIANTS.items():
        assert edit is None or (edit[0] in text and edit[1] not in text), name


def test_histogram_cuts_edit_the_shipped_kernel():
    """Each cut of K5's timing script (run on a card) is one edit of text
    that the shipped source holds once."""
    from repro_torch.kernels.moe_histogram import variants
    with open(MH.ops.SOURCE) as f:
        text = f.read()
    for name, (old, _) in variants.CUTS.items():
        assert text.count(old) == 1, name


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


# K5's fixed float32 sum order (kernels/moe_histogram/order.py): the
# card holds the kernel to it bit for bit; here it is held to the plain
# version and to the JAX package's interpret-mode kernel
HIST_ORDER_CASES = [
    # (t, k, e, pad, gates)
    (51200, 4, 60, 0.0, "uniform"),   # qwen2-moe prefill: 100 blocks
    (50, 4, 60, 0.0, "uniform"),      # qwen2-moe decode: one block
    (128, 4, 60, 0.1, "uniform"),     # exactly one block's 512
    (129, 4, 60, 0.1, "uniform"),     # one more: two blocks, the ticket
    (100_000, 4, 60, 0.1, "uniform"), # 131 blocks, 8 runs in the fold
    (51200, 4, 60, 0.1, "mixed"),     # gates of about 1e3 and 1e-3
    (16384, 6, 64, 0.1, "mixed"),
    (4097, 2, 300, 0.1, "mixed"),
    (5000, 8, 4096, 0.1, "uniform"),  # one warp a block
    (104, 4, 60, 0.1, "uniform"),     # 13 warps: an odd tree
    (1000, 3, 1, 0.5, "mixed"),
]


@pytest.mark.parametrize("t,k,e,pad,kind", HIST_ORDER_CASES)
def test_histogram_kernel_order_matches_plain_and_jax(t, k, e, pad, kind):
    from repro_torch.kernels.moe_histogram.order import moe_histogram_order
    idx, gates = _assignments(t + k + e, t, k, e, pad)
    if kind == "mixed":
        big = np.random.default_rng(t).random((t, k)) < 0.5
        gates = (gates + 0.5) * np.where(big, 1e3, 1e-3).astype(np.float32)
    counts, load = moe_histogram_order(idx, gates, e)
    assert counts.dtype == load.dtype == np.float32
    pc, pl = MH.moe_histogram_ref(torch.from_numpy(idx),
                                  torch.from_numpy(gates), e)
    jc, jl = j_hist(jnp.asarray(idx), jnp.asarray(gates), num_experts=e,
                    interpret=True)
    for c, ld in ((pc.numpy(), pl.numpy()), (np.asarray(jc), np.asarray(jl))):
        np.testing.assert_array_equal(counts, c)
        np.testing.assert_allclose(load, ld, rtol=1e-5)
    exact = np.zeros(e)
    keep = idx >= 0
    np.add.at(exact, idx[keep], gates[keep].astype(np.float64))
    np.testing.assert_allclose(load, exact, rtol=1e-5)


@pytest.mark.parametrize("e", [1, 60, 64, 256, 257, 4096])
@pytest.mark.parametrize("n", [0, 1, 200, 512, 513, 204_800])
def test_histogram_geometry_fits_the_kernel(n, e):
    """ops.geometry stays inside what the kernel's launcher accepts: the
    blocks cover n with as few steps as one block allows, the bins fit
    the shared memory, the fold's runs are at most one a warp."""
    warps, steps, blocks, segments = MH.ops.geometry(n, e)
    chunk = warps * steps * 32
    assert 1 <= warps <= MH.ops.MAX_WARPS and 1 <= steps <= MH.ops.STEPS
    assert (blocks - 1) * chunk < max(n, 1) <= blocks * chunk
    assert warps == 1 or (warps * (8 * e + 128) <= MH.ops.SMEM_BYTES
                          and (warps - 1) * 32 < n)
    assert steps == 1 or (steps - 1) * MH.ops.SMS * warps * 32 < n
    assert 4 * (2 * warps * e + 32 * warps) <= MH.ops.SMEM_BYTES
    assert 1 <= segments <= min(warps, blocks)
    assert segments * e <= max(32 * warps, e)
    if n <= 512 and e <= 64:            # every decode call: one block
        assert blocks == 1
