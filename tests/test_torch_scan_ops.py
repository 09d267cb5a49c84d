"""The recurrent scans as ``torch.library`` ops (``models/scan_ops.py``)
against the loop they replace, on the CPU.

The loop is ``layers.segmented_scan`` over the step closures the mixers
ran before the ops (copied below as they stood in ``models/mamba.py``
and ``models/xlstm.py``).  For each op: its outputs equal the loop's bit
for bit, float32 and bfloat16 inputs, within one segment and across
three; its gradients equal the loop's (rtol 1e-5) past one segment;
its fake gives the real shapes and types; its FLOP formulas equal
``FlopCounterMode``'s count of the loop (forward) and of the backward's
recompute; a 2-rank gloo run (``tests/_torch_gloo_worker.py``) on every
split its sharding rule offers equals the unsharded op, forward and
gradients.  Under ``dots_no_batch`` a block's scan op is recomputed in
the backward, not saved."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models import layers as L
from repro_torch.models import scan_ops as SO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C, N, H, DK, DV, D = 2, 6, 4, 2, 3, 5, 8


# ---------------------------------------------------------------------------
# The loop: the mixers' step closures as they were before the ops
# ---------------------------------------------------------------------------

def _log_sigmoid(x):
    return -F.softplus(-x)


def _mamba_loop(dt, b, c, x, a, h0):
    dtype = x.dtype

    def step(h, inp):
        dt_t, b_tt, c_tt, x_tt = (t.float() for t in inp)
        da = torch.exp(dt_t[..., None] * a)
        h = da * h + (dt_t * x_tt)[..., None] * b_tt[:, None, :]
        y = torch.einsum("bcn,bn->bc", h, c_tt)
        return h, y.to(dtype)

    xs = tuple(t.transpose(0, 1) for t in (dt, b, c, x))
    h_last, ys = L.segmented_scan(step, h0, xs)
    return ys.transpose(0, 1), (h_last,)


def _mlstm_loop(q, k, v, i, f, c0, n0, m0):
    def step(carry, inp):
        c, n, m = carry
        q_t, k_t, v_t, i_t, f_t = (t.float() for t in inp)
        log_f = _log_sigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        fg = torch.exp(log_f + m - m_new)
        ig = torch.exp(i_t - m_new)
        c = fg[..., None, None] * c + ig[..., None, None] * (
            k_t[..., :, None] * v_t[..., None, :])
        n = fg[..., None] * n + ig[..., None] * k_t
        num = torch.einsum("bhkv,bhk->bhv", c, q_t)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q_t).abs(),
                            torch.exp(-m_new))
        return (c, n, m_new), num / den[..., None]

    xs = tuple(t.transpose(0, 1) for t in (q, k, v, i, f))
    state, ys = L.segmented_scan(step, (c0, n0, m0), xs)
    return ys.transpose(0, 1), state


def _slstm_loop(z, i, f, o, r_z, r_i, r_f, r_o, c0, n0, h0, m0):
    b, d = c0.shape
    nh, dh = r_z.shape[0], r_z.shape[1]
    r = {"z": r_z, "i": r_i, "f": r_f, "o": r_o}

    def mix(h_prev, rg):
        hh = h_prev.reshape(b, nh, dh)
        return torch.einsum("bhk,hkj->bhj", hh, rg).reshape(b, d)

    def step(carry, inp):
        c, n, h_prev, m = carry
        inp = {g: v.float() for g, v in inp.items()}
        z_t = torch.tanh(inp["z"] + mix(h_prev, r["z"]))
        i_t = inp["i"] + mix(h_prev, r["i"])
        f_t = inp["f"] + mix(h_prev, r["f"])
        o_t = L.sigmoid(inp["o"] + mix(h_prev, r["o"]))
        log_f = _log_sigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        fg = torch.exp(log_f + m - m_new)
        ig = torch.exp(i_t - m_new)
        c = fg * c + ig * z_t
        n = fg * n + ig
        h_new = o_t * c / torch.clamp_min(n, 1e-6)
        return (c, n, h_new, m_new), h_new

    xs = {g: v.transpose(0, 1) for g, v in zip("zifo", (z, i, f, o))}
    state, ys = L.segmented_scan(step, (c0, n0, h0, m0), xs)
    return ys.transpose(0, 1), state


LOOPS = {"mamba_scan": _mamba_loop, "mlstm_scan": _mlstm_loop,
         "slstm_scan": _slstm_loop}


def _inputs(name, s, dtype, seed=0):
    """The op's inputs at length ``s``: sequences in ``dtype``, the rest
    float32, from a seed; the mLSTM's m0 is the mixers' −1e30 start."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dt)

    if name == "mamba_scan":
        dt = F.softplus(t(B, s, C)).to(dtype)
        return (dt, t(B, s, N, dt=dtype), t(B, s, N, dt=dtype),
                t(B, s, C, dt=dtype), -torch.exp(t(C, N, scale=0.5)),
                t(B, C, N, scale=0.1))
    if name == "mlstm_scan":
        return (t(B, s, H, DK, dt=dtype), t(B, s, H, DK, scale=0.5,
                                            dt=dtype),
                t(B, s, H, DV, dt=dtype), t(B, s, H, dt=dtype),
                t(B, s, H, scale=2.0, dt=dtype),
                torch.zeros(B, H, DK, DV), torch.zeros(B, H, DK),
                torch.full((B, H), -1e30))
    dh = D // H
    return (*(t(B, s, D, dt=dtype) for _ in range(4)),
            *(t(H, dh, dh, scale=0.3) for _ in range(4)),
            t(B, D, scale=0.1), torch.ones(B, D), t(B, D, scale=0.1),
            torch.zeros(B, D))


def _op(name):
    """The op's wrapper, its state as a tuple like the loop's."""
    if name == "mamba_scan":
        def mamba(*args):
            y, h = SO.mamba_scan(*args)
            return y, (h,)
        return mamba
    return getattr(SO, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [7, 3 * L.RECURRENCE_SEGMENT])
@pytest.mark.parametrize("name", list(SO.OPS))
def test_op_equals_the_loop_bit_for_bit(name, s, dtype):
    args = _inputs(name, s, dtype)
    y, state = _op(name)(*args)
    ry, rstate = LOOPS[name](*args)
    assert y.dtype == ry.dtype and y.shape == ry.shape
    assert torch.equal(y, ry)
    for a, b in zip(state, rstate):
        assert torch.equal(a, b)


def test_op_keeps_the_segment_boundaries():
    """S a multiple of the segment past one: the carry entering each
    later segment; otherwise none."""
    s = 3 * L.RECURRENCE_SEGMENT
    args = _inputs("mamba_scan", s, torch.float32)
    _, h, bounds = torch.ops.repro_torch.mamba_scan(*args)
    assert bounds.shape == (2, B, C, N)
    _, (h1,) = _mamba_loop(*(a[:, :L.RECURRENCE_SEGMENT] if a.dim() == 3
                             else a for a in args))
    assert torch.equal(bounds[0], h1)
    _, _, none = torch.ops.repro_torch.mamba_scan(
        *_inputs("mamba_scan", 7, torch.float32))
    assert none.shape == (0, B, C, N)


def _grads(fn, args, seed=1):
    args = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
    y, state = fn(*args)
    rng = np.random.default_rng(seed)
    outs = (y, *state)
    cot = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           .to(o.dtype) for o in outs]
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cot)
               if o.is_floating_point())
    return torch.autograd.grad(loss, args, allow_unused=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SO.OPS))
def test_op_gradients_equal_the_loops(name, dtype):
    """Two segments of ``RECURRENCE_SEGMENT``: the loop checkpoints each,
    the op recomputes each from its boundary carry."""
    args = _inputs(name, 2 * L.RECURRENCE_SEGMENT, dtype)
    if name == "mlstm_scan":    # a finite m0: its gradient is defined
        args = (*args[:-1], torch.zeros_like(args[-1]))
    got = _grads(_op(name), args)
    want = _grads(LOOPS[name], args)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), rtol=1e-5,
                                       atol=1e-6 if dtype == torch.float32
                                       else 1e-2, msg=f"input {k}")


@pytest.mark.parametrize("name", list(SO.OPS))
def test_fake_gives_the_real_shapes_and_types(name):
    s = 2 * L.RECURRENCE_SEGMENT
    args = _inputs(name, s, torch.bfloat16)
    real = getattr(torch.ops.repro_torch, name)(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = getattr(torch.ops.repro_torch, name)(
            *(mode.from_tensor(a) for a in args))
        nc = len(SO._SIGNATURES[name][1])
        g = [mode.from_tensor(torch.zeros_like(r)) for r in real[:1 + nc]]
        fake_back = getattr(torch.ops.repro_torch, f"{name}_backward")(
            *g, *(mode.from_tensor(a) for a in args), *fake[1 + nc:])
    assert [(tuple(t.shape), t.dtype) for t in fake] == \
        [(tuple(t.shape), t.dtype) for t in real]
    assert [(tuple(t.shape), t.dtype) for t in fake_back] == \
        [(tuple(a.shape), a.dtype) for a in args]


@pytest.mark.parametrize("s", [5, 2 * L.RECURRENCE_SEGMENT])
@pytest.mark.parametrize("name", list(SO.OPS))
def test_flop_formulas_equal_the_loops_count(name, s):
    args = _inputs(name, s, torch.float32)
    with FlopCounterMode(display=False) as loop:
        LOOPS[name](*args)
    with FlopCounterMode(display=False) as op:
        out = getattr(torch.ops.repro_torch, name)(*args)
    assert op.get_total_flops() == loop.get_total_flops() > 0
    assert SO.OPS[name].flops(*(a.shape for a in args)) == \
        loop.get_total_flops()
    nc = len(SO._SIGNATURES[name][1])
    grads_in = [torch.ones_like(o) for o in out[:1 + nc]]
    bounds = out[1 + nc:]
    with FlopCounterMode(display=False) as inner:    # the recompute itself
        SO.OPS[name].backward(*grads_in, *args, *bounds)
    with FlopCounterMode(display=False) as bop:
        getattr(torch.ops.repro_torch, f"{name}_backward")(
            *grads_in, *args, *bounds)
    assert bop.get_total_flops() == inner.get_total_flops() \
        == 3 * loop.get_total_flops()


# each op's splits on two ranks: the dim of each input split (None:
# replicated), as its sharding rule offers them
SPLITS = {
    "mamba_scan": [(0, 0, 0, 0, None, 0), (2, None, None, 2, 0, 1)],
    "mlstm_scan": [(0,) * 8, (2,) * 5 + (1,) * 3],
    "slstm_scan": [(0,) * 4 + (None,) * 4 + (0,) * 4,
                   (2,) * 4 + (0,) * 4 + (1,) * 4],
}


def test_sharding_rules_on_two_gloo_ranks_equal_the_unsharded_op():
    s = 2 * L.RECURRENCE_SEGMENT
    cases, want = {}, {}
    for name, splits in SPLITS.items():
        args = _inputs(name, s, torch.float32)
        if name == "mlstm_scan":
            args = (*args[:-1], torch.zeros_like(args[-1]))
        rng = np.random.default_rng(2)
        y, state = _op(name)(*args)
        cot = [torch.from_numpy(rng.standard_normal(o.shape)
                                .astype(np.float32)) for o in (y, *state)]
        for split in splits:
            cases[(name, split)] = (args, cot)
        placed = [a.detach().requires_grad_() for a in args]
        outs = _op(name)(*placed)
        outs = (outs[0], *outs[1])
        grads = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cot)), placed)
        want[name] = ([o.detach() for o in outs], grads)
    with tempfile.TemporaryDirectory() as d:
        torch.save(cases, os.path.join(d, "inputs.pt"))
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_gloo_worker.py"),
             "scan_ops", d],
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        out = torch.load(os.path.join(d, "out.pt"))
    for (name, split), got in out.items():
        outs, grads = want[name]
        assert "Shard" in got["placements"][0], (name, split, got)
        for a, b in zip(got["outs"], outs):
            assert torch.equal(a, b), (name, split)
        for a, b in zip(got["grads"], grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                       msg=str((name, split)))


def test_dots_no_batch_recomputes_the_scan_op(monkeypatch):
    """Under the default remat policy a block's scan op runs twice a
    step, in the forward and in the backward's recompute: its outputs
    are not saved, as the reference's policy saves no scan output."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import init_params, mamba
    from repro_torch.models.model import layer_kinds
    from repro_torch.train import make_grad_fn
    cfg = dataclasses.replace(configs.get_smoke_config("jamba_v0_1_52b"),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             next(make_batch_iterator(cfg, 2, 32, seed=0)).items()}
    calls = []
    real = mamba.mamba_scan

    def spy(*args):
        calls.append(torch.is_grad_enabled())
        return real(*args)

    monkeypatch.setattr(mamba, "mamba_scan", spy)
    make_grad_fn(cfg, remat="dots_no_batch")(params, batch)
    n_mamba = sum(m == "mamba" for m, _, _ in layer_kinds(cfg))
    assert len(calls) == 2 * n_mamba > 0
