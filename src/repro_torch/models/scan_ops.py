"""The recurrent mixers' scans as ``torch.library`` ops.

``repro_torch::mamba_scan``, ``repro_torch::mlstm_scan`` and
``repro_torch::slstm_scan`` each run one mixer's recurrence over the
sequence: the loop of :func:`layers._scan` over the step functions
below, the reference's ``lax.scan`` bodies op for op (Mamba's ``ys``
rounded to the compute type each step, ``log_sigmoid``, the −1e30
stabiliser), so the outputs are bit for bit those of
``layers.segmented_scan`` over the same steps.  A scan is one op
because a DTensor or fake-tensor trace then sees one call instead of a
stream of per-step ops (a 32 768-step prefill was untraceable as a
loop), and a sharded run places it by its rule at once.

Each op takes its inputs batch-major — Mamba dt, b, c, x (B, S, ·) in
the compute type, a (C, N) and h0 (B, C, N) float32; the mLSTM q, k, v
(B, S, H, ·), its gates i, f (B, S, H), and (c, n, m) states; the sLSTM
gate pre-activations z, i, f, o (B, S, D), its recurrent matrices r
(H, dh, dh) float32 and (c, n, h, m) states — and returns ``ys``
(B, S, ·), the last state and the states at the segment boundaries:
with S a multiple of :data:`layers.RECURRENCE_SEGMENT` past one
segment, the carry entering segments 1, 2, …, stacked along a new first
axis (empty otherwise).  The wrappers :func:`mamba_scan`,
:func:`mlstm_scan` and :func:`slstm_scan` drop the boundaries.

Each op has an implementation (CPU and CUDA: the loop of torch ops, as
the reference runs ``lax.scan`` and has no Pallas scan), a fake
implementation, a FLOP formula equal to ``FlopCounterMode``'s count of
the loop's products, DTensor sharding rules (every op along the batch;
Mamba along ``d_inner`` too, its channels being independent; the mLSTM
along its heads) and an autograd formula.  The backward is an op of its
own (``*_scan_backward``, with its own fake, FLOP formula and rules):
it recomputes the loop one segment at a time from the saved boundary
carries, last segment first, so that the forward keeps the boundaries
and nothing per step, the reference's ``nothing_saveable`` segments.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .layers import RECURRENCE_SEGMENT, _scan, sigmoid

__all__ = ["mamba_scan", "mlstm_scan", "slstm_scan", "mamba_step",
           "mlstm_step", "slstm_step", "log_sigmoid", "segment_length",
           "OPS"]


def log_sigmoid(x):
    """``-softplus(-x)``, the reference's log sigmoid."""
    return -F.softplus(-x)


def segment_length(length: int, seg_len: int = RECURRENCE_SEGMENT) -> int:
    """The segments a scan of ``length`` steps is cut into, as
    ``layers.segmented_scan`` cuts them when autograd records: ``seg_len``
    steps where ``length`` is a multiple of it past one segment, else one
    segment of the whole length."""
    if length % seg_len == 0 and length > seg_len:
        return seg_len
    return max(length, 1)


# ---------------------------------------------------------------------------
# The step functions: (carry tuple, inputs at t) → (carry tuple, y_t)
# ---------------------------------------------------------------------------

def mamba_step(a, dtype):
    """The selective-scan step over (dt, b, c, x) at t; the state h
    (B, C, N) float32, ``a`` (C, N) float32, y_t in ``dtype``."""
    def step(carry, inp):
        (h,) = carry
        dt_t, b_tt, c_tt, x_tt = (t.float() for t in inp)
        da = torch.exp(dt_t[..., None] * a)              # (B, C, N)
        h = da * h + (dt_t * x_tt)[..., None] * b_tt[:, None, :]
        y = torch.einsum("bcn,bn->bc", h, c_tt)
        return (h,), y.to(dtype)
    return step


def mlstm_step():
    """The mLSTM step over (q, k, v, i, f) at t; states C (B, H, dk, dv),
    n (B, H, dk), m (B, H) float32, y_t (B, H, dv) float32."""
    def step(carry, inp):
        c, n, m = carry
        q_t, k_t, v_t, i_t, f_t = (t.float() for t in inp)
        log_f = log_sigmoid(f_t)
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
    return step


def slstm_step(r_z, r_i, r_f, r_o):
    """The sLSTM step over (z, i, f, o) at t with the block-diagonal
    recurrent matrices r (H, dh, dh) float32; states c, n, h, m (B, D)
    float32, y_t = h."""
    def mix(h_prev, rg):
        b, d = h_prev.shape
        nh, dh = rg.shape[0], rg.shape[1]
        hh = h_prev.reshape(b, nh, dh)
        return torch.einsum("bhk,hkj->bhj", hh, rg).reshape(b, d)

    def step(carry, inp):
        c, n, h_prev, m = carry
        z_in, i_in, f_in, o_in = (v.float() for v in inp)
        z_t = torch.tanh(z_in + mix(h_prev, r_z))
        i_t = i_in + mix(h_prev, r_i)
        f_t = f_in + mix(h_prev, r_f)
        o_t = sigmoid(o_in + mix(h_prev, r_o))
        log_f = log_sigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        fg = torch.exp(log_f + m - m_new)
        ig = torch.exp(i_t - m_new)
        c = fg * c + ig * z_t
        n = fg * n + ig
        h_new = o_t * c / torch.clamp_min(n, 1e-6)
        return (c, n, h_new, m_new), h_new
    return step


# ---------------------------------------------------------------------------
# The ops' arithmetic, shared by the three scans
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _recording():
    """Autograd on inside an op's implementation.  Grad mode is off in a
    backward pass, and an op reached through a dispatch mode or a
    tensor subclass (``FlopCounterMode``, DTensor) runs with the
    autograd dispatch keys excluded: both are turned back on."""
    keys = torch._C.DispatchKey
    exclude = (torch._C._dispatch_tls_local_exclude_set()
               .remove(keys.AutogradFunctionality)
               .remove(keys.ADInplaceOrView))
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude), \
            torch.enable_grad():
        yield


class _Scan:
    """One scan op's description: how many of its leading inputs are
    per-step sequences (time axis 1), how many parameters follow them
    and how many carries; ``step(seqs, params)`` its step function,
    ``y_like(seqs)`` an empty ys, ``flops(*input shapes)`` the forward's
    products as ``FlopCounterMode`` counts the loop's einsums (two per
    multiply-add).  The backward op counts three times that: the
    recompute and the two products of each product's gradient."""

    def __init__(self, n_seq, n_param, n_carry, step, y_like, flops):
        self.n_seq, self.n_param, self.n_carry = n_seq, n_param, n_carry
        self.step, self.y_like, self.flops = step, y_like, flops

    def split(self, args):
        s, p = self.n_seq, self.n_seq + self.n_param
        return args[:s], args[s:p], args[p:p + self.n_carry]

    def forward(self, *args):
        """(ys, *last carry, *boundary carries) of the loop."""
        seqs, params, carry = self.split(args)
        step = self.step(seqs, params)
        xs = tuple(t.transpose(0, 1) for t in seqs)      # time-major views
        length = xs[0].shape[0]
        seg = segment_length(length)
        ys, bounds = [], []
        for lo in range(0, length, seg):
            if lo:
                bounds.append(carry)
            carry, y = _scan(step, carry, tuple(x[lo:lo + seg] for x in xs))
            ys.append(y)
        ys = ys[0] if len(ys) == 1 else torch.cat(ys)
        stacked = tuple(torch.stack([b[j] for b in bounds]) if bounds
                        else c.new_empty((0, *c.shape))
                        for j, c in enumerate(carry))
        return (ys.transpose(0, 1).contiguous(), *carry, *stacked)

    def fake(self, *args):
        seqs, params, carry = self.split(args)
        y = self.y_like(seqs)
        length = seqs[0].shape[1]
        n_bounds = length // segment_length(length) - 1
        return (y, *(torch.empty_like(c) for c in carry),
                *(c.new_empty((n_bounds, *c.shape)) for c in carry))

    def backward(self, *args):
        """Gradients of every input from the output cotangents (of ys and
        the last carry), the inputs and the boundary carries: the loop
        recomputed a segment at a time with autograd on, last segment
        first, each from its boundary carry."""
        nc = self.n_carry
        g_y, g_carry = args[0], args[1:1 + nc]
        inputs = args[1 + nc:-nc]
        bounds = args[-nc:]
        seqs, params, carry0 = self.split(inputs)
        xs = tuple(t.transpose(0, 1) for t in seqs)
        g_ys = g_y.transpose(0, 1)
        length = xs[0].shape[0]
        seg = segment_length(length)
        starts = list(range(0, length, seg))
        g_xs = [None] * len(starts)
        g_params = [torch.zeros_like(p) for p in params]
        g_c = tuple(g_carry)
        with _recording():
            for j in reversed(range(len(starts))):
                lo = starts[j]
                c_in = carry0 if j == 0 else tuple(b[j - 1] for b in bounds)
                c_in = tuple(c.detach().requires_grad_() for c in c_in)
                p_in = tuple(p.detach().requires_grad_() for p in params)
                x_in = tuple(x[lo:lo + seg].detach().requires_grad_()
                             for x in xs)
                c_out, y = _scan(self.step(seqs, p_in), c_in, x_in)
                outs = (*c_out, y)
                grads = torch.autograd.grad(
                    outs, c_in + p_in + x_in,
                    (*g_c, g_ys[lo:lo + seg]), allow_unused=True)
                grads = [torch.zeros_like(t) if g is None else g
                         for g, t in zip(grads, c_in + p_in + x_in)]
                g_c = tuple(grads[:nc])
                for k, g in enumerate(grads[nc:nc + len(p_in)]):
                    g_params[k] = g_params[k] + g
                g_xs[j] = grads[nc + len(p_in):]
        g_seqs = tuple(torch.cat([g[k] for g in g_xs]).transpose(0, 1)
                       .contiguous() for k in range(len(xs)))
        return (*g_seqs, *g_params, *g_c)

    def backward_fake(self, *args):
        nc = self.n_carry
        inputs = args[1 + nc:-nc]
        return tuple(torch.empty_like(t) for t in inputs)


def _mamba_flops(dt, b, c, x, a, h0):
    bsz, s, ch = dt
    return 2 * bsz * s * ch * b[2]


def _mlstm_flops(q, k, v, i, f, c0, n0, m0):
    bsz, s, h, dk = q
    return 2 * bsz * s * h * dk * (v[3] + 1)


def _slstm_flops(z, i, f, o, r_z, r_i, r_f, r_o, c0, n0, h0, m0):
    bsz, s, d = z
    return 4 * 2 * bsz * s * d * r_z[2]


def _float_like(t):
    return t.new_empty(t.shape, dtype=torch.float32)


OPS = {
    # ys in x's type
    "mamba_scan": _Scan(4, 1, 1,
                        lambda seqs, params: mamba_step(params[0],
                                                        seqs[3].dtype),
                        lambda seqs: torch.empty_like(seqs[3]),
                        _mamba_flops),
    # ys float32, v's shape
    "mlstm_scan": _Scan(5, 0, 3, lambda seqs, params: mlstm_step(),
                        lambda seqs: _float_like(seqs[2]), _mlstm_flops),
    # ys float32, z's shape
    "slstm_scan": _Scan(4, 4, 4, lambda seqs, params: slstm_step(*params),
                        lambda seqs: _float_like(seqs[0]), _slstm_flops),
}
_SIGNATURES = {
    "mamba_scan": (("dt", "b", "c", "x", "a", "h0"), ("h",)),
    "mlstm_scan": (("q", "k", "v", "i", "f", "c0", "n0", "m0"),
                   ("c", "n", "m")),
    "slstm_scan": (("z", "i", "f", "o", "r_z", "r_i", "r_f", "r_o", "c0",
                    "n0", "h0", "m0"), ("c", "n", "h", "m")),
}

# a plain ``Library`` definition, as K5's and K6's: calls go through the
# C++ dispatcher alone
_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def _define(name: str) -> None:
    scan = OPS[name]
    ins, carries = _SIGNATURES[name]
    outs = ["y", *carries, *(f"{c}_bounds" for c in carries)]
    _LIB.define(f"{name}({', '.join(f'Tensor {a}' for a in ins)}) -> "
                f"({', '.join('Tensor' for _ in outs)})")
    grads_in = ["g_y", *(f"g_{c}" for c in carries), *ins,
                *(f"{c}_bounds" for c in carries)]
    _LIB.define(f"{name}_backward("
                f"{', '.join(f'Tensor {a}' for a in grads_in)}) -> "
                f"({', '.join('Tensor' for _ in ins)})")
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, scan.forward, key)
        _LIB.impl(f"{name}_backward", scan.backward, key)
    torch.library.register_fake(f"repro_torch::{name}", scan.fake, lib=_LIB)
    torch.library.register_fake(f"repro_torch::{name}_backward",
                                scan.backward_fake, lib=_LIB)
    n_in, nc = len(ins), len(carries)
    backward_op = getattr(torch.ops.repro_torch, f"{name}_backward").default

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output[1 + nc:])
        ctx.mark_non_differentiable(*output[1 + nc:])

    def backward(ctx, g_y, *g_rest):
        saved = ctx.saved_tensors
        return tuple(backward_op(g_y, *g_rest[:nc], *saved[:n_in],
                                 *saved[n_in:]))

    torch.library.register_autograd(f"repro_torch::{name}", backward,
                                    setup_context=setup_context, lib=_LIB)


for _name in OPS:
    _define(_name)


def _register_rules() -> None:
    """FLOP formulas and DTensor sharding rules of the six ops."""
    from torch.utils.flop_counter import register_flop_formula

    for name, scan in OPS.items():
        nc = scan.n_carry

        def fwd(*args, op=scan, out_shape=None, **kwargs):
            return op.flops(*args)

        def bwd(*args, op=scan, n=nc, out_shape=None, **kwargs):
            return 3 * op.flops(*args[1 + n:-n])

        register_flop_formula(getattr(torch.ops.repro_torch, name))(fwd)
        register_flop_formula(
            getattr(torch.ops.repro_torch, f"{name}_backward"))(bwd)

    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def place(dims):
        return [Replicate() if d is None else
                Partial() if d == "partial" else Shard(d) for d in dims]

    def rules(name, fwd_splits, bwd_splits, heads=None):
        """Register each split of the forward (output placements, input
        placements) and of the backward, beside all-replicated.  With
        ``heads`` = (argument of the forward, of the backward, dim), the
        splits after the first (along the heads) are offered only where
        every mesh axis divides that dim: an uneven head split leaves
        the ops' consumers a strided placement DTensor cannot
        propagate (and the sLSTM's D must split on head boundaries)."""
        n_out = 1 + 2 * OPS[name].n_carry
        n_in = len(_SIGNATURES[name][0])

        def offered(splits, args, at):
            if heads is not None:
                t, dim = args[heads[at]], heads[2]
                if any(t.shape[dim] % t.mesh.size(i)
                       for i in range(t.mesh.ndim)):
                    splits = splits[:1]
            return [(place(o), place(i)) for o, i in splits]

        @register_sharding(getattr(torch.ops.repro_torch, name).default)
        def _fwd(*args):
            return (offered(fwd_splits, args, 0)
                    + [([Replicate()] * n_out, [Replicate()] * n_in)])

        @register_sharding(
            getattr(torch.ops.repro_torch, f"{name}_backward").default)
        def _bwd(*args):
            return (offered(bwd_splits, args, 1)
                    + [([Replicate()] * n_in, [Replicate()] * len(args))])

    P_ = "partial"
    # mamba: (dt, b, c, x, a, h0) → (y, h, h_bounds); its channels are
    # independent, any split of d_inner holds
    rules("mamba_scan",
          [((0, 0, 1), (0, 0, 0, 0, None, 0)),
           ((2, 1, 2), (2, None, None, 2, 0, 1))],
          # (g_y, g_h, dt, b, c, x, a, h0, h_bounds) → (g_dt … g_h0)
          [((0, 0, 0, 0, P_, 0), (0, 0, 0, 0, 0, 0, None, 0, 1)),
           ((2, P_, P_, 2, 0, 1), (2, 1, 2, None, None, 2, 0, 1, 2))])
    # mlstm: (q, k, v, i, f, c0, n0, m0) → (y, c, n, m, bounds × 3); the
    # heads are q's dim 2 (the backward's q is its fifth argument)
    rules("mlstm_scan",
          [((0,) * 4 + (1,) * 3, (0,) * 8),
           ((2,) + (1,) * 3 + (2,) * 3, (2,) * 5 + (1,) * 3)],
          [((0,) * 8, (0,) * 12 + (1,) * 3),
           ((2,) * 5 + (1,) * 3, (2,) + (1,) * 3 + (2,) * 5 + (1,) * 3
            + (2,) * 3)],
          heads=(0, 4, 2))
    # slstm: (z, i, f, o, r × 4, c0, n0, h0, m0) → (y, c, n, h, m,
    # bounds × 4); D splits on head boundaries (the block-diagonal R mixes
    # within a head), the heads being r_z's dim 0 (the forward's fifth
    # argument, the backward's tenth)
    rules("slstm_scan",
          [((0,) * 5 + (1,) * 4, (0,) * 4 + (None,) * 4 + (0,) * 4),
           ((2,) + (1,) * 4 + (2,) * 4, (2,) * 4 + (0,) * 4 + (1,) * 4)],
          [((0,) * 4 + (P_,) * 4 + (0,) * 4,
            (0,) * 5 + (0,) * 4 + (None,) * 4 + (0,) * 4 + (1,) * 4),
           ((2,) * 4 + (0,) * 4 + (1,) * 4,
            (2,) + (1,) * 4 + (2,) * 4 + (0,) * 4 + (1,) * 4 + (2,) * 4)],
          heads=(4, 9, 0))


_register_rules()


def mamba_scan(dt, b, c, x, a, h0):
    """Mamba's selective scan (the op): dt, x (B, S, C) and b, c
    (B, S, N) in the compute type, a (C, N) and h0 (B, C, N) float32 →
    (ys (B, S, C) in x's type, h (B, C, N))."""
    y, h, _ = torch.ops.repro_torch.mamba_scan(dt, b, c, x, a, h0)
    return y, h


def mlstm_scan(q, k, v, i, f, c0, n0, m0):
    """The mLSTM's scan (the op): q, k (B, S, H, dk), v (B, S, H, dv),
    i, f (B, S, H) in the compute type, states float32 → (ys (B, S, H,
    dv) float32, (c, n, m))."""
    y, c, n, m, *_ = torch.ops.repro_torch.mlstm_scan(q, k, v, i, f, c0,
                                                      n0, m0)
    return y, (c, n, m)


def slstm_scan(z, i, f, o, r_z, r_i, r_f, r_o, c0, n0, h0, m0):
    """The sLSTM's scan (the op): z, i, f, o (B, S, D) in the compute
    type, r (H, dh, dh) and the states (B, D) float32 → (ys (B, S, D)
    float32, (c, n, h, m))."""
    y, c, n, h, m, *_ = torch.ops.repro_torch.slstm_scan(
        z, i, f, o, r_z, r_i, r_f, r_o, c0, n0, h0, m0)
    return y, (c, n, h, m)
