"""Mamba (selective SSM) block — the SSM mixer of the jamba hybrid.

The JAX package's ``models/mamba.py`` in PyTorch, op for op.  The
selective scan over the sequence is the op ``repro_torch::mamba_scan``
(``scan_ops.mamba_scan``: a loop over the time axis) with the
(B, d_inner, d_state) float32 state as carry; no (S, d_inner, d_state)
tensor is ever materialized.  The scan's inputs ride in the compute type and are
upcast per step, as in the reference ("xs ride in bf16"): skipping that
rounding drifts from it in bfloat16.  ``a = −exp(a_log)``,
``dt_proj_b`` and ``d_skip`` are used in float32; the causal conv is the
reference's shifted multiply-add sum in the compute type, and SiLU is
``jax.nn.silu``'s formula (``layers.silu``).

Decode is the O(1) single-step state update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import P, leaf, no_constraint, silu
from .scan_ops import mamba_scan


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or (cfg.d_model + 15) // 16
    return m, d_inner, dt_rank


def mamba_spec(cfg: ModelConfig):
    m, d_inner, dt_rank = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": leaf((d, 2 * d_inner), (P.EMBED, P.FF)),
        "conv_w": leaf((m.d_conv, d_inner), (None, P.FF)),
        "conv_b": leaf((d_inner,), (P.FF,)),
        "x_proj": leaf((d_inner, dt_rank + 2 * m.d_state), (P.FF, None)),
        "dt_proj_w": leaf((dt_rank, d_inner), (None, P.FF)),
        "dt_proj_b": leaf((d_inner,), (P.FF,)),
        "a_log": leaf((d_inner, m.d_state), (P.FF, None)),
        "d_skip": leaf((d_inner,), (P.FF,)),
        "out_proj": leaf((d_inner, d), (P.FF, P.EMBED)),
    }


def _ssm_inputs(p, xz, cfg: ModelConfig, constraint=None):
    """Shared pre-scan computation.  xz (B, S, d_inner) post-conv/silu →
    (dt, a, b_t, c_t), all float32.  A sharded run completes the x
    projection's partial sum over d_inner here, where DTensor would
    otherwise choose per product (one torch version asks for a sharded
    operand as a partial one, which it cannot make)."""
    cons = constraint or no_constraint
    m, d_inner, dt_rank = _dims(cfg)
    proj = cons(xz @ p["x_proj"].to(xz.dtype), ("batch", None, None))
    dt_in = proj[..., :dt_rank]
    b_t = proj[..., dt_rank:dt_rank + m.d_state].float()
    c_t = proj[..., dt_rank + m.d_state:].float()
    dt = F.softplus((dt_in @ p["dt_proj_w"].to(xz.dtype)).float()
                    + p["dt_proj_b"].float())
    a = -torch.exp(p["a_log"].float())                   # (d_inner, d_state)
    return dt, a, b_t, c_t


def _conv1d(p, x, d_conv: int, state=None):
    """Causal depthwise conv.  x (B, S, C).  With ``state`` (B, d_conv−1,
    C) runs incrementally; returns (y, new_state)."""
    if state is not None:
        window = torch.cat([state, x], 1)               # (B, d_conv-1+S, C)
    else:
        window = F.pad(x, (0, 0, d_conv - 1, 0))
    new_state = window[:, -(d_conv - 1):]
    w = p["conv_w"].to(x.dtype)                         # (d_conv, C)
    s = x.shape[1]
    y = sum(window[:, i:i + s] * w[i] for i in range(d_conv))
    return y + p["conv_b"].to(x.dtype), new_state


def mamba_block(p, x, cfg: ModelConfig, state=None, constraint=None):
    """x (B, S, d_model) → (out, new_state).

    state = (ssm_h (B, d_inner, d_state) f32, conv (B, d_conv−1, d_inner))
    for incremental decode; None for full-sequence processing."""
    cons = constraint or no_constraint
    m, d_inner, _ = _dims(cfg)
    dtype = x.dtype
    xi, z = (x @ p["in_proj"].to(dtype)).chunk(2, -1)
    xi = cons(xi, ("batch", None, "ff"))
    conv_state = state[1] if state is not None else None
    xi, new_conv = _conv1d(p, xi, m.d_conv, conv_state)
    xi = silu(xi)
    dt, a, b_t, c_t = _ssm_inputs(p, xi, cfg, cons)

    h0 = (state[0] if state is not None
          else torch.zeros((x.shape[0], d_inner, m.d_state),
                           dtype=torch.float32, device=x.device))

    ys, h_last = mamba_scan(*(t.to(dtype) for t in (dt, b_t, c_t, xi)), a,
                            h0)
    y = ys.float() + xi.float() * p["d_skip"].float()
    y = y.to(dtype) * silu(z)
    return (cons(y @ p["out_proj"].to(dtype), ("batch", None, "embed")),
            (h_last, new_conv))


def mamba_state_spec(cfg: ModelConfig, batch: int):
    m, d_inner, _ = _dims(cfg)
    return ((batch, d_inner, m.d_state), (batch, m.d_conv - 1, d_inner))
