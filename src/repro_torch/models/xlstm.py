"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent mixing), per arXiv:2405.04517.

The JAX package's ``models/xlstm.py`` in PyTorch, op for op.  Both
recurrences are ops, ``repro_torch::mlstm_scan`` and
``repro_torch::slstm_scan`` (``scan_ops``: loops over the time axis),
with exp-gate max-stabilizers; their states are float32
and the stabiliser ``m`` starts at −1e30.  The gate pre-activations
ride in the compute type and are upcast per step; the sLSTM's recurrent
matrices ``r_{z,i,f,o}`` are used in float32.  The sigmoid is
``jax.nn.sigmoid``'s formula (``layers.sigmoid``).  The mLSTM divides its
keys by ``sqrt(dk)`` taken in the compute type (bfloat16 gives 22.625
at dk = 512), a constant computed on the host.

Decode is the O(1) single-step update.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import P, _proj, leaf, no_constraint, sigmoid
from .scan_ops import mlstm_scan, slstm_scan


def _dims(cfg: ModelConfig):
    x = cfg.xlstm
    h = cfg.num_heads
    up = int(cfg.d_model * x.proj_factor)   # mLSTM inner width
    d_qk = int(up * x.qk_dim_factor)
    d_v = up
    return x, h, d_qk // h, d_v // h, d_qk, d_v


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_spec(cfg: ModelConfig):
    x, h, dk, dv, d_qk, d_v = _dims(cfg)
    d = cfg.d_model
    up = d_v
    return {
        "up_proj": leaf((d, 2 * up), (P.EMBED, P.FF)),
        "wq": leaf((up, h, dk), (P.FF, P.HEADS, P.HEAD_DIM)),
        "wk": leaf((up, h, dk), (P.FF, P.HEADS, P.HEAD_DIM)),
        "wv": leaf((up, h, dv), (P.FF, P.HEADS, P.HEAD_DIM)),
        "w_i": leaf((up, h), (P.FF, P.HEADS)),
        "w_f": leaf((up, h), (P.FF, P.HEADS)),
        "w_o": leaf((up, up), (P.FF, P.FF)),
        "down_proj": leaf((up, d), (P.FF, P.EMBED)),
    }


def _sqrt_in(n: int, dtype: torch.dtype) -> float:
    """sqrt(n) rounded to ``dtype``, computed on the host (a device
    scalar would cost a synchronous copy per call)."""
    return float(torch.tensor(n, dtype=dtype).sqrt())


def mlstm_block(p, x, cfg: ModelConfig, state=None, constraint=None):
    """x (B, S, D) → (out, state).  state = (C (B,H,dk,dv), n (B,H,dk),
    m (B,H)) fp32."""
    cons = constraint or no_constraint
    _, h, dk, dv, _, _ = _dims(cfg)
    dtype = x.dtype
    b, s, _ = x.shape
    u, z = (x @ p["up_proj"].to(dtype)).chunk(2, -1)
    u = cons(u, ("batch", None, "ff"))
    q = _proj(u, p["wq"], dtype)                         # (B, S, H, dk)
    k = _proj(u, p["wk"], dtype) / _sqrt_in(dk, dtype)
    v = _proj(u, p["wv"], dtype)
    i_pre = u @ p["w_i"].to(dtype)                       # (B, S, H)
    f_pre = u @ p["w_f"].to(dtype)

    if state is None:
        c0 = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((b, h, dk), dtype=torch.float32, device=x.device)
        m0 = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
    else:
        c0, n0, m0 = state

    ys, state_out = mlstm_scan(q, k, v, i_pre, f_pre, c0, n0, m0)
    # a sharded run places the scan's output and the output gate as the
    # down projection expects them (DTensor would otherwise split them
    # along the batch or the sequence on "model", which the product's
    # flattened rows cannot carry)
    y = cons(ys.reshape(b, s, -1), ("batch", None, "ff")).to(dtype)
    o = sigmoid(cons(u @ p["w_o"].to(dtype), ("batch", None, "ff")))
    return (cons((y * o) @ p["down_proj"].to(dtype), ("batch", None, "embed")),
            state_out)


def mlstm_state_spec(cfg: ModelConfig, batch: int):
    _, h, dk, dv, _, _ = _dims(cfg)
    return ((batch, h, dk, dv), (batch, h, dk), (batch, h))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def slstm_spec(cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    gates = {}
    for g in GATES:
        gates[f"w_{g}"] = leaf((d, d), (P.EMBED, P.FF))
        gates[f"r_{g}"] = leaf((h, dh, dh), (P.HEADS, None, None))
        gates[f"b_{g}"] = leaf((d,), (P.FF,))
    gates["out_proj"] = leaf((d, d), (P.FF, P.EMBED))
    return gates


def slstm_block(p, x, cfg: ModelConfig, state=None, constraint=None):
    """Scalar-memory LSTM with per-head recurrent mixing (block-diagonal
    R).  state = (c, n, h_prev, m) each (B, D) fp32."""
    cons = constraint or no_constraint
    dtype = x.dtype
    b, s, d = x.shape
    pre = {g: x @ p[f"w_{g}"].to(dtype) + p[f"b_{g}"].to(dtype)
           for g in GATES}
    r = {g: p[f"r_{g}"].float() for g in GATES}

    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        c0, n0, h0 = zeros, zeros, zeros
        m0 = torch.full((b, d), -1e30, dtype=torch.float32, device=x.device)
    else:
        c0, n0, h0, m0 = state

    # the op splits along the batch, or along D on head boundaries where
    # every mesh axis divides the heads
    ys, state_out = slstm_scan(*(pre[g] for g in GATES),
                               *(r[g] for g in GATES), c0, n0, h0, m0)
    y = cons(ys, ("batch", None, "ff")).to(dtype)
    out = cons(y @ p["out_proj"].to(dtype), ("batch", None, "embed"))
    return out, state_out


def slstm_state_spec(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    return ((batch, d), (batch, d), (batch, d), (batch, d))
