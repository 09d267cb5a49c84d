"""Public wrappers for the Algorithm-2 round close (kernel K1).

:func:`close_round_inputs` has the contract of the JAX package's
``kernels/stats_update/ops.py:close_round_inputs``: the six input
channels of the live rows in, the five maintained channels out (R and
preSpanQ' are fully derived; the collectors are reset by the caller).
It reaches the kernel through the ``torch.library`` op
``repro_torch::stats_update`` (:data:`stats_update_op`, a plain
``Library`` definition as K5's and K6's): its CUDA implementation
launches the hand-written kernel in ``stats_update.cu`` (built with nvcc
at first use) or raises, its CPU implementation is the plain PyTorch
version in ``ref.py``, and its fake gives the output's shape, so the
wrapper traces under ``FakeTensorMode`` (``analysis.kernels``).
``launches`` counts the kernel launches, inside the CUDA
implementation, so a run can show it went through the kernel.

:func:`close_round` has the contract of the JAX package's
``close_round``: the whole (8, P, G1) bank in, the whole bank out with
the collectors zeroed.  It selects :data:`IN_CH`, runs the op and puts
:data:`OUT_CH` back, so on the card it is one K1 launch.
:func:`close_round_xla` is the twin of the JAX package's portable
``close_round_xla``: the same fold in torch ops, each prefix sum
re-associated into a two-level (blocks × width) scan
(:func:`blocked_cumsum`), exact on integer-valued collectors.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from .ref import (C_N, C_Q, C_SPAN, N, NUM_CH, PRESPANQ, Q, R, SPANQ,
                  close_round_inputs_ref)

__all__ = ["close_round", "close_round_inputs", "close_round_xla",
           "blocked_cumsum", "stats_update_op", "build", "IN_CH", "OUT_CH",
           "NUM_CH", "SOURCE", "launches"]

# input/output channel orders of :func:`close_round_inputs` — the
# minimal host↔device transfer set for one round close
IN_CH = (N, Q, SPANQ, C_N, C_Q, C_SPAN)    # R/PRESPANQ are fully derived
OUT_CH = (N, Q, R, SPANQ, PRESPANQ)        # collectors reset host-side

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "stats_update.cu")

launches = 0   # kernel launches since import (or the caller's last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher."""
    fn = _build.load("stats_update", SOURCE).stats_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def close_round_inputs(bank6: torch.Tensor, decay: float = 0.5):
    """Round close of ``bank6`` ((6, P, G1) float32, :data:`IN_CH`
    order) → (5, P, G1) float32 in :data:`OUT_CH` order."""
    if bank6.dim() != 3 or bank6.shape[0] != len(IN_CH):
        raise ValueError(f"expected a (6, P, G1) bank, got "
                         f"{tuple(bank6.shape)}")
    if bank6.dtype != torch.float32:
        raise TypeError(f"expected float32, got {bank6.dtype}")
    if bank6.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stats_update kernel for {bank6.device}")
    if bank6.device.type == "cuda" and not bank6.is_contiguous():
        raise ValueError("stats_update needs a contiguous bank")
    return stats_update_op(bank6, float(decay))


def _close_cuda(bank6, decay):
    """The op on CUDA tensors: one launch of the kernel."""
    global launches
    _, p, g1 = bank6.shape
    out = torch.empty((len(OUT_CH), p, g1), dtype=torch.float32,
                      device=bank6.device)
    if p == 0 or g1 == 0:
        return out
    fn = build()
    stream = torch.cuda.current_stream(bank6.device).cuda_stream
    err = fn(bank6.data_ptr(), out.data_ptr(), p, g1, float(decay), stream,
             bank6.device.index)
    if err:
        raise RuntimeError(f"stats_update launch failed: CUDA error {err}")
    launches += 1
    return out


def _close_fake(bank6, decay):
    return bank6.new_empty((len(OUT_CH), *bank6.shape[1:]))


# K1 as the op ``repro_torch::stats_update``: (6, P, G1) → (5, P, G1)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("stats_update(Tensor bank6, float decay) -> Tensor")
_LIB.impl("stats_update", _close_cuda, "CUDA")
_LIB.impl("stats_update", close_round_inputs_ref, "CPU")
torch.library.register_fake("repro_torch::stats_update", _close_fake,
                            lib=_LIB)
stats_update_op = torch.ops.repro_torch.stats_update.default


def close_round(bank: torch.Tensor, decay: float = 0.5):
    """Algorithm 2 for one whole (NUM_CH, P, G1) float32 bank → the
    updated bank, collectors zeroed: :data:`IN_CH` selected, the op
    (one K1 launch on the card), :data:`OUT_CH` put back."""
    if bank.dim() != 3 or bank.shape[0] != NUM_CH:
        raise ValueError(f"expected a ({NUM_CH}, P, G1) bank, got "
                         f"{tuple(bank.shape)}")
    ch = bank.unbind(0)
    out5 = close_round_inputs(torch.stack([ch[c] for c in IN_CH]), decay)
    out = [torch.zeros_like(ch[0])] * NUM_CH
    for c, plane in zip(OUT_CH, out5.unbind(0)):
        out[c] = plane
    return torch.stack(out)


def blocked_cumsum(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Two-level scan along the last axis of (P, G1) ``x``: within-block
    prefix sums plus the blocks' offsets, the JAX package's
    ``blocked_cumsum`` (exact for integer-valued sums below 2**24)."""
    p, g1 = x.shape
    pad = (-g1) % block
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(p, -1, block)
    inner = torch.cumsum(xb, dim=-1)
    offs = torch.cumsum(inner.select(2, block - 1), dim=-1)
    offs = torch.cat([offs.new_zeros((p, 1)),
                      offs.narrow(1, 0, xb.shape[1] - 1)], dim=1)
    return (inner + offs.unsqueeze(2)).reshape(p, -1).narrow(1, 0, g1)


def close_round_xla(bank: torch.Tensor, decay: float = 0.5,
                    block: int = 128):
    """The twin of the JAX package's ``close_round_xla`` (its portable
    fold for hosts without the TPU kernel), named after it: the whole
    bank's round close in torch ops, each prefix sum a
    :func:`blocked_cumsum`.  No kernel runs."""
    ch = bank.unbind(0)
    cum_n = blocked_cumsum(ch[C_N], block)
    cum_q = blocked_cumsum(ch[C_Q], block)
    span_new = blocked_cumsum(ch[C_SPAN], block)
    zeros = torch.zeros_like(cum_n)
    out = [None] * NUM_CH
    out[N] = ch[N] * decay + cum_n
    out[Q] = ch[Q] + cum_q
    out[R] = cum_n + cum_q
    out[SPANQ] = ch[SPANQ] + span_new
    out[PRESPANQ] = span_new
    out[C_N] = out[C_Q] = out[C_SPAN] = zeros
    return torch.stack(out)
