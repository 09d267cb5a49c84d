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

:func:`close_live` is the round close as the data plane runs it: the
live rows of both (NUM_CH, cap, G1) host banks folded in place.  Given a
CUDA ``device`` it launches the kernel's second entry once, which reads
and writes the rows where they lie — the banks must be page-locked, so
the card addresses them directly — and nothing is gathered, copied or
scattered; without one it runs the plain version ``close_live_ref`` on
the host.  Its launch counts in :data:`launches` too.
"""
import ctypes
import functools
import os

import numpy as np
import torch

from .. import _build
from .ref import (C_N, C_Q, C_SPAN, N, NUM_CH, PRESPANQ, Q, R, SPANQ,
                  close_live_ref, close_round_inputs_ref)

__all__ = ["close_round", "close_round_inputs", "close_round_xla",
           "close_live", "blocked_cumsum", "stats_update_op", "build",
           "IN_CH", "OUT_CH", "NUM_CH", "SOURCE", "launches"]

# input/output channel orders of :func:`close_round_inputs` — the
# minimal host↔device transfer set for one round close
IN_CH = (N, Q, SPANQ, C_N, C_Q, C_SPAN)    # R/PRESPANQ are fully derived
OUT_CH = (N, Q, R, SPANQ, PRESPANQ)        # collectors reset host-side

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "stats_update.cu")

launches = 0   # kernel launches since import (or the caller's last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's two C launchers."""
    lib = _build.load("stats_update", SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stats_update_launch.argtypes = [ptr, ptr, i32, i32, f32, ptr, i32]
    lib.stats_update_live_launch.argtypes = [ptr, ptr, i32, i32, ptr, i32,
                                             f32, ptr, i32]
    for fn in (lib.stats_update_launch, lib.stats_update_live_launch):
        fn.restype = ctypes.c_int
    return lib


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
    stream = torch.cuda.current_stream(bank6.device).cuda_stream
    err = build().stats_update_launch(bank6.data_ptr(), out.data_ptr(), p,
                                      g1, float(decay), stream,
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


def _live_ids(live, cap: int) -> np.ndarray:
    """``live`` as distinct int32 ids below ``cap``, or raise."""
    ids = np.asarray(live)
    if ids.ndim != 1 or (ids.size and ids.dtype.kind not in "iu"):
        raise TypeError(f"live ids must be a 1-D integer array, got "
                        f"{ids.dtype} of shape {ids.shape}")
    if ids.size and (ids.min() < 0 or ids.max() >= cap):
        raise ValueError(f"live id out of range [0, {cap})")
    ordered = np.sort(ids)
    if (ordered[1:] == ordered[:-1]).any():
        raise ValueError("repeated live id")
    return ids.astype(np.int32)


def close_live(rows: torch.Tensor, cols: torch.Tensor, live,
               decay: float = 0.5, device=None) -> None:
    """Algorithm 2 for rows ``live`` of both (NUM_CH, cap, G1) float32
    host banks, in place; the other rows are not touched.

    With a CUDA ``device``: one launch of the kernel's in-place entry on
    that card's current stream, which reads and writes the banks where
    they lie (they must be page-locked, ``tensor.is_pinned()``); only the
    ids cross to the card.  The banks hold the result once the stream
    has passed the kernel: the caller synchronises before reading them.
    Without one (or with the CPU): the plain version on the host."""
    global launches
    for name, bank in (("rows", rows), ("cols", cols)):
        if bank.dim() != 3 or bank.shape[0] != NUM_CH:
            raise ValueError(f"expected a ({NUM_CH}, cap, G1) {name} bank, "
                             f"got {tuple(bank.shape)}")
        if bank.dtype != torch.float32:
            raise TypeError(f"expected a float32 {name} bank, got "
                            f"{bank.dtype}")
        if not bank.is_contiguous():
            raise ValueError(f"the {name} bank must be C-contiguous")
        if bank.device.type != "cpu":
            raise ValueError(f"the banks live on the host, {name} is on "
                             f"{bank.device}")
    if rows.shape != cols.shape:
        raise ValueError(f"rows {tuple(rows.shape)} and cols "
                         f"{tuple(cols.shape)} differ")
    _, cap, g1 = rows.shape
    ids = _live_ids(live, cap)
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        close_live_ref(rows, cols, ids, decay)
        return
    if device.type != "cuda":
        raise ValueError(f"no stats_update kernel for {device}")
    if not (rows.is_pinned() and cols.is_pinned()):
        raise ValueError("the card folds the banks in place: both must be "
                         "page-locked (pin_memory)")
    if len(ids) == 0 or g1 == 0:
        return
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    live = torch.from_numpy(ids).to(device, non_blocking=True)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = build().stats_update_live_launch(
        rows.data_ptr(), cols.data_ptr(), cap, g1, live.data_ptr(), len(ids),
        float(decay), stream, index)
    if err:
        raise RuntimeError(f"stats_update in-place launch failed: CUDA "
                           f"error {err}")
    launches += 1


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
