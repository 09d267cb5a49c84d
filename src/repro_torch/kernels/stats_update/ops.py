"""Public wrapper for the Algorithm-2 round close (kernel K1).

:func:`close_round_inputs` has the contract of the JAX package's
``kernels/stats_update/ops.py:close_round_inputs``: the six input
channels of the live rows in, the five maintained channels out (R and
preSpanQ' are fully derived; the collectors are reset by the caller).
On a CUDA tensor it launches the hand-written kernel in
``stats_update.cu`` (built with nvcc at first use) or raises; on a CPU
tensor it runs the plain PyTorch version in ``ref.py``.  ``launches``
counts the kernel launches, so a run can show it went through the
kernel.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from .ref import (C_N, C_Q, C_SPAN, N, NUM_CH, PRESPANQ, Q, R, SPANQ,
                  close_round_inputs_ref)

__all__ = ["close_round_inputs", "build", "IN_CH", "OUT_CH", "NUM_CH",
           "SOURCE", "launches"]

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
    global launches
    if bank6.dim() != 3 or bank6.shape[0] != len(IN_CH):
        raise ValueError(f"expected a (6, P, G1) bank, got "
                         f"{tuple(bank6.shape)}")
    if bank6.dtype != torch.float32:
        raise TypeError(f"expected float32, got {bank6.dtype}")
    if bank6.device.type == "cpu":
        return close_round_inputs_ref(bank6, decay)
    if bank6.device.type != "cuda":
        raise ValueError(f"no stats_update kernel for {bank6.device}")
    if not bank6.is_contiguous():
        raise ValueError("stats_update needs a contiguous bank")
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
