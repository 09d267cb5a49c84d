"""Public wrapper for the expert-assignment histogram (kernel K5).

:func:`moe_histogram` has the contract of the JAX package's
``kernels/moe_histogram/ops.py:moe_histogram``: expert ids (T, K) int32
and gates (T, K) float32 in, per-expert assignment counts and
gate-weighted load, each (E,) float32, out; id −1 matches nothing.  On a
CUDA tensor it launches the hand-written kernel in ``moe_histogram.cu``
(built with nvcc at first use; E up to :data:`MAX_EXPERTS`) or raises;
on a CPU tensor it runs the plain PyTorch version in ``ref.py``.
``launches`` counts the kernel launches, so a run can show it went
through the kernel.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from .ref import moe_histogram_ref

__all__ = ["moe_histogram", "build", "SOURCE", "MAX_EXPERTS", "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "moe_histogram.cu")
MAX_EXPERTS = 4096   # kMaxE of moe_histogram.cu: its per-block bins, 32 KB

launches = 0   # kernel launches since import (or the caller's last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher and the block
    count that sizes its scratch."""
    lib = _build.load("moe_histogram", SOURCE)
    fn = lib.moe_histogram_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    blocks = lib.moe_histogram_blocks
    blocks.argtypes = [ctypes.c_int]
    blocks.restype = ctypes.c_int
    return fn, blocks


def moe_histogram(idx: torch.Tensor, gates: torch.Tensor, *,
                  num_experts: int):
    """idx (T, K) int32, gates (T, K) float32 → (counts (E,), load (E,))
    float32."""
    global launches
    if idx.shape != gates.shape or idx.dim() != 2:
        raise ValueError(f"expected (T, K) ids and gates, got "
                         f"{tuple(idx.shape)} and {tuple(gates.shape)}")
    if idx.dtype != torch.int32 or gates.dtype != torch.float32:
        raise TypeError(f"expected int32 ids and float32 gates, got "
                        f"{idx.dtype} and {gates.dtype}")
    if idx.device != gates.device:
        raise ValueError(f"ids on {idx.device}, gates on {gates.device}")
    if not 1 <= num_experts <= MAX_EXPERTS:
        raise ValueError(f"num_experts={num_experts}: the histogram kernel "
                         f"supports 1 … {MAX_EXPERTS} experts")
    if idx.device.type == "cpu":
        return moe_histogram_ref(idx, gates, num_experts)
    if idx.device.type != "cuda":
        raise ValueError(f"no moe_histogram kernel for {idx.device}")
    idx, gates = idx.contiguous(), gates.contiguous()
    n = idx.numel()
    fn, blocks = build()
    dev = idx.device
    counts_i = torch.empty(num_experts, dtype=torch.int32, device=dev)
    part = torch.empty((blocks(n), num_experts), dtype=torch.float32,
                       device=dev)
    counts = torch.empty(num_experts, dtype=torch.float32, device=dev)
    load = torch.empty(num_experts, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(idx.data_ptr(), gates.data_ptr(), n, num_experts,
             counts_i.data_ptr(), part.data_ptr(), counts.data_ptr(),
             load.data_ptr(), stream, dev.index)
    if err:
        raise RuntimeError(f"moe_histogram launch failed: CUDA error {err}")
    launches += 1
    return counts, load
