"""Public wrapper for blocked forward attention (kernel K6).

:func:`flash_attention` has the contract of the JAX package's
``kernels/flash_attention/ops.py:flash_attention``: q (B, H, S, D), k and
v (B, Hkv, Skv, D), float32 or bfloat16, out (B, H, S, D) in q's type,
with GQA, causal and sliding-window masks and a decode ``q_offset``.  It
takes the true S and Skv (no padding to a block multiple), so it also
serves non-causal attention, which the JAX wrapper refuses when it would
pad.  Each tensor may be a strided view whose last dimension is
contiguous — a (B, S, H, D) projection seen as (B, H, S, D), or the
first Skv rows of a longer KV cache — and is read in place; the output
has q's strides.  On a CUDA tensor it launches the hand-written kernel
in ``flash_attention.cu`` (built with nvcc at first use; D one of
:data:`HEAD_DIMS`) or raises; on a CPU tensor it runs the plain PyTorch
version in ``ref.py``.  bfloat16 inputs with S > :data:`ROW_MAX` go to
the tensor-core kernel, which copies rows with 16-byte ``cp.async``:
each row of q, k and v must start on 16 bytes (a misaligned view raises
``ValueError``; nothing is copied to fix it).  ``launches`` counts the
kernel launches, so a run can show it went through the kernel.
"""
import ctypes
import functools
import math
import os

import torch

from .. import _build
from .ref import attention_ref

__all__ = ["flash_attention", "build", "SOURCE", "HEAD_DIMS", "ROW_MAX",
           "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "flash_attention.cu")
# the head dims flash_attention.cu is instantiated for: every attention
# config of the repo (80 h2o-danube, 128, 256 gemma) and 16, the smoke
# variants' width (starcoder2's smoke has 12 and runs on the CPU only)
HEAD_DIMS = (16, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_MAX = 4    # kRowMax: longest S that takes the row (decode) kernel

launches = 0   # kernel launches since import (or the caller's last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher; multiply-adds
    contract to FMAs (the kernel is held to a tolerance)."""
    fn = _build.load("flash_attention", SOURCE,
                     _build.FMA_FLAGS).flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, S, D) and k, v (B, Hkv, Skv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, D, or H % Hkv)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected float32 or bfloat16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: a sliding window keeps >= 1 key")


def _check_aligned(*tensors):
    """The tensor-core kernel's 16-byte row copies: every row of each
    tensor starts on 16 bytes (its base, and its batch, head and row
    strides in multiples of 8 bfloat16 elements where the dimension has
    more than one index)."""
    for name, t in zip("qkv", tensors):
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"{name}: bfloat16 rows must start on 16 bytes for the "
                f"tensor-core kernel (data_ptr % 16 = {t.data_ptr() % 16}, "
                f"strides {tuple(t.stride())})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, Hkv, Skv, D) → (B, H, S, D) in q's type.
    ``q_offset`` is the absolute position of q's first row (a decode
    step's cache offset)."""
    global launches
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the attention kernel is built for "
                         f"D in {HEAD_DIMS}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16 and s > ROW_MAX:
        _check_aligned(q, k, v)
    out = torch.empty_like(q)      # q's strides where q is dense
    if s == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out)
                                        for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), b, h, k.shape[1], s, k.shape[2],
                  d, DTYPES[q.dtype], int(causal), window or 0, q_offset,
                  1.0 / math.sqrt(d), stream, q.device.index)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
