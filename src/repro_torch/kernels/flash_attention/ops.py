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
has q's strides.  On a CUDA tensor it launches the hand-written kernels
in ``flash_attention.cu`` (built with nvcc at first use) or raises; on
a CPU tensor it runs the plain PyTorch version in ``ref.py``.  The
kernels are built for D in :data:`HEAD_DIMS`; any other D up to 256 is
zero-padded to the next built one (contiguous copies, scaled by the true
1/sqrt(D)) and the output sliced back, and a larger D raises.  S up to
:data:`ROW_MAX` (a decode step) goes to the flash-decoding kernel, which
loads K and V rows as 16-byte vectors: a k or v view whose rows do not
start on 16 bytes is copied first.  bfloat16 inputs with larger S go to
the tensor-core kernel, which copies rows with 16-byte ``cp.async``:
each row of q, k and v must start on 16 bytes (a misaligned view raises
``ValueError``; nothing is copied to fix it).  ``launches`` counts the
kernel launches, so a run can show it went through the kernels, and
``launches_by_kernel`` splits them by kernel: a decode step of more than
one key chunk launches ``flash_decode`` and then ``flash_merge``.
"""
import ctypes
import functools
import math
import os

import torch
import torch.nn.functional as F

from .. import _build
from .ref import attention_ref

__all__ = ["flash_attention", "launch", "build", "bind", "decode_chunks",
           "padded_head_dim", "SOURCE", "HEAD_DIMS", "ROW_MAX", "KERNELS",
           "launches", "launches_by_kernel"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "flash_attention.cu")
# the head dims flash_attention.cu is instantiated for: every attention
# config of the repo (80 h2o-danube, 128, 256 gemma) and 16, the smoke
# variants' width; any other D up to 256 is zero-padded to the next one
HEAD_DIMS = (16, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_MAX = 4    # kRowMax: longest S that takes the decode kernel
# the kernels of flash_attention.cu: decode (S <= ROW_MAX) and its merge,
# the float32 tile kernel and the bf16 tensor-core kernel (longer S)
KERNELS = ("flash_decode", "flash_merge", "flash_tile", "flash_mma")

launches = 0   # kernel launches since import (or the caller's last reset)
launches_by_kernel = dict.fromkeys(KERNELS, 0)   # the same, by kernel


def bind(lib: ctypes.CDLL):
    """The C launcher of a built ``flash_attention.cu``, its decode chunk
    count and the size of a decode step's scratch, with their argument
    types."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    chunks = lib.flash_decode_chunks
    chunks.argtypes = [ctypes.c_int] * 11
    chunks.restype = ctypes.c_int
    scratch = lib.flash_decode_scratch
    scratch.argtypes = [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    return fn, chunks, scratch


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernels' C launcher; multiply-adds
    contract to FMAs (the kernel is held to a tolerance)."""
    return bind(_build.load("flash_attention", SOURCE, _build.FMA_FLAGS))


def padded_head_dim(d: int) -> int:
    """The built head dim a D is computed at: D itself if built, else
    the next larger one (the inputs zero-padded); above 256 raises."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"head dim {d}: the attention kernel takes D up to "
                     f"{HEAD_DIMS[-1]}")


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (…, D) zero-padded along D to ``width``: a contiguous copy,
    whose rows start on 16 bytes.  Zero columns add nothing to q·k and
    give zero output columns, which are sliced off."""
    return F.pad(t, (0, width - t.shape[-1])).contiguous()


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


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on 16 bytes: its base, and its batch,
    head and row strides in whole 16-byte vectors where the dimension
    has more than one index."""
    strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % step == 0 for st in strides)


def _check_aligned(*tensors):
    """The tensor-core kernel's 16-byte row copies: every row of each
    bfloat16 tensor starts on 16 bytes."""
    for name, t in zip("qkv", tensors):
        if not _rows_aligned(t):
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
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    d = q.shape[3]
    width = padded_head_dim(d)
    if width == d:
        return launch(build(), q, k, v, causal=causal, window=window,
                      q_offset=q_offset)
    out = launch(build(), *(pad_head_dim(t, width) for t in (q, k, v)),
                 causal=causal, window=window, q_offset=q_offset,
                 scale=1.0 / math.sqrt(d))
    return torch.empty_like(q).copy_(out[..., :d])


def decode_chunks(kernel, q, k, *, causal: bool = True, window=None,
                  q_offset: int = 0) -> int:
    """The key chunks ``kernel`` (a :func:`bind`) splits a decode step
    (S <= ROW_MAX) of checked CUDA inputs into: the library's count,
    from the card's occupancy and the keys the rows see."""
    b, h, s, d = q.shape
    chunks = kernel[1](b, h, k.shape[1], s, k.shape[2], d, DTYPES[q.dtype],
                       int(causal), window or 0, q_offset, q.device.index)
    if chunks < 1:
        raise RuntimeError("flash_attention: the card's occupancy query "
                           "failed")
    return chunks


def launch(kernel, q, k, v, *, causal: bool = True, window=None,
           q_offset: int = 0, scale: float | None = None):
    """Attention over checked CUDA inputs at a built head dim by
    ``kernel``, the :func:`bind` of a build (:func:`flash_attention`
    passes the shipped build; ``variants.py`` others).  ``scale``
    defaults to 1/sqrt(D)."""
    global launches
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if s == 0:
        return torch.empty_like(q)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)      # q's strides where q is dense
    fn, _, scratch_len = kernel
    chunks, scratch = 1, None
    if s <= ROW_MAX:
        # the decode kernel's 16-byte K/V loads: a view whose rows are
        # off 16 bytes is copied (the serve path's cache never is)
        k, v = (t if _rows_aligned(t) else
                t.clone(memory_format=torch.contiguous_format)
                for t in (k, v))
        chunks = decode_chunks(kernel, q, k, causal=causal, window=window,
                               q_offset=q_offset)
        if chunks > 1:
            scratch = torch.empty(scratch_len(b, h, s, d, chunks),
                                  dtype=torch.float32, device=q.device)
        kernels = KERNELS[:1 + (chunks > 1)]
    elif q.dtype == torch.bfloat16:
        _check_aligned(q, k, v)
        kernels = ("flash_mma",)
    else:
        kernels = ("flash_tile",)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out)
                                        for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), b, h, hkv, s, skv, d,
             DTYPES[q.dtype], int(causal), window or 0, q_offset,
             1.0 / math.sqrt(d) if scale is None else scale, chunks,
             None if scratch is None else scratch.data_ptr(), stream,
             q.device.index)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    for name in kernels:
        launches_by_kernel[name] += 1
    launches += len(kernels)
    return out
