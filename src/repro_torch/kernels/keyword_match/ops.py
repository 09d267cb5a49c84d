"""Public wrapper for the fused spatial-keyword pub/sub join (kernel K3).

:func:`keyword_match` has the contract of the JAX package's
``kernels/keyword_match/ops.py:keyword_match``: points (N, 2), tuple
masks (N, T), rects (Q, 4) and subscription masks (Q, T), the masks
exact 0/1 float32 bucket indicators (``bucket_masks`` /
``TermHasher.sub_masks``), in; (deliveries per point (N,), matches per
subscription (Q,)) int32 out.  On a CUDA tensor it launches the
hand-written kernels in ``keyword_match.cu`` (built with nvcc at first
use: the masks packed into 32-bit words, then the match) or raises; on
a CPU tensor it runs the plain PyTorch version in ``ref.py``.
``launches`` counts the calls that launched the match kernel, so a run
can show it went through the kernel.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from ..spatial_match.ops import aligned, check_inputs
from .ref import keyword_match_ref

__all__ = ["keyword_match", "build", "SOURCE", "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "keyword_match.cu")

launches = 0   # match-kernel launches since import (or the last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernels' C launcher."""
    fn = _build.load("keyword_match", SOURCE).keyword_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def keyword_match(points: torch.Tensor, pt_masks: torch.Tensor,
                  rects: torch.Tensor, sub_masks: torch.Tensor):
    """points (N, 2), pt_masks (N, T), rects (Q, 4), sub_masks (Q, T)
    float32 → (int32 (N,), int32 (Q,))."""
    global launches
    check_inputs(points, rects)
    n, q = points.shape[0], rects.shape[0]
    t = pt_masks.shape[-1]
    if pt_masks.shape != (n, t) or sub_masks.shape != (q, t):
        raise ValueError(f"expected (N, T) and (Q, T) masks for N={n}, "
                         f"Q={q}, got {tuple(pt_masks.shape)} and "
                         f"{tuple(sub_masks.shape)}")
    for m in (pt_masks, sub_masks):
        if m.dtype != torch.float32:
            raise TypeError(f"expected float32 masks, got {m.dtype}")
        if m.device != points.device:
            raise ValueError(f"masks on {m.device}, points on "
                             f"{points.device}")
    if points.device.type == "cpu":
        return keyword_match_ref(points, pt_masks, rects, sub_masks)
    pcnt = torch.zeros(n, dtype=torch.int32, device=points.device)
    qcnt = torch.zeros(q, dtype=torch.int32, device=points.device)
    if n == 0 or q == 0:
        return pcnt, qcnt
    if t == 0:                       # no buckets: every subscription is a
        t = 1                        # wildcard, one all-zero word each
        pt_masks = pt_masks.new_zeros((n, 1))
        sub_masks = sub_masks.new_zeros((q, 1))
    words = -(-t // 32)
    points, rects = aligned(points, 2), aligned(rects, 4)
    pt_masks, sub_masks = aligned(pt_masks, 1), aligned(sub_masks, 1)
    pwords = torch.empty((n, words), dtype=torch.int32, device=points.device)
    swords = torch.empty((q, words), dtype=torch.int32, device=points.device)
    fn = build()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = fn(points.data_ptr(), pt_masks.data_ptr(), rects.data_ptr(),
             sub_masks.data_ptr(), n, q, t, pwords.data_ptr(),
             swords.data_ptr(), pcnt.data_ptr(), qcnt.data_ptr(), stream,
             points.device.index)
    if err:
        raise RuntimeError(f"keyword_match launch failed: CUDA error {err}")
    launches += 1
    return pcnt, qcnt
