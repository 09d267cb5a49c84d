"""Public wrapper for the inclusive point-in-rectangle join (kernel K2).

:func:`spatial_match` has the contract of the JAX package's
``kernels/spatial_match/ops.py:spatial_match``: points (N, 2) and rects
(Q, 4) = (x0, y0, x1, y1) in, (per-point matches (N,), per-rect matches
(Q,)) int32 out.  It reaches the kernel through the ``torch.library``
op ``repro_torch::spatial_match`` (a plain ``Library`` definition): its
CUDA implementation launches the hand-written kernel in
``spatial_match.cu`` (built with nvcc at first use) or raises, its CPU
implementation is the plain PyTorch version in ``ref.py``, and its fake
gives the outputs' shapes and type.  ``launches`` counts the kernel
launches, inside the CUDA implementation, so a run can show it went
through the kernel.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from .ref import spatial_match_ref

__all__ = ["spatial_match", "build", "SOURCE", "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "spatial_match.cu")
MAX_RECTS = 65535 * 1024     # rect chunks tile the launch grid's y axis

launches = 0   # kernel launches since import (or the caller's last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher."""
    fn = _build.load("spatial_match", SOURCE).spatial_match_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def aligned(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as a contiguous tensor whose rows start on a ``width``-float
    boundary, the vector width the kernels load a row with (a copy only
    when ``t`` is a strided or offset view)."""
    if not t.is_contiguous() or t.data_ptr() % (4 * width):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def check_inputs(points: torch.Tensor, rects: torch.Tensor) -> None:
    """Shapes, type and device shared by K2 and K3."""
    if points.dim() != 2 or points.shape[1] != 2:
        raise ValueError(f"expected (N, 2) points, got {tuple(points.shape)}")
    if rects.dim() != 2 or rects.shape[1] != 4:
        raise ValueError(f"expected (Q, 4) rects, got {tuple(rects.shape)}")
    for t in (points, rects):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
    if points.device != rects.device:
        raise ValueError(f"points on {points.device}, rects on "
                         f"{rects.device}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no match kernel for {points.device}")
    if points.device.type == "cuda" and rects.shape[0] > MAX_RECTS:
        raise ValueError(f"at most {MAX_RECTS} rects per launch, got "
                         f"{rects.shape[0]}")


def spatial_match(points: torch.Tensor, rects: torch.Tensor):
    """points (N, 2), rects (Q, 4) float32 → (int32 (N,), int32 (Q,))."""
    check_inputs(points, rects)
    return tuple(torch.ops.repro_torch.spatial_match(points, rects))


def _match_cuda(points, rects):
    """The op on CUDA tensors: one launch of the kernel."""
    global launches
    n, q = points.shape[0], rects.shape[0]
    pcnt = torch.zeros(n, dtype=torch.int32, device=points.device)
    qcnt = torch.zeros(q, dtype=torch.int32, device=points.device)
    if n == 0 or q == 0:
        return pcnt, qcnt
    points, rects = aligned(points, 2), aligned(rects, 4)
    fn = build()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = fn(points.data_ptr(), rects.data_ptr(), n, q, pcnt.data_ptr(),
             qcnt.data_ptr(), stream, points.device.index)
    if err:
        raise RuntimeError(f"spatial_match launch failed: CUDA error {err}")
    launches += 1
    return pcnt, qcnt


def counts_fake(points, rects):
    """The fake of K2's op (and K3's, past its masks): (N,) and (Q,)
    int32."""
    return (points.new_empty((points.shape[0],), dtype=torch.int32),
            points.new_empty((rects.shape[0],), dtype=torch.int32))


# K2 as the op ``repro_torch::spatial_match``
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("spatial_match(Tensor points, Tensor rects) -> (Tensor, Tensor)")
_LIB.impl("spatial_match", _match_cuda, "CUDA")
_LIB.impl("spatial_match", spatial_match_ref, "CPU")
torch.library.register_fake("repro_torch::spatial_match", counts_fake,
                            lib=_LIB)
