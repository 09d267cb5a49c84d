"""Public wrapper for the continuous-kNN result-set update (kernel K4).

:func:`knn_match` has the contract of the JAX package's
``kernels/knn_match/ops.py:knn_match``: points (N, 2) and foci (Q, 2)
in, (Q, k) float32 ascending squared distances out, N >= k.  On a CUDA
tensor it launches the hand-written kernel in ``knn_match.cu`` (built
with nvcc at first use; ``k`` from 1 to :data:`MAX_K`) or raises; on a
CPU tensor it runs the plain PyTorch version in ``ref.py``.
``launches`` counts the kernel launches, so a run can show it went
through the kernel.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from ..spatial_match.ops import aligned
from .ref import knn_match_ref

__all__ = ["knn_match", "build", "SOURCE", "MAX_K", "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "knn_match.cu")
MAX_K = 16     # kMaxK of knn_match.cu: its top-k list for k = 1 … 16

launches = 0   # kernel launches since import (or the caller's last reset)


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher and the split
    count that sizes its scratch."""
    lib = _build.load("knn_match", SOURCE)
    fn = lib.knn_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    splits = lib.knn_match_splits
    splits.argtypes = [ctypes.c_int, ctypes.c_int]
    splits.restype = ctypes.c_int
    return fn, splits


def knn_match(points: torch.Tensor, foci: torch.Tensor, k: int = 8):
    """points (N, 2), foci (Q, 2) float32 → (Q, k) float32."""
    global launches
    for name, t in (("points", points), ("foci", foci)):
        if t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"expected (·, 2) {name}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
    if points.device != foci.device:
        raise ValueError(f"points on {points.device}, foci on {foci.device}")
    n, q = points.shape[0], foci.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kNN kernel supports 1 <= k <= {MAX_K}")
    if n < k:
        raise ValueError(f"k={k} nearest points asked of a batch of {n}")
    if points.device.type == "cpu":
        return knn_match_ref(points, foci, k)
    if points.device.type != "cuda":
        raise ValueError(f"no knn_match kernel for {points.device}")
    out = torch.empty((q, k), dtype=torch.float32, device=points.device)
    if q == 0:
        return out
    points, foci = aligned(points, 2), aligned(foci, 2)
    fn, splits = build()
    s = splits(n, q)
    scratch = (torch.empty((s, q, k), dtype=torch.float32,
                           device=points.device) if s > 1 else out)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = fn(points.data_ptr(), foci.data_ptr(), n, q, k, out.data_ptr(),
             scratch.data_ptr(), stream, points.device.index)
    if err:
        raise RuntimeError(f"knn_match launch failed: CUDA error {err}")
    launches += 1
    return out
