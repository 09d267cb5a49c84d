"""Public wrapper for the continuous-kNN result-set update (kernel K4).

:func:`knn_match` has the contract of the JAX package's
``kernels/knn_match/ops.py:knn_match``: points (N, 2) and foci (Q, 2)
in, (Q, k) float32 ascending squared distances out, for any
``1 <= k <= N``.  It reaches the kernels through the ``torch.library``
op ``repro_torch::knn_match`` (a plain ``Library`` definition): its
CUDA implementation launches the hand-written kernels in
``knn_match.cu`` (built with nvcc at first use; ``k`` up to
:data:`MAX_K`, its register lists' cap), over the foci in a spatial
order (:func:`spatial_order`), or raises, its CPU implementation is the
plain PyTorch version in ``ref.py`` for any k, and its fake gives the
output's shape.  ``launches`` counts the kernel launches, inside the
CUDA implementation, so a run can show it went through the kernels,
and ``launches_by_kernel`` splits them by kernel: a launch
whose points are split runs ``knn_match_kernel`` and then
``knn_merge_kernel``.  The constants the kernel is sized with are
stated here and reach the ``.cu`` as nvcc defines (:data:`DEFINES`).
"""
import ctypes
import functools
import os

import torch

from .. import _build
from ..spatial_match.ops import aligned
from .ref import knn_match_ref

__all__ = ["knn_match", "launch", "build", "bind", "defines",
           "spatial_order", "SOURCE", "MAX_K", "KERNELS", "launches",
           "launches_by_kernel"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "knn_match.cu")
MAX_K = 32     # kMaxK of knn_match.cu: the card's lists hold k = 1 … 32

THREADS = 128  # threads a block
FOCI = 4       # R, foci a thread to k = 16 (half that past it)
TILE = 2048    # points staged in shared memory a pass (16 KB)
# blocks a launch aims at: six an SM of the H100's 132, one wave (at 40
# registers a thread up to sixteen fit); the points are split only as
# far as that needs, since every split fills its lists from empty
BLOCKS = 132 * 6
MIN_SPLIT = 256  # fewest points worth a split
GRID = 1024    # cells a side of the grid the foci are ordered on

# the kernels of knn_match.cu: the lists of a split, their merge
KERNELS = ("knn_match_kernel", "knn_merge_kernel")

launches = 0   # kernel launches since import (or the caller's last reset)
launches_by_kernel = dict.fromkeys(KERNELS, 0)   # the same, by kernel


def defines(foci: int = FOCI, blocks: int = BLOCKS) -> tuple:
    """nvcc's defines of ``knn_match.cu``'s constants (R = ``foci`` to
    k = 16, launches aimed at ``blocks`` blocks)."""
    return (f"-DKNN_MATCH_THREADS={THREADS}", f"-DKNN_MATCH_FOCI={foci}",
            f"-DKNN_MATCH_TILE={TILE}", f"-DKNN_MATCH_BLOCKS={blocks}",
            f"-DKNN_MATCH_MIN_SPLIT={MIN_SPLIT}")


DEFINES = defines()


def bind(lib: ctypes.CDLL):
    """The C launcher of a built ``knn_match.cu`` and the size of its
    scratch, with their argument types."""
    fn = lib.knn_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    scratch = lib.knn_match_scratch
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    return fn, scratch


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher and the size
    of its scratch."""
    return bind(_build.load("knn_match", SOURCE, _build.FLAGS + DEFINES))


def knn_match(points: torch.Tensor, foci: torch.Tensor, k: int = 8):
    """points (N, 2), foci (Q, 2) float32 → (Q, k) float32."""
    for name, t in (("points", points), ("foci", foci)):
        if t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"expected (·, 2) {name}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
    if points.device != foci.device:
        raise ValueError(f"points on {points.device}, foci on {foci.device}")
    n = points.shape[0]
    if k < 1:
        raise ValueError(f"k={k}: kNN needs k >= 1")
    if n < k:
        raise ValueError(f"k={k} nearest points asked of a batch of {n}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no knn_match kernel for {points.device}")
    if points.device.type == "cuda" and k > MAX_K:
        raise ValueError(f"k={k}: the kNN kernel on the card keeps "
                         f"1 <= k <= {MAX_K}")
    return torch.ops.repro_torch.knn_match(points, foci, k)


def _knn_cuda(points, foci, k):
    """The op on CUDA tensors: the match kernel and, where the points
    are split, the merge."""
    return launch(build(), points, foci, k)


def _knn_fake(points, foci, k):
    return points.new_empty((foci.shape[0], k))


# K4 as the op ``repro_torch::knn_match``
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("knn_match(Tensor points, Tensor foci, int k) -> Tensor")
_LIB.impl("knn_match", _knn_cuda, "CUDA")
_LIB.impl("knn_match", knn_match_ref, "CPU")
torch.library.register_fake("repro_torch::knn_match", _knn_fake, lib=_LIB)


@functools.lru_cache(maxsize=None)
def _spread(device: torch.device) -> torch.Tensor:
    """(GRID,) int32: bit i of a cell index moved to bit 2i."""
    cells = torch.arange(GRID, dtype=torch.int32)
    out = torch.zeros(GRID, dtype=torch.int32)
    for i in range(GRID.bit_length() - 1):
        out |= ((cells >> i) & 1) << (2 * i)
    return out.to(device)


def spatial_order(foci: torch.Tensor) -> torch.Tensor:
    """The foci's rows in Morton (Z) order of a GRID × GRID grid over
    their bounding box, int64: neighbours in the order are neighbours in
    space.  Any order gives the same distances; this one makes the foci
    of a warp close, so a point that enters one list tends to enter the
    others' too, and the kernel's warp vote wins for fewer groups."""
    lo, hi = torch.aminmax(foci, dim=0)
    scale = (GRID - 1) / (hi - lo).clamp_min(1e-30)
    cell = ((foci - lo) * scale).to(torch.int32).clamp_(0, GRID - 1)
    spread = _spread(foci.device)
    return torch.argsort(spread[cell[:, 0]] | (spread[cell[:, 1]] << 1))


def launch(kernel, points, foci, k: int):
    """The k smallest distances over checked CUDA inputs by ``kernel``,
    the :func:`bind` of a build (:func:`knn_match` passes the shipped
    build; ``variants.py`` scratch builds), the foci taken in
    :func:`spatial_order`."""
    global launches
    n, q = points.shape[0], foci.shape[0]
    out = torch.empty((q, k), dtype=torch.float32, device=points.device)
    if q == 0:
        return out
    points, foci = aligned(points, 2), aligned(foci, 2)
    fn, scratch_len = kernel
    # scratch only where the points are split, and then a merge follows
    scratch = torch.empty(scratch_len(n, q, k), dtype=torch.float32,
                          device=points.device)
    order = spatial_order(foci)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = fn(points.data_ptr(), foci.data_ptr(), order.data_ptr(), n, q, k,
             out.data_ptr(), scratch.data_ptr(), stream, points.device.index)
    if err:
        raise RuntimeError(f"knn_match launch failed: CUDA error {err}")
    kernels = KERNELS[:1 + (scratch.numel() > 0)]
    for name in kernels:
        launches_by_kernel[name] += 1
    launches += len(kernels)
    return out
