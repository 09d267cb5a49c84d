"""Public wrapper for the fused spatial-keyword pub/sub join (kernel K3).

:func:`keyword_match` has the contract of the JAX package's
``kernels/keyword_match/ops.py:keyword_match``: points (N, 2), tuple
masks (N, T), rects (Q, 4) and subscription masks (Q, T), the masks
exact 0/1 float32 bucket indicators (``bucket_masks`` /
``TermHasher.sub_masks``), in; (deliveries per point (N,), matches per
subscription (Q,)) int32 out.  It reaches the kernels through the
``torch.library`` op ``repro_torch::keyword_match`` (a plain ``Library``
definition): its CUDA implementation launches the hand-written kernels
in ``keyword_match.cu`` (built with nvcc at first use: the masks packed
into 32-bit words and the rects into order-preserving keys, then the
match) or raises, its CPU implementation is the plain PyTorch version
in ``ref.py``, and its fake gives the outputs' shapes and type.
``launches`` counts the calls that launched the match kernel, inside
the CUDA implementation, so a run can show it went through the kernel.  The launch geometry is chosen
here (:func:`geometry`): tuple tiles of THREADS·R tuples on the grid's
x axis, groups of consecutive subscription chunks on its y axis.  The
constants it sizes them with reach the kernel as nvcc defines
(:data:`DEFINES`), so they are stated here alone.
"""
import ctypes
import functools
import os

import torch

from .. import _build
from ..spatial_match.ops import aligned, check_inputs, counts_fake
from .ref import keyword_match_ref

__all__ = ["keyword_match", "launch", "build", "bind", "geometry",
           "tuples_per_thread", "defines", "SOURCE", "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "keyword_match.cu")

launches = 0   # match-kernel launches since import (or the last reset)

THREADS, CHUNK = 256, 512   # threads a block; subscriptions a chunk
# R, tuples a thread: 8 with one mask word; past it the kernel's word
# tests hold more registers, and 4 keeps four blocks an SM
TUPLES_PER_THREAD, MULTI_WORD_TUPLES_PER_THREAD = 8, 4
# blocks a launch aims at: about two dozen waves of four blocks an SM of
# the H100's 132, so the last, partial wave costs a few per cent
TARGET_BLOCKS = 132 * 4 * 24


def defines(r: int = TUPLES_PER_THREAD,
            r_multi: int = MULTI_WORD_TUPLES_PER_THREAD) -> tuple:
    """nvcc's defines of ``keyword_match.cu``'s constants (R = ``r``
    with one mask word, ``r_multi`` past it)."""
    return (f"-DKEYWORD_MATCH_THREADS={THREADS}",
            f"-DKEYWORD_MATCH_CHUNK={CHUNK}",
            f"-DKEYWORD_MATCH_TUPLES={r}",
            f"-DKEYWORD_MATCH_MULTI_WORD_TUPLES={r_multi}")


DEFINES = defines()


def tuples_per_thread(t: int) -> int:
    """R of the shipped kernel at ``t`` buckets."""
    return TUPLES_PER_THREAD if t <= 32 else MULTI_WORD_TUPLES_PER_THREAD


def geometry(n: int, q: int, r: int, target: int = TARGET_BLOCKS
             ) -> tuple[int, int, int]:
    """(tiles, groups, per) of a launch over ``n`` tuples and ``q``
    subscriptions at ``r`` tuples a thread: tile x holds tuples
    [x·THREADS·r, (x+1)·THREADS·r), group y the subscription chunks
    [y·per, (y+1)·per) of CHUNK subscriptions each; about ``target``
    blocks, every group holds at least one chunk, and groups ≤ 65535."""
    tiles = -(-n // (THREADS * r))
    chunks = -(-q // CHUNK)
    groups = min(chunks, 65535, max(1, -(-target // tiles)))
    per = -(-chunks // groups)
    return tiles, -(-chunks // per), per


def bind(lib: ctypes.CDLL):
    """The C launcher of a built ``keyword_match.cu`` and the size of its
    subscription scratch, with their argument types."""
    fn = lib.keyword_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    scratch = lib.keyword_match_sub_scratch
    scratch.argtypes = [ctypes.c_int] * 2
    scratch.restype = ctypes.c_longlong
    return fn, scratch


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernels' C launcher and the size
    of its subscription scratch."""
    return bind(_build.load("keyword_match", SOURCE,
                            _build.FLAGS + DEFINES))


def keyword_match(points: torch.Tensor, pt_masks: torch.Tensor,
                  rects: torch.Tensor, sub_masks: torch.Tensor):
    """points (N, 2), pt_masks (N, T), rects (Q, 4), sub_masks (Q, T)
    float32 → (int32 (N,), int32 (Q,))."""
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
    return tuple(torch.ops.repro_torch.keyword_match(points, pt_masks,
                                                     rects, sub_masks))


def _match_cuda(points, pt_masks, rects, sub_masks):
    """The op on CUDA tensors: the packers and the match kernel."""
    return launch(build(), tuples_per_thread(pt_masks.shape[-1]),
                  TARGET_BLOCKS, points, pt_masks, rects, sub_masks)


# K3 as the op ``repro_torch::keyword_match``
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("keyword_match(Tensor points, Tensor pt_masks, Tensor rects, "
            "Tensor sub_masks) -> (Tensor, Tensor)")
_LIB.impl("keyword_match", _match_cuda, "CUDA")
_LIB.impl("keyword_match", keyword_match_ref, "CPU")
torch.library.register_fake(
    "repro_torch::keyword_match",
    lambda points, pt_masks, rects, sub_masks: counts_fake(points, rects),
    lib=_LIB)


def launch(kernel, r: int, target: int, points, pt_masks, rects,
           sub_masks):
    """The match over checked CUDA inputs by ``kernel``, the :func:`bind`
    of a build whose R at these masks' word count is ``r``, its grid
    aimed at ``target`` blocks (:func:`keyword_match` passes the shipped
    build and constants; ``variants.py`` scratch builds)."""
    global launches
    n, q, t = points.shape[0], rects.shape[0], pt_masks.shape[1]
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
    fn, scratch = kernel
    pwords = torch.empty((n, words), dtype=torch.int32, device=points.device)
    sub = torch.empty(scratch(q, t), dtype=torch.int32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = fn(points.data_ptr(), pt_masks.data_ptr(), rects.data_ptr(),
             sub_masks.data_ptr(), n, q, t, *geometry(n, q, r, target),
             pwords.data_ptr(), sub.data_ptr(), pcnt.data_ptr(),
             qcnt.data_ptr(), stream, points.device.index)
    if err:
        raise RuntimeError(f"keyword_match launch failed: CUDA error {err}")
    launches += 1
    return pcnt, qcnt
