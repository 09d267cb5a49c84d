"""Public wrapper for the expert-assignment histogram (kernel K5).

:func:`moe_histogram` has the contract of the JAX package's
``kernels/moe_histogram/ops.py:moe_histogram``: expert ids (T, K) int32
and gates (T, K) float32 in, per-expert assignment counts and
gate-weighted load, each (E,) float32, out; id −1 matches nothing.  On a
CUDA tensor it launches the hand-written kernel in ``moe_histogram.cu``
(built with nvcc at first use; E up to :data:`MAX_EXPERTS`) or raises;
on a CPU tensor it runs the plain PyTorch version in ``ref.py``.  A call
is one kernel launch; its scratch rows and ticket are cached per
(device, stream, E) and the two outputs are rows of one (2, E) tensor.
``launches`` counts the kernel launches, so a run can show it went
through the kernel.  The launch geometry is chosen here
(:func:`geometry`); the constants it is sized with reach the kernel as
nvcc defines (:data:`DEFINES`), so they are stated here alone.

The wrapper reaches the kernel through the ``torch.library`` op
``repro_torch::moe_histogram`` (defined as K6's is) (:func:`histogram_op`, one (2, E) output:
the counts and the load): its CUDA implementation is :func:`launch`, its
CPU implementation the plain version, and the device of the ids
chooses.  It has a fake implementation (no launch) and DTensor sharding
rules: ids and gates sharded along the assignments give each rank its
shard's histogram, a ``Partial`` sum over that mesh axis; or all
replicated.
"""
import ctypes
import functools
import math
import os

import torch

from .. import _build
from .ref import moe_histogram_ref

__all__ = ["moe_histogram", "histogram_op", "launch", "build", "bind",
           "geometry", "SOURCE", "MAX_EXPERTS", "launches"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "moe_histogram.cu")
MAX_EXPERTS = 4096
# warps a block, most; 32-assignment steps a warp, most; dynamic shared
# memory a block: the 48 KB default (no opt-in) less room for the
# kernel's static flag
MAX_WARPS, STEPS, SMEM_BYTES = 16, 8, 47 * 1024
SMS = 132       # the H100's SMs: the blocks a launch aims to spread over
# the constants above as nvcc defines of moe_histogram.cu
DEFINES = (f"-DMOE_HISTOGRAM_MAX_WARPS={MAX_WARPS}",
           f"-DMOE_HISTOGRAM_STEPS={STEPS}",
           f"-DMOE_HISTOGRAM_MAX_EXPERTS={MAX_EXPERTS}",
           f"-DMOE_HISTOGRAM_SMEM_BYTES={SMEM_BYTES}")

launches = 0   # kernel launches since import (or the caller's last reset)

# (device index, stream, E) → [int32 scratch rows, uint32 ticket]
_scratch: dict = {}


def geometry(n: int, e: int) -> tuple[int, int, int, int]:
    """(warps a block, steps, blocks, segments) of a launch over ``n``
    assignments and ``e`` experts.  A block has as many warps as its
    bins fit in SMEM_BYTES (8 bytes an expert and warp, plus 128 bytes of
    gates a warp) and n needs; a warp takes ``steps`` · 32 consecutive
    assignments, as few steps (at most STEPS) as let one wave of SMS
    blocks hold n.  The last block folds the blocks' rows in
    ``segments`` runs of about √blocks rows: at most one run per warp,
    and as many (run, expert) pairs as it has threads."""
    fit = min(MAX_WARPS, max(1, SMEM_BYTES // (8 * e + 128)))
    warps = min(fit, max(1, -(-n // 32)))
    steps = min(STEPS, max(1, -(-n // (SMS * warps * 32))))
    blocks = max(1, -(-n // (warps * steps * 32)))
    segments = max(1, min(32 * warps // e, warps, blocks,
                          math.isqrt(blocks - 1) + 1))
    return warps, steps, blocks, segments


def bind(lib: ctypes.CDLL):
    """The C launcher of a built ``moe_histogram.cu``, with its argument
    types."""
    fn = lib.moe_histogram_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def build():
    """Build (first call) and bind the kernel's C launcher."""
    return bind(_build.load("moe_histogram", SOURCE,
                            _build.FLAGS + DEFINES))


def _rows_and_ticket(dev, stream: int, e: int, blocks: int):
    """The cached scratch of (``dev``, ``stream``, ``e``), its rows grown
    to ``blocks``; the ticket is zeroed once and left zero by every
    launch."""
    key = (dev.index, stream, e)
    entry = _scratch.get(key)
    if entry is None:
        entry = _scratch[key] = [
            torch.empty(0, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev)]
    if entry[0].numel() < 2 * blocks * e:
        entry[0] = torch.empty(2 * blocks * e, dtype=torch.int32, device=dev)
    return entry


def moe_histogram(idx: torch.Tensor, gates: torch.Tensor, *,
                  num_experts: int):
    """idx (T, K) int32, gates (T, K) float32 → (counts (E,), load (E,))
    float32."""
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
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no moe_histogram kernel for {idx.device}")
    counts, load = histogram_op(idx, gates, num_experts).unbind(0)
    return counts, load


def _histogram_cuda(idx, gates, num_experts):
    """The op on CUDA tensors: the kernel, into a new (2, E) tensor."""
    out = torch.empty((2, num_experts), dtype=torch.float32,
                      device=idx.device)
    launch(build(), idx, gates, num_experts, out=out)
    return out


def _histogram_cpu(idx, gates, num_experts):
    return torch.stack(moe_histogram_ref(idx, gates, num_experts))


def _histogram_fake(idx, gates, num_experts):
    return idx.new_empty((2, num_experts), dtype=torch.float32)


# K5 as the op ``repro_torch::moe_histogram``: (2, E) float32, the counts
# then the load (a plain ``Library`` definition: its calls go through the
# C++ dispatcher alone)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("moe_histogram(Tensor idx, Tensor gates, int num_experts) "
            "-> Tensor")
_LIB.impl("moe_histogram", _histogram_cuda, "CUDA")
_LIB.impl("moe_histogram", _histogram_cpu, "CPU")
torch.library.register_fake("repro_torch::moe_histogram", _histogram_fake,
                            lib=_LIB)
histogram_op = torch.ops.repro_torch.moe_histogram.default


def _register_rules() -> None:
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.moe_histogram.default)
    def _histogram_sharding(idx, gates, num_experts):
        return [([Partial()], [Shard(0), Shard(0), None]),
                ([Replicate()], [Replicate(), Replicate(), None])]


_register_rules()


def launch(kernel, idx: torch.Tensor, gates: torch.Tensor,
           num_experts: int, out: torch.Tensor | None = None):
    """The histogram over checked CUDA inputs by ``kernel``, the
    :func:`bind` of a build (:func:`histogram_op` passes the shipped
    build; ``variants.py`` scratch builds of cut sources): (counts,
    load), the rows of ``out`` ((2, E) float32, new by default)."""
    global launches
    idx, gates = idx.contiguous(), gates.contiguous()
    n, e, dev = idx.numel(), num_experts, idx.device
    warps, steps, blocks, segments = geometry(n, e)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, ticket = _rows_and_ticket(dev, stream, e, blocks)
    if out is None:
        out = torch.empty((2, e), dtype=torch.float32, device=dev)
    err = kernel(idx.data_ptr(), gates.data_ptr(), n, e, warps, steps,
                  blocks, segments, rows.data_ptr(), ticket.data_ptr(),
                  out.data_ptr(), stream, dev.index)
    if err:
        raise RuntimeError(f"moe_histogram launch failed: CUDA error {err}")
    launches += 1
    return out[0], out[1]
