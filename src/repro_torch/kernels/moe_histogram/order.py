"""K5's float32 sum order, written out in NumPy.

``moe_histogram.cu`` adds each expert's gates in one fixed order, set
by the number of assignments and experts alone (:func:`ops.geometry`):

1. a warp takes ``steps`` · 32 consecutive assignments and adds each
   expert's gates into its own bin, starting from 0, in index order;
2. a block adds its warps' bins as a tree: while h > 1 warps remain,
   warp w + ⌈h/2⌉ is added into warp w, for w < h − ⌈h/2⌉ — with one
   block, warp 0's bins are the load;
3. otherwise the last block adds the blocks' rows in ``segments`` runs
   of consecutive blocks (run s takes blocks ⌊s·B/S⌋ … ⌊(s+1)·B/S⌋ − 1),
   each in block order from 0, then the runs in order from 0.

:func:`moe_histogram_order` performs that sequence of float32 adds, so
the tests can hold it to the plain version and the card can hold the
kernel to it bit for bit.
"""
import numpy as np

from .ops import geometry


def moe_histogram_order(idx, gates, num_experts: int):
    """idx (T, K) int, gates (T, K) float32 arrays → (counts (E,), load
    (E,)) float32, the load summed in the kernel's order."""
    e = num_experts
    idx = np.asarray(idx).reshape(-1).astype(np.int64)
    gates = np.asarray(gates, np.float32).reshape(-1)
    warps, steps, blocks, segments = geometry(idx.size, e)
    keep = (idx >= 0) & (idx < e)
    counts = np.bincount(idx[keep], minlength=e).astype(np.float32)

    # 1. warp bins: the r-th gate of each (warp, expert) added in round r
    cell = np.arange(idx.size) // (steps * 32)       # block · warps + warp
    key = cell[keep] * e + idx[keep]
    val = gates[keep]
    order = np.argsort(key, kind="stable")           # index order in a key
    key, val = key[order], val[order]
    first = np.r_[True, key[1:] != key[:-1]]
    rank = np.arange(key.size) - np.maximum.accumulate(
        np.where(first, np.arange(key.size), 0))
    bins = np.zeros(blocks * warps * e, np.float32)
    for r in range(int(rank.max()) + 1 if rank.size else 0):
        at = rank == r                               # distinct keys
        bins[key[at]] = bins[key[at]] + val[at]
    bins = bins.reshape(blocks, warps, e)

    # 2. each block's warps as a tree
    h = warps
    while h > 1:
        half = (h + 1) // 2
        bins[:, :h - half] = bins[:, :h - half] + bins[:, half:h]
        h = half
    rows = bins[:, 0]
    if blocks == 1:
        return counts, rows[0]

    # 3. the rows in runs of consecutive blocks, then the runs
    load = np.zeros(e, np.float32)
    for s in range(segments):
        run = np.zeros(e, np.float32)
        for b in range(s * blocks // segments, (s + 1) * blocks // segments):
            run = run + rows[b]
        load = load + run
    return counts, load
