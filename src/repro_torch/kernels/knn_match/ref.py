"""Plain PyTorch version of the continuous-kNN result-set update.

Mirrors the JAX package's ``kernels/knn_match/ref.py``: per focal point
the k smallest squared Euclidean distances to the batch, ascending,
duplicates each counted.  The squared distance is written ``dx*dx +
dy*dy`` with ``dx = fx − px`` (the reference's term order): each
product rounded, then the sum, so the CUDA kernel, which rounds the
same way, equals it bit for bit.  Foci are taken in chunks so that the
(chunk, N) distance block fits on the card at full size.

:func:`knn_match_split_ref` writes out the kernel's split-then-merge
(each split of the points keeps its own list, a merge takes the k
smallest of the lists), which equals the whole computation bit for bit.
"""
import torch

from ..spatial_match.ref import chunk_len


def _distances(points, foci):
    dx = foci[:, 0][:, None] - points[:, 0][None, :]
    dy = foci[:, 1][:, None] - points[:, 1][None, :]
    return dx * dx + dy * dy


def knn_match_ref(points, foci, k: int):
    """points (N, 2), foci (Q, 2) float32 → (Q, k) float32 ascending
    squared distances (requires k <= N)."""
    out = []
    step = chunk_len(points.shape[0])
    for lo in range(0, foci.shape[0], step):
        d = _distances(points, foci[lo:lo + step])
        out.append(torch.topk(d, k, dim=1, largest=False, sorted=True).values)
    if not out:
        return foci.new_zeros((0, k))
    return torch.cat(out)


def list_len(k: int) -> int:
    """The length of the kernel's list that serves ``k``: k itself up
    to 16, then 24 or 32 (``knn_match.cu``'s ``list_len``)."""
    return k if k <= 16 else 24 if k <= 24 else 32


def knn_match_split_ref(points, foci, k: int, splits: int):
    """The kernel's order of work: split s keeps the ``list_len(k)``
    smallest distances to points [s·per, (s+1)·per), per = ⌈N/splits⌉,
    padded with +inf where the split holds fewer points; the merge keeps
    the k smallest of the splits' lists, ascending."""
    n, q, kl = points.shape[0], foci.shape[0], list_len(k)
    per = -(-n // splits)
    lists = []
    for s in range(splits):
        d = _distances(points[s * per:(s + 1) * per], foci)
        best = torch.topk(d, min(kl, d.shape[1]), dim=1, largest=False,
                          sorted=True).values
        pad = foci.new_full((q, kl - best.shape[1]), float("inf"))
        lists.append(torch.cat([best, pad], 1))
    merged = torch.cat(lists, 1)
    return torch.topk(merged, k, dim=1, largest=False, sorted=True).values
