"""Plain PyTorch version of the continuous-kNN result-set update.

Mirrors the JAX package's ``kernels/knn_match/ref.py``: per focal point
the k smallest squared Euclidean distances to the batch, ascending,
duplicates each counted.  The squared distance is written ``dx*dx +
dy*dy`` with ``dx = fx − px`` (the reference's term order): each
product rounded, then the sum, so the CUDA kernel, which rounds the
same way, equals it bit for bit.  Foci are taken in chunks so that the
(chunk, N) distance block fits on the card at full size.
"""
import torch

from ..spatial_match.ref import chunk_len


def knn_match_ref(points, foci, k: int):
    """points (N, 2), foci (Q, 2) float32 → (Q, k) float32 ascending
    squared distances (requires k <= N)."""
    out = []
    step = chunk_len(points.shape[0])
    for lo in range(0, foci.shape[0], step):
        f = foci[lo:lo + step]
        dx = f[:, 0][:, None] - points[:, 0][None, :]
        dy = f[:, 1][:, None] - points[:, 1][None, :]
        d = dx * dx + dy * dy
        out.append(torch.topk(d, k, dim=1, largest=False, sorted=True).values)
    if not out:
        return foci.new_zeros((0, k))
    return torch.cat(out)
