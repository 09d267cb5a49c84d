"""Plain PyTorch version of the inclusive point-in-rectangle join.

Mirrors the JAX package's ``kernels/spatial_match/ref.py``: point
``(px, py)`` lies in rect ``(x0, y0, x1, y1)`` iff ``px >= x0 and
px <= x1 and py >= y0 and py <= y1`` in float32.  The CPU path of the
port runs this; on the card it is what the CUDA kernel is held
against.  The (N, Q) containment matrix is built in chunks of rects,
as ``NumpyPlane.match_counts`` does, so that it fits on the card at
full size.
"""
import torch

# elements of one (N, chunk) block of pairs
CHUNK_ELEMS = 1 << 26


def chunk_len(n: int) -> int:
    """Rows of the other side per block of pairs with ``n`` points (at
    least one)."""
    return max(1, CHUNK_ELEMS // max(n, 1))


def inside_block(points, rects):
    """(N, Q) bool inclusive containment of ``points`` (N, 2) in
    ``rects`` (Q, 4)."""
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    return ((px >= rects[:, 0][None, :]) & (px <= rects[:, 2][None, :])
            & (py >= rects[:, 1][None, :]) & (py <= rects[:, 3][None, :]))


def spatial_match_ref(points, rects):
    """points (N, 2), rects (Q, 4) float32 → (per-point matches (N,),
    per-rect matches (Q,)) int32."""
    n, q = points.shape[0], rects.shape[0]
    pcnt = torch.zeros(n, dtype=torch.int32, device=points.device)
    qcnt = torch.zeros(q, dtype=torch.int32, device=points.device)
    step = chunk_len(n)
    for lo in range(0, q, step):
        hit = inside_block(points, rects[lo:lo + step])
        pcnt += hit.sum(1, dtype=torch.int32)
        qcnt[lo:lo + step] = hit.sum(0, dtype=torch.int32)
    return pcnt, qcnt
