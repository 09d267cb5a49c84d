"""Plain PyTorch version of the fused spatial-keyword pub/sub join.

Mirrors the JAX package's ``kernels/keyword_match/ref.py``: a
subscription matches a tuple iff the tuple lies inside the
subscription's rectangle (inclusive, as ``spatial_match``) AND the
tuple's bucket mask covers the subscription's — ``miss = (1 − pm) @
smᵀ`` in float32 counts the buckets the subscription needs that the
tuple lacks, and the conjunction holds iff ``miss < 0.5``.  Masks are
(·, T) float32 0/1; an all-zero subscription mask is a wildcard.  The
(N, Q) blocks are built in chunks of subscriptions so that they fit on
the card at full size.  With 0/1 inputs and a float32 accumulator the
miss count is exact whatever the matmul precision (TF32 keeps 0 and 1
exact, and the sums are integers up to T).
"""
import torch

from ..spatial_match.ref import chunk_len, inside_block


def keyword_match_ref(points, pt_masks, rects, sub_masks):
    """points (N, 2), pt_masks (N, T), rects (Q, 4), sub_masks (Q, T)
    float32 → (deliveries per point (N,), matches per subscription (Q,))
    int32."""
    n, q = points.shape[0], rects.shape[0]
    pcnt = torch.zeros(n, dtype=torch.int32, device=points.device)
    qcnt = torch.zeros(q, dtype=torch.int32, device=points.device)
    inv = 1.0 - pt_masks
    step = chunk_len(n)
    for lo in range(0, q, step):
        # 0/1 operands, float32 accumulator: exact at any matmul precision
        miss = inv @ sub_masks[lo:lo + step].T  # swarmlint: disable=SWM006
        hit = inside_block(points, rects[lo:lo + step]) & (miss < 0.5)
        pcnt += hit.sum(1, dtype=torch.int32)
        qcnt[lo:lo + step] = hit.sum(0, dtype=torch.int32)
    return pcnt, qcnt
