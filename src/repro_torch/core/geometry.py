"""Geometry primitives for SWARM: cells, rectangles, clipping.

Space is the unit square [0,1)² discretized into a G×G grid of cells
(paper §4.1.1: "grid cells of a predefined size C1×C2").  Rectangles are
stored *inclusive* in cell coordinates as (r0, c0, r1, c1) with
r0 <= r1, c0 <= c1 — matching the paper's partition borders.

All helpers work on either numpy arrays or torch tensors (the control
plane uses numpy; the data plane's hot path runs on torch tensors on
the device).
"""
from __future__ import annotations

import numpy as np


def points_to_cells(xy, grid_size: int):
    """Map float points in [0,1)² to integer cell coords (row, col).

    xy: (..., 2) array with xy[..., 0]=x (col direction), xy[..., 1]=y
    (row direction).  Returns int32 (row, col) clipped into the grid.
    """
    g = grid_size
    if _backend(xy) is not np:
        return _torch_cells(xy[..., 1], g), _torch_cells(xy[..., 0], g)
    col = np.clip((xy[..., 0] * g).astype(np.int32), 0, g - 1)
    row = np.clip((xy[..., 1] * g).astype(np.int32), 0, g - 1)
    return row, col


def rects_to_cells(rects, grid_size: int):
    """Map float rects (x0, y0, x1, y1) in unit space to inclusive cell
    bounds (r0, c0, r1, c1)."""
    mod = _backend(rects)
    g = grid_size
    if mod is np:
        cells = lambda v: np.clip((v * g).astype(np.int32), 0, g - 1)
    else:
        cells = lambda v: _torch_cells(v, g)
    c0 = cells(rects[..., 0])
    r0 = cells(rects[..., 1])
    # Upper bounds: a rect touching x1 covers the cell containing x1.
    c1 = cells(rects[..., 2])
    r1 = cells(rects[..., 3])
    c1 = mod.maximum(c1, c0)
    r1 = mod.maximum(r1, r0)
    return r0, c0, r1, c1


def boxes_overlap(ar0, ac0, ar1, ac1, br0, bc0, br1, bc1):
    """Inclusive cell-box overlap test; broadcasts."""
    return (ar0 <= br1) & (ar1 >= br0) & (ac0 <= bc1) & (ac1 >= bc0)


def clip_box(qr0, qc0, qr1, qc1, pr0, pc0, pr1, pc1):
    """Clip query box to partition box (assumes overlap); broadcasts."""
    mod = _backend(qr0) if hasattr(qr0, "shape") else np
    return (
        mod.maximum(qr0, pr0),
        mod.maximum(qc0, pc0),
        mod.minimum(qr1, pr1),
        mod.minimum(qc1, pc1),
    )


def box_area(r0, c0, r1, c1):
    return (r1 - r0 + 1) * (c1 - c0 + 1)


def point_in_box(pr, pc, r0, c0, r1, c1):
    return (pr >= r0) & (pr <= r1) & (pc >= c0) & (pc <= c1)


def _backend(x):
    """Pick numpy or torch based on the array type."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return np
    import torch

    return torch


def _torch_cells(v, g: int):
    """Torch form of the cell rule: torch tensors have no ``.astype``
    and ``torch.clip`` wants tensor bounds.  The coordinate is cast to
    float32 before the multiply, as the device planes stage points, so
    a point on a cell border lands in the same cell on every plane."""
    import torch

    return (v.to(torch.float32) * g).to(torch.int32).clamp_(0, g - 1)
