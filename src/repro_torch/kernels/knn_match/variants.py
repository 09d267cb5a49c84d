"""Time K4 (``knn_match``) against variants of its source and another
commit's kernel on one card, at phase ``match``'s tick of
``chip_smoke.py``: 131 072 points of the main path's hotspot peak tick
against the centres of its 100 000 standing queries (the
``uniform_normal`` source, seed 0), at k = 8 and again at k = 32.

    PYTHONPATH=src python -m repro_torch.kernels.knn_match.variants \\
        [--source NAME=PATH ...] [--sass PATH]

Variants of the shipped kernel (:data:`VARIANTS`) are scratch builds of
its source with another R (foci a thread to k = 16, an nvcc define),
launches aimed at another block count (so another number of point
splits), the design before the warp vote (a branch for each focus's
group test), or the foci taken in their given order instead of the
spatial one (the kernel reads focus f and writes row f, ignoring the
order the wrapper still computes), run through the wrapper's own
:func:`ops.launch`; with
``--source`` another ``knn_match.cu`` with the earlier C launcher (its
split count from ``knn_match_splits(n, q)``, (splits, q, k) scratch) is
built and timed as NAME — for the parent commit's kernel, unpack it
first (``git show <commit>:src/repro_torch/kernels/knn_match/knn_match.cu
> _checkout/knn_match_parent.cu``).  Every variant is held to the plain
version (equal bit for bit) and timed with CUDA events: REPS trials of
CALLS back-to-back calls each, the variants taking turns trial by trial
in alternating order.  Prints the card's name and power limit, then one
JSON line per case and variant: the median, least and largest ms per
call over the trials, and the point splits; and the time of the foci's
spatial order alone (part of every launch of the shipped source).
With ``--sass PATH`` it also writes the shipped kernels' SASS
(``cuobjdump``) to PATH, for counting what a pair issues.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from .. import _build
from ..flash_attention.variants import _trial
from . import ops
from .ref import knn_match_ref, list_len

VOTE = """      if (__any_sync(~0u, win)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d0 = dist(c[r], a.x, a.y);
          const float d1 = dist(c[r], a.z, a.w);
          const float d2 = dist(c[r], b.x, b.y);
          const float d3 = dist(c[r], b.z, b.w);
          if (fminf(fminf(d0, d1), fminf(d2, d3)) < best[r][K - 1]) {"""
# the design before the vote: each focus's group test its own branch
BRANCH = """      (void)win;
      {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d0 = dist(c[r], a.x, a.y);
          const float d1 = dist(c[r], a.z, a.w);
          const float d2 = dist(c[r], b.x, b.y);
          const float d3 = dist(c[r], b.z, b.w);
          if (fminf(fminf(d0, d1), fminf(d2, d3)) < best[r][K - 1]) {"""
# the foci as given: focus f read from row f, its list written to row f
GIVEN = (("? foci[order[f]] :", "? foci[f] :"),
         ("out_row ? out_row[f] : f", "f"),
         ("static_cast<size_t>(order[f]) * k", "static_cast<size_t>(f) * k"))
# name → (R to k = 16, blocks a launch aims at, source edits (old, new))
VARIANTS = {
    "shipped": (ops.FOCI, ops.BLOCKS, ()),
    "given_order": (ops.FOCI, ops.BLOCKS, GIVEN),
    "branch_a_focus": (ops.FOCI, ops.BLOCKS, ((VOTE, BRANCH),)),
    "r8": (8, ops.BLOCKS, ()),
    "blocks/2": (ops.FOCI, ops.BLOCKS // 2, ()),
}
REPS, CALLS = 11, 3
KS = (8, 32)


def match_tick(device):
    """(points, foci) of phase ``match``'s tick on ``device``."""
    import numpy as np

    import repro_torch.streaming as T
    src = T.scenario("uniform_normal", seed=0, horizon=96)
    rects = np.asarray(src.sample_queries(100_000), np.float32)
    pts = np.asarray(src.sample_points(131_072, 48), np.float32)
    foci = np.stack([(rects[:, 0] + rects[:, 2]) * 0.5,
                     (rects[:, 1] + rects[:, 3]) * 0.5], 1).astype(np.float32)
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(foci).to(device))


def _variant(name: str, foci: int, blocks: int, edits):
    """A call of the shipped source built with R = ``foci``, launches
    aimed at ``blocks`` blocks and ``edits`` ((old, new) texts) applied;
    and its split count at (n, q, k)."""
    flags = ops.defines(foci, blocks)
    if not edits and flags == ops.DEFINES:
        kernel = ops.build()
    else:
        path = ops.SOURCE
        if edits:
            with open(ops.SOURCE) as f:
                text = f.read()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} not in "
                                       f"the source")
                text = text.replace(old, new)
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            path = os.path.join(_build.BUILD_DIR, f"knn_match_{name}.cu")
            with open(path, "w") as f:
                f.write(text)
        kernel = ops.bind(_build.load(f"knn_match_{name.replace('/', '_')}",
                                      path, _build.FLAGS + flags))

    def call(pts, foci_, k):
        return ops.launch(kernel, pts, foci_, k)

    def splits(n, q, k):
        return max(1, kernel[1](n, q, k) // (q * list_len(k)))
    return call, splits


def _earlier(name: str, path: str):
    """A call of another commit's kernel through its own C launcher."""
    lib = _build.load(f"knn_match_{name}", path)
    fn = lib.knn_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    count = lib.knn_match_splits
    count.argtypes = [ctypes.c_int] * 2
    count.restype = ctypes.c_int

    def call(pts, foci, k):
        n, q, dev = pts.shape[0], foci.shape[0], pts.device
        out = torch.empty((q, k), dtype=torch.float32, device=dev)
        s = count(n, q)
        scratch = (torch.empty((s, q, k), dtype=torch.float32, device=dev)
                   if s > 1 else out)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pts.data_ptr(), foci.data_ptr(), n, q, k, out.data_ptr(),
                 scratch.data_ptr(), stream, dev.index)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return call, lambda n, q, k: count(n, q)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another knn_match.cu as variant NAME")
    ap.add_argument("--sass", metavar="PATH",
                    help="write the shipped kernels' SASS to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    calls = {name: _variant(name, *v) for name, v in VARIANTS.items()}
    if args.sass:
        lib = _build.load("knn_match", ops.SOURCE,
                          _build.FLAGS + ops.DEFINES)._name
        tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            f.write(subprocess.run([tool, "-sass", lib], capture_output=True,
                                   text=True, check=True).stdout)
    for spec in args.source:
        name, path = spec.split("=", 1)
        calls[name] = _earlier(name, os.path.abspath(path))
    pts, foci = match_tick(torch.device("cuda"))
    n, q = pts.shape[0], foci.shape[0]
    order = [_trial(lambda: ops.spatial_order(foci), CALLS)
             for _ in range(REPS + 1)][1:]
    print(json.dumps({"case": "match tick", "variant": "spatial_order alone",
                      "ms": statistics.median(order), "min_ms": min(order),
                      "max_ms": max(order)}), flush=True)
    for k in KS:
        want = knn_match_ref(pts, foci, k)
        # another commit's kernel may stop at k = 16, the earlier cap
        names = [name for name in calls if k <= 16 or name in VARIANTS]
        times = {name: [] for name in names}
        for rep in range(REPS + 1):                   # trial 0 warms up
            for name in (names if rep % 2 else names[::-1]):
                t = _trial(lambda c=calls[name][0]: c(pts, foci, k), CALLS)
                if rep:
                    times[name].append(t)
        for name in names:
            call, splits = calls[name]
            equal = torch.equal(call(pts, foci, k), want)
            print(json.dumps({"case": f"match tick k={k}", "variant": name,
                              "equal": equal, "splits": splits(n, q, k),
                              "ms": statistics.median(times[name]),
                              "min_ms": min(times[name]),
                              "max_ms": max(times[name])}), flush=True)
            if not equal:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
