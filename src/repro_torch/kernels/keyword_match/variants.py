"""Time K3 (``keyword_match``) against variants of its launch and
another commit's kernel on one card, at the pub/sub delivery tick:
20 000 tuples of tick 30 against 1 000 000 standing subscriptions of the
``hot_hashtags`` deployment (seed 0, as ``chip_smoke.py``'s phase
``pubsub`` builds it), at T = 32 buckets and again at T = 4096.

    PYTHONPATH=src python -m repro_torch.kernels.keyword_match.variants \
        [--source NAME=PATH ...]

Variants of the shipped kernel (:data:`VARIANTS`) are scratch builds of
its source with other tuples a thread (R, an nvcc define) or launches
aimed at other block counts, run through the wrapper's own
:func:`ops.launch`; with ``--source`` another ``keyword_match.cu`` with
the earlier C launcher (no geometry, (n, words) and (q, words) scratch)
is built and timed as NAME.
Every variant is held to the plain version (counts equal) and timed
with CUDA events: REPS trials of CALLS back-to-back calls each, the
variants taking turns trial by trial in alternating order.  Prints the
card's name and power limit, then one JSON line per case and variant:
the median, least and largest ms per call over the trials.  With
``--sass PATH`` it also writes the shipped kernels' SASS (``cuobjdump``)
to PATH, for counting what a pair issues.
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
from .ref import keyword_match_ref

# name → (R with one mask word, R past it, blocks a launch aims at)
VARIANTS = {
    "shipped": (ops.TUPLES_PER_THREAD, ops.MULTI_WORD_TUPLES_PER_THREAD,
                ops.TARGET_BLOCKS),
    "r4": (4, 4, ops.TARGET_BLOCKS),
    "blocks/4": (ops.TUPLES_PER_THREAD, ops.MULTI_WORD_TUPLES_PER_THREAD,
                 ops.TARGET_BLOCKS // 4),
    "one_chunk_a_block": (ops.TUPLES_PER_THREAD,
                          ops.MULTI_WORD_TUPLES_PER_THREAD, 1 << 30),
}
REPS, CALLS = 11, 3
N, Q, TICKS = 20_000, 1_000_000, 60     # chip_smoke.py's PS_* constants


def delivery_tick(buckets: int, device):
    """(points, tuple masks, rects, subscription masks) of the delivery
    tick on ``device``, masks built there (1 M × 4096 floats would not
    fit a host copy comfortably)."""
    import numpy as np

    import repro_torch.streaming as T
    wl = T.WorkloadSpec(query_model="spatial_keyword")
    src = T.ScenarioSpec("hot_hashtags", ticks=TICKS, preload_queries=Q,
                         query_burst=0, hot_terms=2, term_peak=0.5
                         ).build(seed=0, workload=wl)
    tick = TICKS // 2
    pts = np.asarray(src.sample_points(N, tick), np.float32)
    terms = src.sample_terms(pts, tick, wl.tuple_terms)
    rects = np.asarray(src.sample_queries(Q), np.float32)
    sub_terms = src.sample_subscription_terms(Q, tick, wl.sub_terms)
    hasher = T.TermHasher(buckets)

    def masks(ids):
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
        out = torch.zeros((ids.shape[0], buckets), device=device)
        return out.scatter_reduce_(1, ids.clamp_min(0), (ids >= 0).float(),
                                   reduce="amax")

    return (torch.from_numpy(pts).to(device),
            masks(hasher.buckets(terms)), torch.from_numpy(rects).to(device),
            masks(hasher.buckets(sub_terms)))


def _variant(r: int, r_multi: int, target: int):
    """A call of the shipped source built with R = ``r`` (``r_multi``
    past one mask word), its launches aimed at ``target`` blocks."""
    flags = ops.defines(r, r_multi)
    kernel = ops.build() if flags == ops.DEFINES else ops.bind(_build.load(
        f"keyword_match_r{r}_{r_multi}", ops.SOURCE, _build.FLAGS + flags))

    def call(pts, pm, rects, sm):
        rr = r if pm.shape[1] <= 32 else r_multi
        return ops.launch(kernel, rr, target, pts, pm, rects, sm)
    return call


def _earlier(name: str, path: str):
    """A call of another commit's kernel through its own C launcher."""
    fn = _build.load(f"keyword_match_{name}", path).keyword_match_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int])
    fn.restype = ctypes.c_int

    def call(pts, pm, rects, sm):
        (n, t), q = pm.shape, rects.shape[0]
        words, dev = -(-t // 32), pts.device
        pcnt = torch.zeros(n, dtype=torch.int32, device=dev)
        qcnt = torch.zeros(q, dtype=torch.int32, device=dev)
        pw = torch.empty((n, words), dtype=torch.int32, device=dev)
        sw = torch.empty((q, words), dtype=torch.int32, device=dev)
        err = fn(pts.data_ptr(), pm.data_ptr(), rects.data_ptr(),
                 sm.data_ptr(), n, q, t, pw.data_ptr(), sw.data_ptr(),
                 pcnt.data_ptr(), qcnt.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return pcnt, qcnt
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another keyword_match.cu as variant NAME")
    ap.add_argument("--sass", metavar="PATH",
                    help="write the shipped kernels' SASS to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    calls = {name: _variant(*v) for name, v in VARIANTS.items()}
    if args.sass:
        lib = _build.load("keyword_match", ops.SOURCE,
                          _build.FLAGS + ops.DEFINES)._name
        tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            f.write(subprocess.run([tool, "-sass", lib], capture_output=True,
                                   text=True, check=True).stdout)
    for spec in args.source:
        name, path = spec.split("=", 1)
        calls[name] = _earlier(name, os.path.abspath(path))
    dev = torch.device("cuda")
    for buckets in (32, 4096):
        inputs = delivery_tick(buckets, dev)
        prev = torch.backends.cuda.matmul.allow_tf32
        # TF32 is exact on the ref's 0/1 masks (float32 accumulate)
        torch.backends.cuda.matmul.allow_tf32 = True  # swarmlint: disable=SWM006
        try:
            want = keyword_match_ref(*inputs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        times = {name: [] for name in calls}
        for rep in range(REPS + 1):                   # trial 0 warms up
            for name in (list(calls) if rep % 2 else list(calls)[::-1]):
                t = _trial(lambda c=calls[name]: c(*inputs), CALLS)
                if rep:
                    times[name].append(t)
        for name, call in calls.items():
            got = call(*inputs)
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            print(json.dumps({"case": f"delivery tick T={buckets}",
                              "variant": name, "equal": equal,
                              "ms": statistics.median(times[name]),
                              "min_ms": min(times[name]),
                              "max_ms": max(times[name])}), flush=True)
            if not equal:
                return 1
        del inputs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
