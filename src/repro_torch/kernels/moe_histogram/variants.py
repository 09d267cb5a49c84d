"""Time K5 (``moe_histogram``) against another commit's kernel and
against cuts of its own on one card, at the serve path's two inputs of
qwen2-moe-a2.7b (60 experts, top-4): a prefill of 50 × 1024 tokens
(204 800 assignments) and a decode call of 50 tokens (200), ids and
gates drawn from a seed with a tenth of the ids −1; beside them one
empty kernel (``torch.cuda._sleep(0)``), the floor under a launch.

    PYTHONPATH=src python -m repro_torch.kernels.moe_histogram.variants \
        [--source NAME=PATH ...]

Each cut (:data:`CUTS`) is the shipped source ending at one stage, so
the differences between them say where a call's time goes; their
outputs are wrong by design and not checked.  ``--source`` builds
another ``moe_histogram.cu`` with the earlier C launcher (int32 count
and (blocks, E) load scratch, a memset and two kernels) and times it as
NAME, its scratch allocated per call as the earlier wrapper did.  Every
other variant is held to the plain version (counts equal, load within
rtol 1e-5).  All are timed with CUDA events: REPS trials of CALLS
back-to-back calls each, queued behind a device sleep so that the
host's launch overhead opens no gaps, the variants taking turns trial
by trial in alternating order.  Prints the card's name and power limit,
then one JSON line per case and variant: the median, least and largest
µs per call over the trials.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..flash_attention.variants import _trial
from . import ops
from .ref import moe_histogram_ref

REPS, CALLS = 21, 20
E = 60
# name → (text of the shipped source, its replacement): the kernel ends
# before its warps' steps (its loads then unused, so dropped: the
# launch), after the steps, after writing its block's row, after
# drawing its ticket (no fold)
TREE = "  // the warps' bins as a tree"
CUTS = {
    "cut: launch": ("  __syncthreads();\n\n  float* my_load",
                    "  if (n >= 0) return;\n  __syncthreads();\n\n"
                    "  float* my_load"),
    "cut: steps": (TREE, "  if (n >= 0) return;\n" + TREE),
    "cut: rows": ("  // the last block to finish folds every block's row\n",
                  "  if (n >= 0) return;\n"),
    "cut: ticket": ("  if (!s_last) return;\n", "  return;\n"),
}
CASES = (("qwen2-moe serve prefill", 51200, 4),
         ("qwen2-moe serve decode", 50, 4))


def _earlier(name: str, path: str):
    """A call of another commit's kernel through its own C launcher."""
    lib = _build.load(f"moe_histogram_{name}", path)
    fn = lib.moe_histogram_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    blocks = lib.moe_histogram_blocks
    blocks.argtypes, blocks.restype = [ctypes.c_int], ctypes.c_int

    def call(idx, gates, *, num_experts):
        n, e, dev = idx.numel(), num_experts, idx.device
        counts_i = torch.empty(e, dtype=torch.int32, device=dev)
        part = torch.empty((blocks(n), e), dtype=torch.float32, device=dev)
        counts = torch.empty(e, dtype=torch.float32, device=dev)
        load = torch.empty(e, dtype=torch.float32, device=dev)
        err = fn(idx.data_ptr(), gates.data_ptr(), n, e, counts_i.data_ptr(),
                 part.data_ptr(), counts.data_ptr(), load.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return counts, load
    return call


def _cut(name: str, edit):
    """The shipped launcher built from the source with ``edit``."""
    with open(ops.SOURCE) as f:
        text = f.read()
    if edit[0] not in text:
        raise RuntimeError(f"{name}: {edit[0]!r} not in the source")
    tag = "cut_" + name.split()[-1]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"moe_histogram_{tag}.cu")
    with open(path, "w") as f:
        f.write(text.replace(edit[0], edit[1], 1))
    kernel = ops.bind(_build.load(f"moe_histogram_{tag}", path,
                                  _build.FLAGS + ops.DEFINES))

    def call(idx, gates, *, num_experts):
        return ops.launch(kernel, idx, gates, num_experts)
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another moe_histogram.cu as variant NAME")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    calls = {"shipped": ops.moe_histogram}
    calls.update((name, _cut(name, edit)) for name, edit in CUTS.items())
    for spec in args.source:
        name, path = spec.split("=", 1)
        calls[name] = _earlier(name, os.path.abspath(path))
    dev = torch.device("cuda")
    for case, t, k in CASES:
        rng = np.random.default_rng(t)
        idx = rng.integers(0, E, (t, k)).astype(np.int32)
        idx[rng.random((t, k)) < 0.1] = -1
        gates = rng.uniform(0, 1, (t, k)).astype(np.float32)
        idx, gates = (torch.from_numpy(a).to(dev) for a in (idx, gates))
        fns = {name: (lambda c=c: c(idx, gates, num_experts=E))
               for name, c in calls.items()}
        fns["empty kernel"] = lambda: torch.cuda._sleep(0)
        times = {name: [] for name in fns}
        for rep in range(REPS + 1):                   # trial 0 warms up
            for name in (list(fns) if rep % 2 else list(fns)[::-1]):
                ops._scratch.clear()      # a cut may leave its ticket set
                ms = _trial(fns[name], CALLS)
                if rep:
                    times[name].append(ms * 1e3)
        ops._scratch.clear()
        want_c, want_l = moe_histogram_ref(idx, gates, E)
        for name, fn in fns.items():
            row = {"case": case, "assignments": t * k, "variant": name,
                   "us": statistics.median(times[name]),
                   "min_us": min(times[name]), "max_us": max(times[name])}
            if name != "empty kernel" and name not in CUTS:
                counts, load = fn()
                row["equal_counts"] = bool(torch.equal(counts, want_c))
                row["load_within_1e-5"] = bool(torch.allclose(
                    load, want_l, rtol=1e-5, atol=1e-5))
                if not (row["equal_counts"] and row["load_within_1e-5"]):
                    print(json.dumps(row), flush=True)
                    return 1
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
