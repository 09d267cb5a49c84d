"""Time K1 (``stats_update``) against other sources of it on one card,
at the main path's last round close: both (8, 256, 513) float32 stats
banks page-locked on the host with 66 live partitions (the in-place
entry, one launch of 66 blocks) and the device contract at
(6, 132, 513) in device memory.  The banks are drawn from a seed
(integer collectors, C_SPAN with negative entries).

    PYTHONPATH=src python -m repro_torch.kernels.stats_update.variants \\
        [--source NAME=PATH ...]

``--source`` builds another ``stats_update.cu`` and times it as NAME; a
source without the in-place entry (an earlier commit's) is timed on the
device contract alone.  The cuts (:data:`CUTS`) are the shipped source
without a part of its work, to say where a call's time goes; their
outputs are wrong by design and not checked.  Every
other variant's output is held bit for bit to the plain version.  The
row ``shipped: close_live`` is the wrapper as the plane calls it (the
ids' upload included); every other row is the C launcher alone, the
ids already on the card.  All are timed with CUDA events: REPS trials
of CALLS back-to-back calls each, queued behind a device sleep so that
the host's launch overhead opens no gaps, the variants taking turns
trial by trial in alternating order, each call on the next of several
copies of its inputs (64 MB or more in all).  Prints the card's name
and power limit, then one JSON line per case and variant: the median,
least and largest µs per call over the trials.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
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
from .ref import close_live_ref, close_round_inputs_ref

REPS, CALLS = 21, 8
CAP, G1, LIVE = 256, 513, 66
ROTATE_BYTES = 64 << 20
# name → (text of the shipped source, its replacement, each occurrence):
# without the warp scans; without the stores, or without the loads
# (skipped at run time on a condition the compiler cannot see through,
# so the other side stays); each row's start rounded down to a 128-byte
# line (the rows of an (8, cap, 513) bank start at every 4-byte offset
# of a line)
CUTS = {
    "cut: no scan": (
        "      for (int d = 1; d < 32; d <<= 1) {",
        "      for (int d = 32; d < 32; d <<= 1) {"),
    "cut: loads only": ("      if (j < g1) {",
                        "      if (j < g1 && decay < 0.f) {"),
    "cut: stores only": ("x[k][t] = j < g1 ? in[",
                         "x[k][t] = j < g1 && decay < 0.f ? in["),
    "cut: aligned rows": (
        "static_cast<size_t>(live[blockIdx.x]) * g1;",
        "(static_cast<size_t>(live[blockIdx.x]) * g1 & ~size_t{31});"),
}


def _bind(lib):
    """The library's launchers with their argument types; the in-place
    one is None where the source has none."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry_a = lib.stats_update_launch
    entry_a.argtypes = [ptr, ptr, i32, i32, f32, ptr, i32]
    entry_a.restype = i32
    entry_b = getattr(lib, "stats_update_live_launch", None)
    if entry_b is not None:
        entry_b.argtypes = [ptr, ptr, i32, i32, ptr, i32, f32, ptr, i32]
        entry_b.restype = i32
    return entry_a, entry_b


def _banks(seed: int):
    rng = np.random.default_rng(seed)
    banks = []
    for _ in range(2):
        bank = rng.integers(0, 50, (8, CAP, G1)).astype(np.float32)
        bank[:5] += rng.uniform(0, 1, (5, CAP, G1)).astype(np.float32)
        bank[7] -= 25.0
        banks.append(bank)
    live = np.sort(rng.choice(CAP, LIVE, replace=False)).astype(np.int32)
    return banks[0], banks[1], live


def _copies(make, nbytes: int) -> list:
    return [make() for _ in range(max(1, -(-ROTATE_BYTES // nbytes)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another stats_update.cu as variant NAME")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    with open(ops.SOURCE) as f:
        text = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    paths = {"shipped": ops.SOURCE}
    for name, (old, new) in CUTS.items():
        if old not in text:
            raise SystemExit(f"variants: {name}: text not in the source")
        path = os.path.join(_build.BUILD_DIR, f"k1_{len(paths)}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        paths[name] = path
    for spec in args.source:
        name, path = spec.split("=", 1)
        paths[name] = os.path.abspath(path)
    libs = {name: _bind(_build.load(f"stats_update_v{k}", path))
            for k, (name, path) in enumerate(paths.items())}

    rows, cols, live = _banks(0)
    decay, index = 0.5, torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    live_d = torch.from_numpy(live).to(dev)
    want = [torch.from_numpy(rows.copy()), torch.from_numpy(cols.copy())]
    close_live_ref(*want, live, decay)
    in_ch = list(ops.IN_CH)
    bank6 = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [rows[in_ch][:, live], cols[in_ch][:, live]], axis=1))).to(dev)
    want6 = close_round_inputs_ref(bank6, decay)

    def pinned():
        return [torch.from_numpy(rows).pin_memory(),
                torch.from_numpy(cols).pin_memory()]

    def in_place(entry_b):
        ring = itertools.cycle(_copies(pinned, rows.nbytes + cols.nbytes))

        def call():
            r, c = next(ring)
            err = entry_b(r.data_ptr(), c.data_ptr(), CAP, G1,
                          live_d.data_ptr(), LIVE, decay, stream, index)
            if err:
                raise RuntimeError(f"in-place launch: CUDA error {err}")
        return call

    def contract(entry_a):
        ring = itertools.cycle(_copies(
            lambda: (bank6.clone(), torch.empty_like(want6)),
            2 * bank6.nbytes))

        def call():
            x, y = next(ring)
            err = entry_a(x.data_ptr(), y.data_ptr(), 2 * LIVE, G1, decay,
                          stream, index)
            if err:
                raise RuntimeError(f"contract launch: CUDA error {err}")
        return call

    cases = {"in place": {}, "device contract": {}}
    for name, (entry_a, entry_b) in libs.items():
        checked = not name.startswith("cut")
        if entry_b is not None:
            got = pinned()
            err = entry_b(got[0].data_ptr(), got[1].data_ptr(), CAP, G1,
                          live_d.data_ptr(), LIVE, decay, stream, index)
            torch.cuda.synchronize()
            if err or (checked and not all(
                    torch.equal(g, w) for g, w in zip(got, want))):
                raise SystemExit(f"variants: {name}: in-place entry wrong "
                                 f"(error {err})")
            cases["in place"][name] = in_place(entry_b)
        out = torch.empty_like(want6)
        err = entry_a(bank6.data_ptr(), out.data_ptr(), 2 * LIVE, G1, decay,
                      stream, index)
        torch.cuda.synchronize()
        if err or (checked and not torch.equal(out, want6)):
            raise SystemExit(f"variants: {name}: device contract wrong "
                             f"(error {err})")
        cases["device contract"][name] = contract(entry_a)
    ring = itertools.cycle(_copies(pinned, rows.nbytes + cols.nbytes))
    cases["in place"]["shipped: close_live"] = (
        lambda: ops.close_live(*next(ring), live, decay, dev))

    for case, fns in cases.items():
        names = list(fns)
        times = {name: [] for name in names}
        for name in names:
            _trial(fns[name], CALLS)                      # warm-up
        for rep in range(REPS):
            for name in (names if rep % 2 == 0 else names[::-1]):
                times[name].append(_trial(fns[name], CALLS) * 1e3)
        for name in names:
            t = times[name]
            print(json.dumps({"case": case, "variant": name,
                              "live": LIVE, "banks": [8, CAP, G1],
                              "median_us": statistics.median(t),
                              "min_us": min(t), "max_us": max(t)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
