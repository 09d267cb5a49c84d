"""Time K6's bf16 tensor-core kernel (``flash_mma``) against variants of
its source on one card, at three prefill inputs: qwen2-moe-a2.7b's as
the serve path gives it, h2o-danube's sliding window (D = 80) and
gemma's D = 256.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.variants \
        [--source NAME=PATH ...]

Each variant is ``flash_attention.cu`` with one edit (:data:`VARIANTS`),
or with ``--source`` another file with the same C launcher (an earlier
commit's kernel), built with the same flags into the build directory
and bound in place of the shipped kernel.  Every variant is held to the plain version
(each bf16 output within two bf16 steps + 2e-5) and timed with CUDA
events: REPS trials of 5 back-to-back calls each, the variants taking
turns trial by trial (in alternating order), so a drift of the card's
clock falls on all of them alike.  Prints the card's name and power
limit, then one JSON line per case and variant: the median, least and
largest ms per call over the trials, and the per-element worst.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _build
from . import ops
from .ref import attention_ref

BK = "static constexpr int BK = 32;"
RING = "static constexpr int kStages = 2;"
EXP = "s[j][e] = expf(s[j][e] - m_new);"
# name → (text of the shipped source, its replacement)
VARIANTS = {
    "shipped": None,
    "bk64": (BK, BK.replace("32", "64")),              # 64-key kv tiles
    "ring3": (RING, RING.replace("2", "3")),           # three stages
    "fast_exp": (EXP, EXP.replace("expf", "__expf")),  # approximate exp
}
REPS = 21      # trials per variant, the variants in turns
# (case, B, H, Hkv, S, D, window): causal, Skv = S, q_offset 0
CASES = (("qwen2-moe serve prefill", 50, 16, 16, 1024, 128, None),
         ("h2o-danube prefill", 1, 32, 8, 8192, 80, 4096),
         ("gemma prefill", 8, 16, 16, 1024, 256, None))


def _variant(name: str, edit):
    """The launcher built from the shipped source with ``edit`` (None: the
    shipped kernel; a path: that file as it is)."""
    if edit is None:
        return ops.build()
    if isinstance(edit, str):
        with open(edit) as f:
            text = f.read()
    else:
        with open(ops.SOURCE) as f:
            text = f.read()
        if edit[0] not in text:
            raise RuntimeError(f"variant {name}: {edit[0]!r} not in the "
                               f"source")
        text = text.replace(edit[0], edit[1])
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"flash_attention_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    fn = _build.load(f"flash_attention_{name}", path,
                     _build.FMA_FLAGS).flash_attention_launch
    fn.argtypes, fn.restype = ops.build().argtypes, ops.build().restype
    return fn


def _trial(fn, calls: int = 5) -> float:
    """ms per call of ``calls`` back-to-back calls, queued behind a device
    sleep so the host's launch overhead opens no gaps between them."""
    torch.cuda._sleep(2_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _worst(got, want) -> float:
    w = want.float()
    _, e = torch.frexp(w)
    step = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 8))
    return float(((got.float() - w).abs() / (2 * step + 2e-5)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another flash_attention.cu as variant NAME")
    args = ap.parse_args(argv)
    variants = dict(VARIANTS)
    for spec in args.source:
        name, path = spec.split("=", 1)
        variants[name] = os.path.abspath(path)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ops.build()
    with ThreadPoolExecutor(len(variants)) as pool:
        fns = dict(zip(variants, pool.map(_variant, variants,
                                          variants.values())))
    shipped, dev = ops.build, torch.device("cuda")
    try:
        for case, b, h, hkv, s, d, window in CASES:
            gen = torch.Generator(device=dev).manual_seed(s + d)
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       .bfloat16() for shape in ((b, h, s, d),
                                                 (b, hkv, s, d),
                                                 (b, hkv, s, d)))
            want = attention_ref(q, k, v, window=window)
            times = {name: [] for name in fns}
            for rep in range(REPS + 1):           # trial 0 warms up
                for name in (list(fns) if rep % 2 else list(fns)[::-1]):
                    ops.build = lambda fn=fns[name]: fn
                    t = _trial(lambda: ops.flash_attention(q, k, v,
                                                           window=window))
                    if rep:
                        times[name].append(t)
            for name in fns:
                ops.build = lambda fn=fns[name]: fn
                worst = _worst(ops.flash_attention(q, k, v, window=window),
                               want)
                print(json.dumps({"case": case, "variant": name,
                                  "ms": statistics.median(times[name]),
                                  "min_ms": min(times[name]),
                                  "max_ms": max(times[name]),
                                  "elementwise_worst": worst}), flush=True)
            del q, k, v, want
            torch.cuda.empty_cache()
    finally:
        ops.build = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
