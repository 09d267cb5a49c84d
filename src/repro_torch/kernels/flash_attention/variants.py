"""Time K6's kernels against variants of their source on one card: the
bf16 tensor-core prefill kernel (``flash_mma``) at three prefill inputs
(qwen2-moe-a2.7b's as the serve path gives it, h2o-danube's sliding
window at D = 80, gemma's D = 256) and the flash-decoding kernel
(``flash_decode``) at four decode inputs (the serve path's, phase k6's
qwen2-moe decode at B = 64, and h2o-danube's GQA window at B = 4 in
float32 and bfloat16).

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.variants \
        [--source NAME=PATH ...] [--only TEXT]

Each variant is ``flash_attention.cu`` with one edit (:data:`VARIANTS`;
those in :data:`DECODE_VARIANTS` are timed at the decode inputs, the
others at the prefill inputs), or with ``--source`` another file with
the earlier C launcher (no decode chunks or scratch; an earlier
commit's kernel, e.g. ``git show <commit>:src/repro_torch/kernels/
flash_attention/flash_attention.cu > _checkout/fa_parent.cu``), timed at
every input, built with the same flags into the build directory and
launched through :func:`ops.launch`.  Every variant is held to the plain
version (float32 within 2e-5; each bf16 output within two bf16 steps +
2e-5) and timed with CUDA events: REPS trials of 5 back-to-back calls
each, the variants taking turns trial by trial (in alternating order),
so a drift of the card's clock falls on all of them alike.  Prints the
card's name and power limit, then one JSON line per case and variant:
the median, least and largest ms per call over the trials, the decode
chunk count, and the per-element worst.
"""
from __future__ import annotations

import argparse
import ctypes
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
DEC_WAVES = "constexpr int kDecWaves = 8;"
DEC_UNROLL = "constexpr int kDecUnroll = 4;"
DEC_BOUNDS = "__launch_bounds__(dec_warps(ROWS) * 32)\nflash_decode"
DEC_WARPS = "return rows == 1 ? 3 : 4;"
DEC_CHUNK = "constexpr int kDecMinChunk = 64;"
# name → (text of the shipped source, its replacement)
VARIANTS = {
    "shipped": None,
    "bk64": (BK, BK.replace("32", "64")),              # 64-key kv tiles
    "ring3": (RING, RING.replace("2", "3")),           # three stages
    "fast_exp": (EXP, EXP.replace("expf", "__expf")),  # approximate exp
    # decode: two waves (not eight) where one does not hold the blocks,
    # 2 or 8 key rows a slot loads before it computes, the one-row
    # kernel held to 64 registers (ten blocks an SM), 4 or 2 warps a
    # block for one row (fewer or more blocks resident), chunks of at
    # least 256 keys
    "dec_waves2": (DEC_WAVES, DEC_WAVES.replace("8;", "2;")),
    "dec_warps4": (DEC_WARPS, DEC_WARPS.replace("3 :", "4 :")),
    "dec_warps2": (DEC_WARPS, DEC_WARPS.replace("3 :", "2 :")),
    "dec_minchunk256": (DEC_CHUNK, DEC_CHUNK.replace("64;", "256;")),
    "dec_unroll2": (DEC_UNROLL, DEC_UNROLL.replace("4", "2")),
    "dec_unroll8": (DEC_UNROLL, DEC_UNROLL.replace("4", "8")),
    "dec_regs64": (DEC_BOUNDS, DEC_BOUNDS.replace(
        "32)", "32, ROWS == 1 ? 10 : 1)")),
}
DECODE_VARIANTS = {name for name in VARIANTS if name.startswith("dec_")}
REPS = 21      # trials per variant, the variants in turns
# (case, B, H, Hkv, S, Skv, D, type, window, q_offset): causal
CASES = (("qwen2-moe serve prefill", 50, 16, 16, 1024, 1024, 128,
          "bfloat16", None, 0),
         ("h2o-danube prefill", 1, 32, 8, 8192, 8192, 80, "bfloat16", 4096,
          0),
         ("gemma prefill", 8, 16, 16, 1024, 1024, 256, "bfloat16", None, 0),
         ("qwen2-moe serve decode", 50, 16, 16, 1, 1056, 128, "bfloat16",
          None, 1054),
         ("qwen2-moe decode", 64, 16, 16, 1, 1056, 128, "bfloat16", None,
          1055),
         ("qwen2-moe decode mid-cache", 64, 16, 16, 1, 1056, 128,
          "bfloat16", None, 527),
         ("h2o-danube decode f32", 4, 32, 8, 1, 8192, 80, "float32", 4096,
          8191),
         ("h2o-danube decode", 4, 32, 8, 1, 8192, 80, "bfloat16", 4096,
          8191))


def _variant(name: str, edit):
    """The kernel tuple (:func:`ops.bind`) built from the shipped source
    with ``edit`` (None: the shipped kernel; a path: that file as it is,
    with the earlier launcher)."""
    if edit is None:
        return ops.build()
    if isinstance(edit, str):
        return _earlier(name, edit)
    with open(ops.SOURCE) as f:
        text = f.read()
    if edit[0] not in text:
        raise RuntimeError(f"variant {name}: {edit[0]!r} not in the source")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"flash_attention_{name}.cu")
    with open(path, "w") as f:
        f.write(text.replace(edit[0], edit[1]))
    return ops.bind(_build.load(f"flash_attention_{name}", path,
                                _build.FMA_FLAGS))


def _earlier(name: str, path: str):
    """Another commit's kernel behind the earlier launcher, which takes
    no decode chunks or scratch: one chunk, no scratch."""
    old = _build.load(f"flash_attention_{name}", path,
                      _build.FMA_FLAGS).flash_attention_launch
    old.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    old.restype = ctypes.c_int

    def fn(*args):
        return old(*args[:16], *args[18:])     # drop chunks, scratch
    return fn, (lambda *a: 1), (lambda *a: 0)


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
    ap.add_argument("--only", default="", metavar="TEXT",
                    help="time only the cases whose name holds TEXT")
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
        kernels = dict(zip(variants, pool.map(_variant, variants,
                                              variants.values())))
    dev = torch.device("cuda")
    for case, b, h, hkv, s, skv, d, dt, window, off in CASES:
        if args.only not in case:
            continue
        decode = s <= ops.ROW_MAX
        names = [name for name in kernels
                 if (name in DECODE_VARIANTS) == decode
                 or name == "shipped" or name not in VARIANTS]
        gen = torch.Generator(device=dev).manual_seed(s + d)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(getattr(torch, dt))
                   for shape in ((b, h, s, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        kw = dict(window=window, q_offset=off)
        want = attention_ref(q, k, v, **kw)
        times = {name: [] for name in names}
        for rep in range(REPS + 1):           # trial 0 warms up
            for name in (names if rep % 2 else names[::-1]):
                t = _trial(lambda kern=kernels[name]: ops.launch(
                    kern, q, k, v, **kw))
                if rep:
                    times[name].append(t)
        for name in names:
            kern = kernels[name]
            got = ops.launch(kern, q, k, v, **kw)
            if dt == "float32":
                worst = float((got - want).abs().max()) / 2e-5
            else:
                worst = _worst(got, want)
            print(json.dumps({"case": case, "variant": name,
                              "chunks": kern[1](b, h, hkv, s, skv, d,
                                                ops.DTYPES[q.dtype], 1,
                                                window or 0, off, 0),
                              "ms": statistics.median(times[name]),
                              "min_ms": min(times[name]),
                              "max_ms": max(times[name]),
                              "elementwise_worst": worst}), flush=True)
            if worst > 1.0:
                return 1
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
