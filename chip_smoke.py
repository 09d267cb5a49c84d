#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It builds every kernel of the port from the sources in the checkout
(nvcc, at first use), holds each kernel against its plain PyTorch
version on the card (phases ``k1`` … ``k6``), checks the port against
its own NumPy reference plane on a small timeline, checks that window
counts stay exact with TF32 enabled globally, and drives the port's
paths at realistic sizes:

- the streaming main path — ``StreamingEngine`` → ``SwarmRouter`` →
  ``TorchPlane`` — at grid 512, 64 machines, 131 072 tuples per tick,
  100 000 resident queries, the paper's Fig-12 hotspot timeline, three
  times: as a user runs it (the end-to-end rate), with the engine's own
  tracer on (time per layer) and under ``torch.profiler`` (the card's
  busy share);
- the sharded data plane (phase ``sharded``): that deployment on
  ``ShardedTorchPlane`` at 1, 2 and 4 shards colocated on the card, each
  run against phase ``main``'s ``TorchPlane`` run (counts equal, the
  rest within rtol 1e-3), its resharded bytes equal to the billed
  migration bytes and K1 once a round close; then
  ``tests/test_sharded.py``'s rebalance-and-failure timeline (with
  backpressure engaged, and idle) and its keyword timeline on four
  shards, the card against the port on the CPU;
- the exact-match API (phase ``match``): one hotspot tick of 131 072
  tuples against those 100 000 queries through
  ``TorchPlane.match_counts`` (K2) and, against the queries' centres as
  kNN foci, ``knn_distances`` (K4);
- the spatio-textual pub/sub deployment of ``benchmarks/pubsub.py``
  (phase ``pubsub``): SWARM and static-history at 1 000 000 standing
  ``spatial_keyword`` subscriptions on the card plane, its plane-parity
  and collision-bound gates, and one full-scale delivery tick through
  ``keyword_match_counts`` (K3);
- the LM serving path (phase ``serve``): ``repro_torch.launch.serve``
  on qwen2-moe-a2.7b at full width and depth (24 layers, d_model 2048,
  60 experts top-4), 256 sessions over 4 replicas, replica 0's batch
  prefilled at 1024 tokens and decoded for 32, every attention on K6
  and every MoE layer's expert histogram on K5; the same model's
  prefill and decode calls under ``torch.profiler`` (phase
  ``serve_profile``); then (phase ``serve_check``) two layers at full
  width, the kernel path against the plain path and decode against a
  full forward;
- the recurrent families: jamba-v0.1-52b at full width (d_model 4096,
  16 experts top-2, Mamba d_state 16) with its depth cut to one period
  of 8 layers (phase ``serve_hybrid``: ``launch.serve.serve_config``
  with phase ``serve``'s traffic, K6 once and K5 four times per call,
  both held against their plain versions at the path's inputs, and a
  profile split of one prefill and one decode call — the scan loop's
  device and host time against the products, K5 and K6); phase
  ``hybrid_check`` that period at B = 2, the kernel path against the
  plain path (bf16 and float32) and decode against a full forward, and
  xlstm-1.3b cut to one period, the card against the CPU in float32;
  phase ``serve_ssm`` xlstm-1.3b at full width and depth (48 layers of
  sLSTM and mLSTM scans, no kernel), 64 sessions, prompt 512, 16
  decode calls, with the same profile split; both serving phases print
  their prefill seconds and decode ms beside PR 20's run Z, whose scans
  were loops.  Before them, phase ``scan_ops`` holds each scan op
  (``models/scan_ops.py``) against the loop it replaced
  (``layers.segmented_scan`` over the same step) at the served shapes —
  jamba's Mamba layer at B 50 × 1024, xlstm's mLSTM and sLSTM at
  B 10 × 512 — bit for bit, and the sLSTM op's gradient against the
  loop's, with both times;
- the training path (phase ``train``): ``repro_torch.launch.train``'s
  ``Trainer`` on internlm2-1.8b at full width and depth (24 layers,
  float32 masters and AdamW state, bf16 compute, batch 4 × 2048, remat
  ``dots_no_batch``) for 8 steps, every attention weight's gradient
  checked finite and non-zero (F6), a checkpoint, two profiled steps, a
  restore and the same two steps again; then (phase ``train_check``)
  two layers at full width in float32, a step on the card against the
  same step on the CPU and K6's backward against the reference
  attention's at one layer's shape; and (phase ``train_moe``)
  qwen2-moe-a2.7b at full width with its depth cut to 4 layers, K5
  twice a MoE layer a step, its counts exact;
- the sharded LM path (phase ``serve_mesh``): phase ``serve``'s model
  and replica 0's traffic on a (1, 1) ("data", "model") mesh of a
  one-rank NCCL group — DTensor weights over the same tensors
  (``param_shardings``), the cache by ``cache_shardings``, the
  activation constraint on — its logits against the unsharded path's
  in the same call (bit for bit, or within 4 bf16 steps), K5 and K6
  launched as often, prefill seconds and decode ms beside the unsharded
  ones (DTensor's host cost on one card);
- the dry run (phase ``dryrun``): ``python -m
  repro_torch.launch.dryrun`` in a child process a cell on the 16×16
  production mesh (a fake process group of 256 ranks, fake shards, no
  card used) for internlm2-1.8b × train_4k, qwen2-moe-a2.7b ×
  decode_32k, jamba-v0.1-52b × long_500k and × prefill_32k,
  hubert-xlarge × prefill_32k and xlstm-1.3b × train_4k: status ok,
  per-device parameter bytes equal to the sharding rules' shard sizes,
  0 < useful fraction ≤ 1.5; jamba × long_500k's traced FLOPs and
  K5/K6 calls those of PR 20 and its collective bytes by kind no more;
- swarmlint (phase ``analysis``): ``python -m repro_torch.analysis
  src/repro_torch`` on the card's host, the lint rules and the 19
  kernel signature checks (every entry traced on fake CUDA tensors
  through its op's fake), no violation and no mismatch.

Every round close folds the live rows in place in the page-locked host
banks, one launch of K1's in-place entry (``stats_update.close_live``);
phase ``k1_live`` runs that entry at the main path's last round close
on page-locked copies of the banks, bit for bit ``close_live_ref``, and
gives its time beside the host link's bound (nvidia-smi's PCIe
generation and width, with a measured page-locked copy rate each way),
``stats_close`` per call and the main run's re-homings of the banks.
Phase ``k1`` holds the device contract ((6, P, G1) → (5, P, G1) in
device memory) and also ``stats_update.close_round`` (the whole
(8, P, G1) bank, one K1 launch) and ``close_round_xla`` bit for bit to
``close_round_ref`` at the main path's (P, G1).  K1–K4 are reached
through their ``torch.library`` ops, as K5 and K6 are.
K5 is also held bit for bit to its written-out float32 sum order
(``kernels/moe_histogram/order.py``) and timed beside an empty kernel,
the floor under a launch; ``serve_profile`` counts one K5 kernel per MoE
layer and call, and ten K5 calls alone at each serve input, captured
in a CUDA graph, are ten kernels and nothing else (no memset); ``k3_k5_ptxas`` lists the
registers of each of K3's five kernels and K5's one (from the build log
kept beside each library, so a cached build reports too) and fails on a
spill or a kernel it does not find; ``k4_k6_ptxas`` does the same for
K4's match and merge kernels at every list length and K6's decode and
merge kernels.  Phase ``k4`` holds K4 at k = 8, 17 and 32; the
``kernels`` line gives K6 twice, at the serve path's last prefill input
(the launches of its prefill kernels) and, as ``flash_attention_decode``,
at its last decode input (the launches of its decode and merge
kernels); K1 twice too, in place (``stats_update``, its launches by path:
``main``, ``sharded`` with the three shard counts summed, and
``pubsub``'s suite) and as the device contract at the last round
close's (6, 2·live, G+1) input (``stats_update_inputs``, no launches on
a path); each wrapper counts every kernel it launches, and K4's and
K6's rows split their count by kernel, and K5's and K6's by path
(``serve``, ``serve_hybrid`` and ``serve_mesh``).  K2–K4's operation
bounds count one instruction per lane and clock
(SINGLE_ISSUE_OPS_PER_S).

Each phase prints one JSON line; then the card's name and power limit
as nvidia-smi gives them, the ``kernels`` line, and last
``{"ok": true, "device": ...}``.
Any failed check raises and the script exits non-zero; without a CUDA
card, or without the repository around it, it exits non-zero before
printing any result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# one instruction per lane and clock: 132 SMs × 128 lanes × 1.98 GHz (the
# FMA-doubled FP32_OPS_PER_S counts an FMA as two operations; K2–K4's
# compares, logic and adds issue one instruction each)
SINGLE_ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense

# the main path's realistic size (see PERF.md, "Cells")
GRID, MACHINES = 512, 64       # largest cell of benchmarks/control_plane.py
LAMBDA = 131072                # largest batch of benchmarks/engine_throughput.py
QUERIES = 100_000              # README pub/sub quickstart scale
TICKS, ROUND_EVERY, WINDOW = 96, 8, 16
# phase sharded: the main path's deployment on ShardedTorchPlane at these
# shard counts, colocated on the card; then tests/test_sharded.py's
# timelines (SHARD_G, SHARD_M) on four shards, card against the CPU port
SHARD_COUNTS = (1, 2, 4)
SHARD_G, SHARD_M = 16, 8
SHARD_EXACT = ("injected", "q_total", "transfers", "migration_bytes",
               "moved_tuples", "wire_bytes")
KNN_K = 8                      # QuerySpec / WorkloadSpec.k
# phase k4's list lengths: the path's k, and past the register cap of
# 16 that the kernel had before (the lists of 24 and 32)
K4_KS = (KNN_K, 17, 32)

# the pub/sub deployment of benchmarks/pubsub.py (BENCH_pubsub.json)
PS_GRID, PS_MACHINES = 64, 8
PS_SUBS, PS_TICKS = 1_000_000, 60
PS_LAMBDA = 20_000
PS_HOT_TERMS, PS_TERM_PEAK = 2, 0.5
PS_CAP_PER_SUB = 0.75          # cap_units = 0.75 × subscriptions
PS_PARITY_TICKS, PS_PARITY_SUBS = 24, 20_000

# the shapes at which phases k2 … k4 hold each kernel against its plain
# version: K2 and K4 at N points × Q rects or foci, K3 at PS_LAMBDA
# tuples × Q subscriptions × T buckets
K24_N, K24_Q = (4096, LAMBDA), (1000, QUERIES)
K3_Q, K3_T = (65536, PS_SUBS), (32, 4096)

# the LM serving path (PERF.md §4): qwen2-moe-a2.7b at full width and
# depth; replica 0's share of the sessions is the served batch
LM_ARCH = "qwen2_moe_a2_7b"
LM_SESSIONS, LM_REPLICAS, LM_PROMPT, LM_STEPS = 256, 4, 1024, 32
CHECK_BATCH, CHECK_PROMPT = 2, 128      # phase serve_check, two layers
# the training path (PERF.md §4): internlm2-1.8b at full width and depth,
# batch × seq, TRAIN_STEPS steps, a checkpoint, TRAIN_RESUME steps on, a
# restore and the same steps again; phase train_check cuts its depth to
# two layers in float32; phase train_moe runs qwen2-moe-a2.7b at full
# width, depth cut to MOE_TRAIN_LAYERS
TRAIN_ARCH = "internlm2_1_8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_REMAT = 4, 2048, "dots_no_batch"
TRAIN_STEPS, TRAIN_RESUME = 8, 2
TRAIN_LR = 3e-4               # AdamWConfig's default rate
LAUNCHER_STEPS = 6            # as the launcher runs them, data drawn inline
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 256
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = \
    4, 4, 1024, 4
MOE_EP_SHARDS = 6             # the largest divisor of 60 experts up to 8
CKPT_DIR = "_train_ckpt"      # under the checkout (gitignored), removed after
# the recurrent families (PERF.md §4): jamba-v0.1-52b at full width, its
# depth cut 32 → one period of 8 layers (the whole model, 51.6 B
# parameters, ~103 GB in bf16, does not fit the card), served with phase
# serve's traffic; replica 0 serves HYBRID_BATCH of its sessions.
# xlstm-1.3b at full width and depth, SSM_SESSIONS sessions, a prompt of
# SSM_PROMPT and SSM_DECODE_CALLS decode calls.  Phase hybrid_check holds
# jamba at CHECK_BATCH × CHECK_PROMPT and xlstm cut to one period
# (SSM_CHECK_LAYERS) on the card against the CPU
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_BATCH = "jamba_v0_1_52b", 8, 50
SSM_ARCH, SSM_SESSIONS, SSM_PROMPT, SSM_DECODE_CALLS = \
    "xlstm_1_3b", 64, 512, 16
SSM_CHECK_LAYERS, SSM_CHECK_BATCH, SSM_CHECK_PROMPT, SSM_CHECK_STEPS = \
    8, 2, 32, 3
# phase k5: (assignments T, top-k K, experts E); the last two jamba's
# prefill and decode calls (HYBRID_BATCH rows, top-2 of 16)
K5_SHAPES = ((256, 4, 60), (65536, 4, 60), (65536, 6, 64),
             (HYBRID_BATCH * LM_PROMPT, 2, 16), (HYBRID_BATCH, 2, 16))
# phase k6: (case, B, H, Hkv, S, Skv, D, type, window, q_offset)
K6_CASES = (
    ("qwen2-moe prefill", 64, 16, 16, 1024, 1024, 128, "bfloat16", None, 0),
    ("qwen2-moe decode", 64, 16, 16, 1, 1056, 128, "bfloat16", None, 1055),
    ("qwen2-moe decode mid-cache", 64, 16, 16, 1, 1056, 128, "bfloat16",
     None, 527),
    ("h2o-danube prefill", 1, 32, 8, 8192, 8192, 80, "bfloat16", 4096, 0),
    ("gemma prefill", 8, 16, 16, 1024, 1024, 256, "bfloat16", None, 0),
    ("qwen2-moe prefill f32", 8, 16, 16, 1024, 1024, 128, "float32", None,
     0),
    ("h2o-danube prefill f32", 1, 32, 8, 8192, 8192, 80, "float32", 4096,
     0),
    ("gemma prefill f32", 2, 16, 16, 1024, 1024, 256, "float32", None, 0),
    ("qwen2-moe decode f32", 64, 16, 16, 1, 1056, 128, "float32", None,
     1055),
    ("h2o-danube decode f32", 4, 32, 8, 1, 8192, 80, "float32", 4096, 8191),
    ("h2o-danube decode", 4, 32, 8, 1, 8192, 80, "bfloat16", 4096, 8191),
    ("internlm2 train", 4, 16, 8, 2048, 2048, 128, "bfloat16", None, 0),
    # jamba's attention layer at phase serve_hybrid's inputs: the prefill
    # over the cache of LM_PROMPT + LM_STEPS rows, the last decode call
    ("jamba prefill", HYBRID_BATCH, 32, 8, LM_PROMPT, LM_PROMPT + LM_STEPS,
     128, "bfloat16", None, 0),
    ("jamba decode", HYBRID_BATCH, 32, 8, 1, LM_PROMPT + LM_STEPS, 128,
     "bfloat16", None, LM_PROMPT + LM_STEPS - 2),
)

# phase dryrun: the cells `python -m repro_torch.launch.dryrun` traces
# on the 16×16 production mesh (a fake process group of 256 ranks, one
# child process a cell), each within DRYRUN_TIMEOUT seconds; the last
# two trace their 32 768- and 4096-step scans as one op call a layer
DRYRUN_CELLS = (("internlm2_1_8b", "train_4k"),
                ("qwen2_moe_a2_7b", "decode_32k"),
                ("jamba_v0_1_52b", "long_500k"),
                ("hubert_xlarge", "prefill_32k"),
                ("jamba_v0_1_52b", "prefill_32k"),
                ("xlstm_1_3b", "train_4k"))
DRYRUN_MESH, DRYRUN_TIMEOUT = {"data": 16, "model": 16}, 300
# jamba × long_500k's record on that mesh with its scans as loops (PR 20,
# PERF.md §5): the traced FLOPs and K5/K6 calls stay, collective bytes by
# kind may not grow
LONG_500K_PR20 = {"traced_flops_per_device": 8.0232251392e10,
                  "collectives": {"all-gather": 17213326336,
                                  "reduce-scatter": 917504,
                                  "all-reduce": 477824},
                  "kernel_calls": {"flash_attention": 4,
                                   "moe_histogram": 16}}
# phase scan_ops: each scan op against the loop (``layers.segmented_scan``
# over the same step) at the served shapes — jamba's Mamba layer at phase
# serve_hybrid's prefill (HYBRID_BATCH × LM_PROMPT, full d_inner and
# d_state), xlstm-1.3b's mLSTM and sLSTM at phase serve_ssm's (its
# replica 0 batch of SCAN_SSM_BATCH × SSM_PROMPT); the gradient of the
# sLSTM op against the loop's at that shape, float32, each input's within
# SCAN_GRAD_RTOL of its largest magnitude (+ SCAN_GRAD_ATOL): the
# recurrent matrices' gradients sum 2 × SSM_PROMPT steps in another order
SCAN_SSM_BATCH = 10
SCAN_GRAD_RTOL, SCAN_GRAD_ATOL = 1e-5, 1e-6
# phases serve_hybrid and serve_ssm with the scans as loops, PR 20's run Z
# on this card type (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §5)
PR20_RUN_Z = {"serve_hybrid": {"prefill_s": 2.287172451,
                               "decode_ms_per_call": 21.24247083870968},
              "serve_ssm": {"prefill_s": 10.80338142,
                            "decode_ms_per_call": 45.0096033125}}

# the TPU kernel each CUDA kernel replaces
REPLACES = {
    "stats_update": "src/repro/kernels/stats_update/stats_update.py:38",
    "spatial_match": "src/repro/kernels/spatial_match/spatial_match.py:56",
    "keyword_match": "src/repro/kernels/keyword_match/keyword_match.py:65",
    "knn_match": "src/repro/kernels/knn_match/knn_match.py:61",
    "moe_histogram": "src/repro/kernels/moe_histogram/moe_histogram.py:33",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:72",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def tf32(torch, on: bool):
    """TF32 for float32 matmuls on or off inside the block, restored on
    exit, so that no phase leaks its setting into a later one."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 4_000_000       # ≈2 ms of device sleep at the H100's clock
ROTATE_BYTES = 64 << 20        # more than the 50 MB L2


def time_ms(torch, fns, reps: int = 21) -> float:
    """Device time of one call: the median over ``reps`` trials of the
    CUDA-event time of ``len(fns)`` back-to-back calls, divided by their
    count.  Each trial is queued behind a device sleep, so the host's
    launch overhead opens no gaps between the calls, and ``fns`` rotate
    over distinct inputs of at least 64 MB in all, so each call finds its
    input out of the 50 MB L2, as a round close does with freshly
    uploaded rows."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for fn in fns:
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(fns))
    return statistics.median(times)


def time_call_ms(torch, fn) -> float:
    """Device time of one call of a millisecond-scale function: as
    :func:`time_ms` on one input, with as many trials (3 to 21) as fit
    in about two seconds.  K2–K4's points, rects and foci are a few
    megabytes and stay in L2 from call to call, as they do right after
    the plane uploads them; a call takes milliseconds, so rotating them
    out of L2 would change its time by microseconds."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    reps = int(min(21, max(3, 2000.0 / max(a.elapsed_time(b), 1e-3))))
    return time_ms(torch, [fn], reps)


def roofline(nbytes: float, ops: float, rate: float = FP32_OPS_PER_S
             ) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``ops`` operations at
    ``rate`` a second, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(p: int, g1: int) -> tuple[float, str, int]:
    """Least time for one round close of a (6, p, g1) bank: each input
    read once, each of the 5 outputs written once, against the adds of
    three scans and the five channel updates."""
    nbytes = (6 + 5) * p * g1 * 4
    return (*roofline(nbytes, (3 + 5) * p * g1), nbytes)


def k2_cost(n: int, q: int) -> dict:
    """K2's least time: points (n, 2) and rects (q, 4) read once, the two
    int32 count vectors written once; 4 compares + 3 ands + 1 add per
    (point, rect) pair, single-issue instructions."""
    nbytes = n * 8 + q * 16 + (n + q) * 4
    ops = 8 * n * q
    bound_ms, bound_by = roofline(nbytes, ops, SINGLE_ISSUE_OPS_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "peak_ops_per_s": SINGLE_ISSUE_OPS_PER_S}


def k3_cost(n: int, q: int, t: int, inside: int) -> dict:
    """K3's least time: points, rects, both (·, t) float32 masks read
    once, the counts written once; K2's 8 operations per pair, plus the
    ceil(t/32) word tests of each of the ``inside`` pairs that pass the
    spatial test (the only pairs whose keywords this data needs),
    single-issue instructions."""
    nbytes = n * 8 + q * 16 + (n + q) * t * 4 + (n + q) * 4
    ops = 8 * n * q + -(-t // 32) * inside
    bound_ms, bound_by = roofline(nbytes, ops, SINGLE_ISSUE_OPS_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "inside_pairs": inside,
            "peak_ops_per_s": SINGLE_ISSUE_OPS_PER_S}


def k4_cost(n: int, q: int, k: int) -> dict:
    """K4's least time: points (n, 2) and foci (q, 2) read once, the
    (q, k) distances written once; 2 subs + 2 muls + 1 add + 1 compare
    against the k-th per (point, focus) pair, single-issue instructions."""
    nbytes = (n + q) * 8 + q * k * 4
    ops = 6 * n * q
    bound_ms, bound_by = roofline(nbytes, ops, SINGLE_ISSUE_OPS_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "peak_ops_per_s": SINGLE_ISSUE_OPS_PER_S}


def counts_error(torch, got, want, what: str) -> int:
    """Largest difference of two (per-point, per-query) count pairs,
    which must be 0."""
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        check(a.dtype == torch.int32 and torch.equal(a, b),
              f"{what}: counts differ from the plain version")
    return max(int((a - b).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def device_masks(torch, np, ids, t: int, device):
    """(rows, K) bucket ids (−1 = none) → (rows, t) float32 0/1 masks
    built on the card, as ``bucket_masks`` builds them on the host."""
    ids = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    out = torch.zeros((ids.shape[0], t), dtype=torch.float32, device=device)
    return out.scatter_reduce_(1, ids.clamp_min(0), (ids >= 0).float(),
                               reduce="amax")


def k1_times(torch, SU, bank6, decay) -> dict:
    bound_ms, bound_by, nbytes = k1_bound(*bank6.shape[1:])
    copies = [bank6.clone()
              for _ in range(max(1, -(-ROTATE_BYTES // nbytes)))]
    return {
        "ms": time_ms(torch, [lambda b=b: SU.close_round_inputs(b, decay)
                              for b in copies]),
        "plain_ms": time_ms(torch, [
            lambda b=b: SU.close_round_inputs_ref(b, decay)
            for b in copies]),
        "library_ms": time_ms(torch, [
            lambda b=b: torch.cumsum(b[3:6], dim=-1) for b in copies]),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def k1_error(torch, SU, bank6, decay) -> float:
    """Kernel against its plain version on the same inputs: exact for
    the dyadic decays 0.5 and 1.0, rtol 1e-6 otherwise (the float32
    N·decay product rounds; both sides round product then sum)."""
    got = SU.close_round_inputs(bank6, decay)
    want = SU.close_round_inputs_ref(bank6, decay)
    torch.cuda.synchronize()
    if decay in (0.5, 1.0):
        check(torch.equal(got, want), f"K1 != plain at decay {decay}")
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    return float((got - want).abs().max())


# PCIe transfer rate a lane and direction: GT/s and the line code's share
PCIE_GEN = {1: (2.5, 0.8), 2: (5.0, 0.8), 3: (8.0, 128 / 130),
            4: (16.0, 128 / 130), 5: (32.0, 128 / 130)}
H100_PCIE = (5, 16)            # the H100's host link (data sheet): Gen5 ×16


def pcie_link() -> dict:
    """The card's host link — the most it supports with this system and
    what it runs at now, as nvidia-smi reports them — and the bytes a
    second it carries each way at the most.  Where nvidia-smi gives no
    number (as on a machine that hides the PCI bus), the H100's own
    Gen5 ×16 stands in, and ``source`` says so."""
    fields = ("pcie.link.gen.max", "pcie.link.width.max",
              "pcie.link.gen.current", "pcie.link.width.current")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    vals = [v.strip() for v in (out.stdout.strip().splitlines() or [""])[0]
            .split(",")]
    link = dict(zip(("gen_max", "width_max", "gen_current",
                     "width_current"), vals))
    try:
        gen, width = int(link["gen_max"]), int(link["width_max"])
        link["source"] = "nvidia-smi"
    except (KeyError, ValueError):
        gen, width = H100_PCIE
        link["source"] = f"data sheet (nvidia-smi gave {vals})"
    rate, code = PCIE_GEN[gen]
    link.update(gen=gen, width=width,
                bytes_per_s=rate * 1e9 * code * width / 8)
    return link


def host_ms(fn, reps: int = 21) -> float:
    """Host time of one call of a function that runs on the CPU: the
    median of ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def copy_rates(torch, device, nbytes: int = 256 << 20) -> dict:
    """Bytes a second of one page-locked host ↔ card copy of ``nbytes``,
    each way, timed as :func:`time_ms` times a kernel."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=device)
    rates = {
        "host_to_card": nbytes / (time_ms(torch, [
            lambda: card.copy_(host, non_blocking=True)], 5) * 1e-3),
        "card_to_host": nbytes / (time_ms(torch, [
            lambda: host.copy_(card, non_blocking=True)], 5) * 1e-3),
        "bytes": nbytes}
    del host, card
    return rates


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_k1_live(torch, np, SU, last, main, device) -> dict:
    """K1's in-place entry at the main path's last round close (phase
    ``breakdown``'s live ids and banks as the kernel found them), on
    page-locked copies: one launch, bit for bit ``close_live_ref`` on
    host copies.  Its time (CUDA events around the wrapper's calls, the
    ids' upload included, over page-locked copies rotated as
    :func:`time_ms` rotates inputs), the plain version's host time, the
    bytes it reads and writes over the host link, the link's bound from
    nvidia-smi with a measured page-locked copy rate each way beside
    it, ``stats_close`` per call and the main run's re-homings."""
    live, decay, rows, cols = (last[k] for k in ("live", "decay", "rows",
                                                  "cols"))

    def pinned():
        return [torch.from_numpy(rows).pin_memory(),
                torch.from_numpy(cols).pin_memory()]

    got = pinned()
    before = SU.ops.launches
    SU.close_live(*got, live, decay, device)
    torch.cuda.synchronize()
    launched = SU.ops.launches - before
    want = [torch.from_numpy(rows.copy()), torch.from_numpy(cols.copy())]
    SU.close_live_ref(*want, live, decay)
    check(launched == 1, f"k1_live: {launched} launches for one close")
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "k1_live: the in-place entry differs from close_live_ref")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    n, g1 = len(live), rows.shape[2]
    read_b, write_b = 6 * 2 * n * g1 * 4, 8 * 2 * n * g1 * 4
    link = pcie_link()
    bound_ms = max(read_b, write_b) / link["bytes_per_s"] * 1e3
    copies = [pinned() for _ in range(max(1, -(-ROTATE_BYTES // (
        rows.nbytes + cols.nbytes))))]
    ms = time_ms(torch, [
        lambda c=c: SU.close_live(c[0], c[1], live, decay, device)
        for c in copies])
    plain = [torch.from_numpy(rows.copy()), torch.from_numpy(cols.copy())]
    res = {"phase": "k1_live", "live": n, "banks": list(rows.shape),
           "decay": decay, "launches": launched, "bit_for_bit": True,
           "max_abs_err": err, "ms": ms,
           "plain_ms": host_ms(lambda: SU.close_live_ref(*plain, live,
                                                         decay)),
           "bytes_read": read_b, "bytes_written": write_b, "link": link,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "share_of_bound": bound_ms / ms,
           "copy_rates": copy_rates(torch, device),
           "stats_close_ms_per_call": last["stats_close_ms_per_call"],
           "rehomed_main": main["rehomed"]}
    emit(res)
    del copies, got
    return res


def phase_kernel(torch, SU, device) -> float:
    """K1 at P in {256, 2048} rows and G+1 in {513, 1025}, integer
    collectors, decays 0.5 and 0.9."""
    gen = torch.Generator(device=device).manual_seed(11)
    worst = 0.0
    for p in (256, 2048):
        for g1 in (513, 1025):
            bank6 = torch.randint(0, 64, (6, p, g1), generator=gen,
                                  device=device).float()
            bank6[:3] += torch.rand((3, p, g1), generator=gen, device=device)
            for decay in (0.5, 0.9):
                err = k1_error(torch, SU, bank6, decay)
                worst = max(worst, err)
                emit({"phase": "k1", "p": p, "g1": g1, "decay": decay,
                      "max_abs_err": err,
                      **k1_times(torch, SU, bank6, decay)})
    return worst


def k2_row(torch, SM, pts, rects) -> dict:
    """K2 against its plain version on card tensors: error, times,
    bound."""
    got = SM.spatial_match(pts, rects)
    err = counts_error(torch, got, SM.spatial_match_ref(pts, rects), "K2")
    return {"max_abs_err": err, "hits": int(got[0].sum()),
            "ms": time_call_ms(torch, lambda: SM.spatial_match(pts, rects)),
            "plain_ms": time_call_ms(
                torch, lambda: SM.spatial_match_ref(pts, rects)),
            **k2_cost(pts.shape[0], rects.shape[0])}


def k3_row(torch, SM, KM, pts, pm, rects, sm) -> dict:
    """K3 against its plain version on card tensors, the plain version's
    miss matmul in TF32 (0/1 inputs and a float32 accumulator keep it
    exact); K3 may count no more than K2 on the same points and rects."""
    with tf32(torch, True):
        got = KM.keyword_match(pts, pm, rects, sm)
        err = counts_error(torch, got,
                           KM.keyword_match_ref(pts, pm, rects, sm), "K3")
        plain_ms = time_call_ms(
            torch, lambda: KM.keyword_match_ref(pts, pm, rects, sm))
    spatial = SM.spatial_match(pts, rects)
    check(all(bool((a <= b).all()) for a, b in zip(got, spatial)),
          "K3 counted a pair that K2 does not")
    n, t = pm.shape
    return {"max_abs_err": err, "deliveries": int(got[0].sum()),
            "allow_tf32": True,
            "ms": time_call_ms(
                torch, lambda: KM.keyword_match(pts, pm, rects, sm)),
            "plain_ms": plain_ms,
            **k3_cost(n, rects.shape[0], t, int(spatial[0].sum()))}


def k4_row(torch, KN, pts, foci, k: int) -> dict:
    """K4 against its plain version on card tensors (equal bit for bit:
    both round each product, then the sum)."""
    got = KN.knn_match(pts, foci, k)
    want = KN.knn_match_ref(pts, foci, k)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K4: distances differ from the plain "
          "version")
    return {"max_abs_err": float((got - want).abs().max()),
            "ms": time_call_ms(torch, lambda: KN.knn_match(pts, foci, k)),
            "plain_ms": time_call_ms(
                torch, lambda: KN.knn_match_ref(pts, foci, k)),
            **k4_cost(pts.shape[0], foci.shape[0], k)}


def _match_inputs(T, np, n: int, q: int):
    """``n`` tuples of the main path's hotspot peak tick and ``q`` of its
    standing range queries (the ``uniform_normal`` source, seed 0)."""
    src = T.scenario("uniform_normal", seed=0, horizon=TICKS)
    rects = np.asarray(src.sample_queries(q), np.float32)
    return np.asarray(src.sample_points(n, TICKS // 2), np.float32), rects


def _centres(np, rects):
    return np.stack([(rects[:, 0] + rects[:, 2]) * 0.5,
                     (rects[:, 1] + rects[:, 3]) * 0.5], 1).astype(np.float32)


def _on(torch, device, *arrays):
    return [torch.from_numpy(np_a).to(device) for np_a in arrays]


def phase_k2(torch, T, np, SM, device) -> int:
    """K2 at N in {4096, 131 072} tuples × Q in {1000, 100 000} rects."""
    worst = 0
    for n in K24_N:
        for q in K24_Q:
            pts, rects = _on(torch, device, *_match_inputs(T, np, n, q))
            row = k2_row(torch, SM, pts, rects)
            worst = max(worst, row["max_abs_err"])
            emit({"phase": "k2", "n": n, "q": q, **row})
    return worst


def phase_k4(torch, T, np, KN, device) -> float:
    """K4 at N in {4096, 131 072} points × Q in {1000, 100 000} foci (the
    queries' centres), k in K4_KS."""
    worst = 0.0
    for n in K24_N:
        for q in K24_Q:
            pts, rects = _match_inputs(T, np, n, q)
            pts, foci = _on(torch, device, pts, _centres(np, rects))
            for k in K4_KS:
                row = k4_row(torch, KN, pts, foci, k)
                worst = max(worst, row["max_abs_err"])
                emit({"phase": "k4", "n": n, "q": q, "k": k,
                      "splits": KN.ops.build()[1](n, q, k)
                      // (q * KN.ref.list_len(k)) or 1, **row})
    return worst


def _ps_spec(T, ticks: int, subs: int):
    return T.ScenarioSpec("hot_hashtags", ticks=ticks, preload_queries=subs,
                          query_burst=0, hot_terms=PS_HOT_TERMS,
                          term_peak=PS_TERM_PEAK)


def _ps_cfg(T, subs: int):
    # per-tick engine, capacity scaled with the standing subscriptions,
    # as in benchmarks/pubsub.py's timed section
    return T.EngineConfig(num_machines=PS_MACHINES,
                          cap_units=PS_CAP_PER_SUB * subs,
                          lambda_max=PS_LAMBDA, mem_queries=10**8)


def _delivery_tick(T, np, n: int, q: int):
    """One mid-migration tick of the pub/sub deployment's source: ``n``
    tuples and their terms, ``q`` standing subscriptions and theirs."""
    wl = T.WorkloadSpec(query_model="spatial_keyword")
    src = _ps_spec(T, PS_TICKS, q).build(seed=0, workload=wl)
    tick = PS_TICKS // 2
    pts = np.asarray(src.sample_points(n, tick), np.float32)
    terms = src.sample_terms(pts, tick, wl.tuple_terms)
    rects = np.asarray(src.sample_queries(q), np.float32)
    sub_terms = src.sample_subscription_terms(q, tick, wl.sub_terms)
    return wl, pts, terms, rects, sub_terms


def phase_k3(torch, T, np, SM, KM, device) -> int:
    """K3 at N = 20 000 tuples × Q in {65 536, 1 000 000} subscriptions ×
    T in {32, 4096} buckets, every tenth subscription a wildcard (no
    keywords); then all-zero subscription masks must give K2's counts."""
    worst = 0
    for q in K3_Q:
        _, pts, terms, rects, sub_terms = _delivery_tick(T, np, PS_LAMBDA, q)
        sub_terms = np.array(sub_terms)
        sub_terms[::10] = -1
        pts_d, rects_d = _on(torch, device, pts, rects)
        for t in K3_T:
            hasher = T.TermHasher(t)
            pm = device_masks(torch, np, hasher.buckets(terms), t, device)
            sm = device_masks(torch, np, hasher.buckets(sub_terms), t, device)
            row = k3_row(torch, SM, KM, pts_d, pm, rects_d, sm)
            worst = max(worst, row["max_abs_err"])
            emit({"phase": "k3", "n": PS_LAMBDA, "q": q, "t": t,
                  "wildcard_share": 0.1, **row})
            del pm, sm
            torch.cuda.empty_cache()
    pm = device_masks(torch, np, T.TermHasher(32).buckets(terms), 32, device)
    sm = torch.zeros((len(rects), 32), dtype=torch.float32, device=device)
    counts_error(torch, KM.keyword_match(pts_d, pm, rects_d, sm),
                 SM.spatial_match(pts_d, rects_d), "K3 with wildcards vs K2")
    emit({"phase": "k3", "wildcards_equal_k2": True, "q": len(rects)})
    return worst


def reset_launches(kern: dict) -> None:
    """Set every kernel wrapper's launch counts to 0 (``kern`` maps a
    kernel's name to its package), its split by kernel too."""
    for pkg in kern.values():
        pkg.ops.launches = 0
        for name in getattr(pkg.ops, "launches_by_kernel", ()):
            pkg.ops.launches_by_kernel[name] = 0


def read_launches(kern: dict) -> dict:
    return {name: pkg.ops.launches for name, pkg in kern.items()}


def read_by_kernel(kern: dict) -> dict:
    """The launch counts of the wrappers that launch more than one kernel
    (K4, K6), by kernel."""
    return {name: dict(pkg.ops.launches_by_kernel)
            for name, pkg in kern.items()
            if hasattr(pkg.ops, "launches_by_kernel")}


def phase_match(torch, T, np, kern, plane, device) -> dict:
    """The exact-match API at the main path's size (PERF.md §4): one
    hotspot-tick batch of LAMBDA tuples against the QUERIES standing
    range queries through ``TorchPlane.match_counts`` (K2), and against
    their centres as kNN foci through ``knn_distances`` (K4), each equal
    to its plain version on the card."""
    SM, KN = kern["spatial_match"], kern["knn_match"]
    pts, rects = _match_inputs(T, np, LAMBDA, QUERIES)
    foci = _centres(np, rects)
    reset_launches(kern)                      # counts from here …
    t0 = time.perf_counter()
    pc, qc = plane.match_counts(pts, rects)
    t1 = time.perf_counter()
    dist = plane.knn_distances(pts, foci, k=KNN_K)
    t2 = time.perf_counter()
    launches = read_launches(kern)            # … to here
    by_kernel = read_by_kernel(kern)["knn_match"]
    split = int(KN.ops.build()[1](LAMBDA, QUERIES, KNN_K) > 0)
    check(launches == {"stats_update": 0, "spatial_match": 1,
                       "keyword_match": 0, "knn_match": 1 + split,
                       "moe_histogram": 0, "flash_attention": 0}
          and by_kernel == {"knn_match_kernel": 1,
                            "knn_merge_kernel": split},
          f"match: launches {launches} ({by_kernel}), one K2 and one K4 "
          f"call expected")
    pts_d, rects_d, foci_d = _on(torch, device, pts, rects, foci)
    counts_error(torch, _on(torch, device, pc, qc),
                 SM.spatial_match_ref(pts_d, rects_d), "match: K2")
    check(np.array_equal(dist, KN.knn_match_ref(pts_d, foci_d, KNN_K)
                         .cpu().numpy()), "match: K4 differs from plain")
    check(pc.dtype == np.int32 and pc.shape == (LAMBDA,)
          and qc.shape == (QUERIES,) and int(pc.sum()) == int(qc.sum()),
          "match: count shapes or totals")
    check(dist.shape == (QUERIES, KNN_K) and np.isfinite(dist).all()
          and (np.diff(dist, axis=1) >= 0).all(), "match: kNN distances")
    emit({"phase": "match", "tuples": LAMBDA, "queries": QUERIES,
          "k": KNN_K, "pairs_matched": int(pc.sum()),
          "queries_hit": int((qc > 0).sum()),
          "tuples_matched": int((pc > 0).sum()),
          "match_counts_wall_s": t1 - t0, "knn_distances_wall_s": t2 - t1,
          "mean_kth_distance": float(dist[:, -1].mean()),
          "launches": launches, "launches_by_kernel": by_kernel})
    return {"pts": pts_d, "rects": rects_d, "foci": foci_d,
            "launches": launches, "by_kernel": by_kernel}


def _covered(np, terms, sub_terms):
    """(N, Q) exact per-term conjunction: every subscription term is
    among the tuple's terms."""
    tsets = [set(map(int, row)) for row in terms]
    return np.array([[set(map(int, s)) <= ts for s in sub_terms]
                     for ts in tsets])


def _collision_bound(T, np, plane, wl) -> dict:
    """benchmarks/pubsub.py's collision bound on the card plane (and the
    port's NumPy plane): hashed-bucket matching never drops an exact
    per-term match (12 terms into 8 buckets overcount), and with an
    injective bucket map (40 terms into 4096 buckets) it is exact."""
    rng = np.random.default_rng(11)
    n, q = 300, 400
    pts = rng.random((n, 2)).astype(np.float32)
    lo = rng.random((q, 2)) * 0.8
    rects = np.concatenate([lo, np.minimum(lo + 0.2, 1.0)],
                           1).astype(np.float32)
    inside = ((pts[:, None, 0] >= rects[None, :, 0])
              & (pts[:, None, 0] <= rects[None, :, 2])
              & (pts[:, None, 1] >= rects[None, :, 1])
              & (pts[:, None, 1] <= rects[None, :, 3]))
    out = {}
    for hasher, vocab in ((T.TermHasher(8), 12), (T.TermHasher(4096), 40)):
        terms = rng.integers(0, vocab, (n, wl.tuple_terms))
        sub_terms = rng.integers(0, vocab, (q, wl.sub_terms))
        exact = inside & _covered(np, terms, sub_terms)
        pm = T.bucket_masks(hasher.buckets(terms), hasher.n_buckets)
        sm = hasher.sub_masks(sub_terms)
        for p in (T.NumpyPlane(), plane):
            per_pt, per_sub = p.keyword_match_counts(pts, pm, rects, sm)
            check((per_pt >= exact.sum(1)).all()
                  and (per_sub >= exact.sum(0)).all(),
                  f"{p.name}: hashed matching dropped a true match")
        if hasher.n_buckets == 4096:
            used = np.unique(np.concatenate([terms.ravel(),
                                             sub_terms.ravel()]))
            check(len(np.unique(hasher.buckets(used))) == len(used),
                  "collision fixture not injective")
            check(np.array_equal(per_pt, exact.sum(1)),
                  "injective bucket map: hashed != exact")
        out[f"T={hasher.n_buckets}"] = {
            "exact": int(exact.sum()),
            "overcount": int(per_pt.sum() - exact.sum())}
    return out


def _pubsub_parity(T, np, wl, plane_name: str) -> dict:
    """benchmarks/pubsub.py's plane parity: the same routed timeline on
    the card plane and the port's NumPy plane, counts exact, float
    metrics within rtol 1e-5."""
    base = T.Experiment(
        router=T.RouterSpec("swarm", grid_size=PS_GRID, history_seed=1),
        scenario=_ps_spec(T, PS_PARITY_TICKS, PS_PARITY_SUBS), workload=wl,
        engine=_ps_cfg(T, PS_PARITY_SUBS), data_plane="numpy")
    a = T.run(base).metrics.asarrays()
    b = T.run(base.with_(data_plane=plane_name)).metrics.asarrays()
    for name in ("injected", "transfers"):
        check(np.array_equal(np.asarray(a[name], np.float64),
                             np.asarray(b[name], np.float64)),
              f"pubsub parity: {name} differs")
    for name in ("units_of_work", "deliveries", "latency", "throughput"):
        np.testing.assert_allclose(np.asarray(b[name], np.float64),
                                   np.asarray(a[name], np.float64),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    return {"ticks": PS_PARITY_TICKS, "subscriptions": PS_PARITY_SUBS,
            "transfers": int(np.sum(b["transfers"])),
            "deliveries": float(np.sum(b["deliveries"]))}


def phase_pubsub(torch, T, np, kern, plane, plane_name, device) -> dict:
    """The pub/sub deployment of benchmarks/pubsub.py on the card plane:
    its collision-bound and plane-parity gates, SWARM and static-history
    through ``run_suite`` (1 000 000 subscriptions, 60 ticks; SWARM must
    sustain 2× static-history's hot-window throughput, K1 must launch
    once per SWARM round close), then one full-scale delivery tick
    through ``keyword_match_counts`` (K3), held against its plain version
    and K2."""
    wl = T.WorkloadSpec(query_model="spatial_keyword")
    reset_launches(kern)                      # counts from here …
    bound = _collision_bound(T, np, plane, wl)
    parity = _pubsub_parity(T, np, wl, plane_name)

    k1_before = kern["stats_update"].ops.launches
    exps = {name: T.Experiment(
        router=T.RouterSpec(name, grid_size=PS_GRID, history_seed=1),
        scenario=_ps_spec(T, PS_TICKS, PS_SUBS), workload=wl,
        engine=_ps_cfg(T, PS_SUBS), data_plane=plane_name)
        for name in ("swarm", "static_history")}
    results = T.run_suite(exps.values())
    k1_suite = kern["stats_update"].ops.launches - k1_before
    lo, hi = PS_TICKS // 6, PS_TICKS // 6 + 2 * PS_TICKS // 3   # hot window
    systems = {}
    for name, exp in exps.items():
        res = results[exp.label]
        a = res.asarrays()
        for key, val in a.items():
            check(np.isfinite(np.asarray(val, np.float64)).all(),
                  f"pubsub {name}: {key} not finite")
        check(len(a["throughput"]) == PS_TICKS, f"pubsub {name}: ticks")
        thr = np.asarray(a["throughput"], np.float64)
        lat = np.asarray(a["latency"], np.float64)
        systems[name] = {"thr_hot": float(thr[lo:hi].mean()),
                         "lat_hot": float(lat[lo:hi].mean()),
                         "deliveries": float(np.sum(a["deliveries"])),
                         "transfers": int(np.sum(a["transfers"])),
                         "wall_s": res.wall_s}
    rounds = results[exps["swarm"].label].router.swarm.round_no
    check(rounds > 0 and k1_suite == rounds,
          f"pubsub: K1 launched {k1_suite}× for {rounds} SWARM round closes")
    ratio = systems["swarm"]["thr_hot"] / max(
        systems["static_history"]["thr_hot"], 1e-9)
    check(ratio >= 2.0, f"pubsub: SWARM {ratio:.2f}× static-history "
          "hot-window throughput, 2× required")

    # one delivery tick at full scale through the exact-match API
    _, pts, terms, rects, sub_terms = _delivery_tick(T, np, PS_LAMBDA,
                                                     PS_SUBS)
    hasher = T.TermHasher(wl.term_buckets)
    pm = T.bucket_masks(hasher.buckets(terms), hasher.n_buckets)
    sm = hasher.sub_masks(sub_terms)
    k3_before = kern["keyword_match"].ops.launches
    t0 = time.perf_counter()
    pc, qc = plane.keyword_match_counts(pts, pm, rects, sm)
    tick_s = time.perf_counter() - t0
    launches = read_launches(kern)            # … to here
    check(launches["keyword_match"] == k3_before + 1,
          "pubsub: the delivery tick did not launch K3 once")
    check(launches["stats_update"] > 0 and launches["keyword_match"] > 0,
          f"pubsub: launches {launches}")
    pts_d, pm_d, rects_d, sm_d = _on(torch, device, pts, pm, rects, sm)
    with tf32(torch, True):
        counts_error(torch, _on(torch, device, pc, qc),
                     kern["keyword_match"].keyword_match_ref(pts_d, pm_d,
                                                             rects_d, sm_d),
                     "pubsub: K3")
    spatial = kern["spatial_match"].spatial_match(pts_d, rects_d)[0]
    check(bool((torch.from_numpy(pc).to(device) <= spatial).all()),
          "pubsub: K3 delivered more than K2 matched")
    idx = T.SubscriptionIndex.build(hasher, rects, sub_terms)
    probes = hasher.tuple_buckets(terms)
    posting = np.array([len(idx.posting(b))
                        for b in range(hasher.n_buckets + 1)])
    cand = np.where(probes >= 0, posting[np.maximum(probes, 0)], 0).sum(1)
    for i in range(16):           # the closed form against the index
        check(cand[i] == len(idx.candidates(probes[i])),
              "pubsub: candidate count differs from SubscriptionIndex")
    out = {"phase": "pubsub", "grid": PS_GRID, "machines": PS_MACHINES,
           "subscriptions": PS_SUBS, "ticks": PS_TICKS,
           "lambda_max": PS_LAMBDA, "hot_terms": PS_HOT_TERMS,
           "term_peak": PS_TERM_PEAK, "cap_units": PS_CAP_PER_SUB * PS_SUBS,
           "term_buckets": wl.term_buckets, "cuts": [],
           "collision_bound": bound, "parity": parity, "systems": systems,
           "throughput_ratio": ratio,
           "latency_ratio": systems["static_history"]["lat_hot"]
           / max(systems["swarm"]["lat_hot"], 1e-9),
           "swarm_rounds": rounds, "k1_launches_suite": k1_suite,
           "delivery_tick": {
               "tuples": PS_LAMBDA, "tick": PS_TICKS // 2,
               "deliveries": int(pc.sum()),
               "subscriptions_hit": int((qc > 0).sum()),
               "spatial_matches": int(spatial.sum()),
               "candidates_per_tuple": float(cand.mean()),
               "candidate_share": float(cand.mean() / PS_SUBS),
               "wall_s": tick_s},
           "launches": launches}
    emit(out)
    return {"pts": pts_d, "pm": pm_d, "rects": rects_d, "sm": sm_d,
            "launches": launches, "k1_launches": k1_suite}


def _small_run(T, plane, timeline: str):
    """The tests/test_fused.py timeline (G=64, M=8, 12 ticks, rounds
    every 3 ticks, fused windows of 8) and a longer one whose rounds
    move partitions."""
    scen = dict(ticks=12, preload_queries=500, query_burst=200)
    beta, every = 4, 3
    if timeline == "rebalancing":
        scen.update(ticks=24, peak=0.6)
        beta, every = 2, 2
    cfg = T.EngineConfig(num_machines=8, cap_units=1e9, lambda_max=2000,
                         mem_queries=10**8, round_every=every,
                         fused_window=8)
    return T.run(T.Experiment(
        router=T.RouterSpec("swarm", grid_size=64, beta=beta),
        scenario=T.ScenarioSpec("uniform_normal", **scen), engine=cfg,
        data_plane=plane, seed=0)).metrics.asarrays()


def phase_parity(T, np, plane) -> None:
    for timeline in ("fused", "rebalancing"):
        ref = _small_run(T, "numpy", timeline)
        got = _small_run(T, plane, timeline)
        for name in ("injected", "q_total", "transfers"):
            check(np.array_equal(got[name], ref[name]),
                  f"parity: {name} differs ({timeline})")
        worst = {}
        for name in ("units_of_work", "throughput", "latency",
                     "utilization", "wire_bytes", "migration_bytes"):
            a = np.asarray(got[name], np.float64)
            b = np.asarray(ref[name], np.float64)
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6,
                                       err_msg=name)
            worst[name] = float(np.max(np.abs(a - b)
                                       / np.maximum(np.abs(b), 1e-6)))
        emit({"phase": "parity", "timeline": timeline,
              "transfers": int(np.sum(got["transfers"])),
              "injected": int(np.sum(got["injected"])),
              "max_rel_err": worst})


def phase_tf32(torch, T, np, plane) -> None:
    """One fused window whose busiest cells get more than 2048 tuples,
    with TF32 enabled for every float32 matmul in the process."""
    with tf32(torch, True):
        g, m, w, b = 64, 8, 2, 6000
        rng = np.random.default_rng(5)
        xy = rng.uniform(0, 1, (w, b, 2)).astype(np.float32)
        xy[:, :2500] = rng.uniform(0.5, 0.5 + 0.9 / g, (w, 2500, 2))
        xy[:, 2500:5000] = rng.uniform(0.1, 0.1 + 0.9 / g, (w, 2500, 2))
        router = T.SwarmRouter(g, m, beta=4)
        host = router.fused_host_state()
        cp = router._cost_params()
        fp = T.FusedParams(cap_units=1e12, lambda_max=float(b), bp_high=2.0,
                           bp_dec=0.6, bp_inc=0.04, alive=np.ones(m),
                           track_stats=True, n_alloc=host.n_alloc)
        banks = {}
        for name, pl in (("torch", plane), ("numpy", T.get_plane("numpy"))):
            carry = T.EngineCarry(np.zeros(m), np.zeros(m), float(b))
            st, _, _, ok = pl.run_window(pl.make_state(host), cp, fp,
                                         carry, xy)
            check(ok, "F2 window declined")
            banks[name] = pl.collector_banks(st)
        for a, c in zip(banks["torch"], banks["numpy"]):
            check(np.array_equal(a, c),
                  "F2: collector banks differ with TF32")
        from repro_torch.core.geometry import points_to_cells
        row, col = points_to_cells(xy[0], g)
        emit({"phase": "f2",
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "max_cell_count": int(np.bincount(row * g + col).max()),
              "collectors_equal": True})


def _main_engine(T, plane, telemetry=None):
    """The main path at its realistic size (see PERF.md, "Cells") with
    its standing queries preloaded; returns the engine and the preload's
    host seconds."""
    cfg = T.EngineConfig(num_machines=MACHINES, cap_units=1e12,
                         lambda_max=float(LAMBDA), mem_queries=10**9,
                         mem_tuples=1e12, round_every=ROUND_EVERY,
                         fused_window=WINDOW, telemetry=telemetry)
    src = T.scenario("uniform_normal", seed=0, horizon=TICKS)
    router = T.SwarmRouter(GRID, MACHINES, beta=8, data_plane=plane)
    eng = T.StreamingEngine(router, src, cfg)
    t0 = time.perf_counter()
    eng.preload_queries(src.sample_queries(QUERIES))
    return eng, time.perf_counter() - t0


def _run(torch, np, eng, main=None) -> float:
    """Host seconds of ``eng.run(TICKS)``, the card drained at both
    ends; a rerun must inject what the first run injected."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if main is not None:
        check(int(np.sum(eng.metrics.asarrays()["injected"]))
              == main["injected"], "rerun of the main path differs")
    return wall


def phase_main(torch, T, np, SU) -> dict:
    """The main path as a user runs it — no tracer, no profiler, nothing
    wrapped: its wall time gives the end-to-end rate, and K1's launches
    are read from the wrapper's own counter."""
    eng, preload_s = _main_engine(T, T.TorchPlane("cuda"))
    router = eng.router
    torch.cuda.reset_peak_memory_stats()
    SU.ops.launches = 0                       # counts from here …
    wall = _run(torch, np, eng)
    launches = SU.ops.launches                # … to here
    mt = eng.metrics.asarrays()
    rounds = router.swarm.round_no
    transfers = int(np.sum(mt["transfers"]))
    for name in ("units_of_work", "throughput", "latency", "utilization"):
        arr = np.asarray(mt[name], np.float64)
        check(np.isfinite(arr).all(), f"main path: {name} not finite")
    check(len(mt["injected"]) == TICKS, "main path: wrong tick count")
    check(np.asarray(mt["utilization"]).shape == (TICKS, MACHINES),
          "main path: utilization shape")
    check(rounds >= TICKS // ROUND_EVERY - 1, "main path: rounds missing")
    check(transfers >= 1, "main path: no rebalance")
    check(launches == rounds, f"K1 launched {launches}× for {rounds} "
          "round closes")
    injected = int(np.sum(mt["injected"]))
    out = {"phase": "main", "grid": GRID, "machines": MACHINES,
           "lambda_max": LAMBDA, "queries": QUERIES, "ticks": TICKS,
           "round_every": ROUND_EVERY, "fused_window": WINDOW,
           "injected": injected, "wall_s": wall,
           "injected_per_s": injected / wall, "preload_s": preload_s,
           "rounds": rounds, "k1_launches": launches,
           "rehomed": router.plane.rehomed, "transfers": transfers,
           "live_partitions": int(len(router.index.parts.live_ids())),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(out)
    return {**out, "metrics": mt}


def _spans(tracer) -> tuple[dict, int]:
    """Host seconds and calls per span name of a traced run, and the
    fused windows it declined."""
    spans, declined = {}, 0
    for ev in tracer.events:
        if ev.kind != "span":
            continue
        s = spans.setdefault(ev.name, {"s": 0.0, "calls": 0})
        s["s"] += ev.dur / 1e9
        s["calls"] += 1
        if ev.name == "fused_window" and not ev.args.get("ok", True):
            declined += 1
    return spans, declined


def phase_breakdown(torch, T, np, SU, main) -> dict:
    """The same run with the engine's tracer on: host seconds per span
    (``round_close`` a whole round, host planner included;
    ``stats_close`` inside it the in-place K1 launch of
    ``TorchPlane.close_round`` and the wait for it; ``fused_window`` a
    whole window, staging included; ``fused_window_dispatch`` the body
    of ``TorchPlane.run_window``; ``tick`` the per-tick boundary steps),
    ``stats_close`` per call, the declined windows, and the last round
    close's input as K1's in-place entry found it — the live ids and
    copies of both banks, taken inside the last ``stats_close`` span
    (their seconds are left out of the time per call) — for phases
    ``k1_live`` and ``k1`` and the kernels line, with its six input
    channels of the live rows as the device contract's (6, 2·live, G+1)
    bank."""
    eng, _ = _main_engine(T, T.TorchPlane("cuda"),
                          telemetry=T.TelemetryConfig(tick_spans=False))
    last, calls = {}, []
    real = SU.close_live

    def keep_input(rows, cols, live, decay=0.5, device=None):
        calls.append(1)
        if len(calls) == main["rounds"]:
            t0 = time.perf_counter()
            last.update(live=np.array(live), decay=decay,
                        rows=rows.numpy().copy(), cols=cols.numpy().copy())
            last["copy_s"] = time.perf_counter() - t0
        return real(rows, cols, live, decay, device)

    SU.close_live = keep_input
    try:
        wall = _run(torch, np, eng, main)
    finally:
        SU.close_live = real
    spans, declined = _spans(eng.tracer)
    close = spans.get("stats_close", {})
    check(close.get("calls") == main["rounds"] == len(calls)
          and "live" in last and "fused_window_dispatch" in spans,
          "traced run: round-close or window spans missing")
    last["stats_close_ms_per_call"] = (
        (close["s"] - last["copy_s"]) / close["calls"] * 1e3)
    in_ch, live = list(SU.IN_CH), last["live"]
    last["bank6"] = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [last["rows"][in_ch][:, live], last["cols"][in_ch][:, live]],
        axis=1))).cuda()
    emit({"phase": "breakdown", "wall_s": wall, "declined_windows": declined,
          "spans": spans,
          "stats_close_ms_per_call": last["stats_close_ms_per_call"],
          "capture_copy_s": last["copy_s"],
          "k1_last_shape": list(last["bank6"].shape)})
    return last


def _parity(np, ref: dict, got: dict, rtol: float, what: str) -> dict:
    """Check ``got`` against ``ref`` (the SHARD_EXACT metrics equal, the
    others within ``rtol``) and return each metric's largest relative
    error."""
    worst = {}
    for name in ref:
        a = np.asarray(ref[name], np.float64)
        b = np.asarray(got[name], np.float64)
        if name in SHARD_EXACT:
            check(np.array_equal(a, b), f"{what}: {name} differs")
            continue
        check(np.allclose(b, a, rtol=rtol, atol=1e-6),
              f"{what}: {name} beyond rtol {rtol}")
        worst[name] = float(np.max(np.abs(a - b)
                                   / np.maximum(np.abs(a), 1e-6),
                                   initial=0.0))
    return worst


def _shard_timeline(T, plane, name: str) -> tuple[dict, int]:
    """One of tests/test_sharded.py's timelines through ``plane``: the
    rebalance-and-failure one (cap_units 3e3: backpressure declines every
    fused window, each replayed per tick), the same with backpressure
    idle (its windows run on the plane) and the keyword one.  Returns
    the metrics and the bytes the plane resharded."""
    cap = {"rebalance": 3e3}.get(name, 1e9)
    cfg = T.EngineConfig(num_machines=SHARD_M, cap_units=cap,
                         lambda_max=2000, mem_queries=10**8, round_every=8,
                         fused_window=8)
    if name == "keyword":
        wl = T.WorkloadSpec(query_model="spatial_keyword")
        scen = T.ScenarioSpec("hot_hashtags", ticks=24, preload_queries=400,
                              query_burst=100, hot_terms=2, term_peak=0.4)
    else:
        wl = None
        scen = T.ScenarioSpec(
            "normal_normal", ticks=48, preload_queries=800, query_burst=200,
            peak=0.6, membership=(T.MembershipEvent(20, "fail", 3),
                                  T.MembershipEvent(34, "join", 3)))
    router = T.RouterSpec("swarm", grid_size=SHARD_G, beta=4).build(
        num_machines=SHARD_M, workload=wl, data_plane=plane, seed=0)
    eng = T.StreamingEngine(router, scen.build(seed=0, workload=wl), cfg)
    router.ingest(eng.stream.preload(scen.preload_queries))
    before = plane.reshard_bytes_total
    return eng.run(scen.ticks).asarrays(), plane.reshard_bytes_total - before


def phase_sharded(torch, T, np, SU, main, smi: str) -> dict:
    """The main path's deployment (``_main_engine``) on
    ``ShardedTorchPlane`` at each of SHARD_COUNTS shards, colocated on
    the card (16 machines a shard at four): each run against phase
    ``main``'s ``TorchPlane`` run of this call (SHARD_EXACT metrics
    equal, the rest within rtol 1e-3), its bytes resharded equal to the
    billed migration bytes (> 0), one K1 launch a round close.  Then
    the widest run once more with the tracer on (seconds per span), and
    the three timelines of ``_shard_timeline`` on four shards, the card
    against the CPU port (rtol 1e-3, keyword 1e-4).  Returns K1's
    launches over the three untraced main-size runs."""
    ref = main["metrics"]
    runs, k1_total = {}, 0
    for d in SHARD_COUNTS:
        plane = T.ShardedTorchPlane(d, "cuda", colocate=True)
        eng, preload_s = _main_engine(T, plane)
        torch.cuda.reset_peak_memory_stats()
        SU.ops.launches = 0                   # counts from here …
        wall = _run(torch, np, eng)
        k1 = SU.ops.launches                  # … to here
        k1_total += k1
        mt = eng.metrics.asarrays()
        rounds = eng.router.swarm.round_no
        check(k1 == rounds, f"sharded D={d}: K1 launched {k1}× for "
              f"{rounds} round closes")
        worst = _parity(np, ref, mt, 1e-3, f"sharded D={d} vs TorchPlane")
        billed = int(np.sum(mt["migration_bytes"]))
        check(billed > 0 and plane.reshard_bytes_total == billed,
              f"sharded D={d}: resharded {plane.reshard_bytes_total} bytes, "
              f"billed {billed}")
        injected = int(np.sum(mt["injected"]))
        runs[d] = {
            "injected_per_s": injected / wall, "wall_s": wall,
            "preload_s": preload_s, "rounds": rounds, "k1_launches": k1,
            "windows": plane.windows,
            "exchange_bytes_per_window":
                plane.exchange_bytes_total / max(plane.windows, 1),
            "reshard_bytes": plane.reshard_bytes_total,
            "migration_bytes": billed,
            "shard_tuples": plane.shard_tuples.tolist(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "colocated": plane.colocated,
            "devices": [str(x) for x in plane.shards],
            "max_rel_err": worst}
        del eng, plane
    # the widest run again with the engine's tracer on: the span
    # sharded_window_dispatch is the window body (binning, exchange,
    # slot counts, scan) beside phase breakdown's fused_window_dispatch
    eng, _ = _main_engine(T, T.ShardedTorchPlane(SHARD_COUNTS[-1], "cuda",
                                                 colocate=True),
                          telemetry=T.TelemetryConfig(tick_spans=False))
    traced_wall = _run(torch, np, eng, main)
    spans, declined = _spans(eng.tracer)
    check("sharded_window_dispatch" in spans and declined == 0,
          "sharded traced run: window spans missing or windows declined")
    del eng
    timelines = {}
    for name in ("rebalance", "rebalance-idle", "keyword"):
        card = T.ShardedTorchPlane(4, "cuda", colocate=True)
        got, moved = _shard_timeline(T, card, name)
        want, want_moved = _shard_timeline(
            T, T.ShardedTorchPlane(4, "cpu"), name)
        worst = _parity(np, want, got, 1e-4 if name == "keyword" else 1e-3,
                        f"sharded timeline {name}: card vs CPU")
        billed = int(np.sum(got["migration_bytes"]))
        check(moved == want_moved == billed,
              f"sharded timeline {name}: resharded {moved} bytes "
              f"(CPU {want_moved}), billed {billed}")
        timelines[name] = {"transfers": int(np.sum(got["transfers"])),
                           "reshard_bytes": moved, "windows": card.windows,
                           "max_rel_err": worst}
    emit({"phase": "sharded", "card": smi,
          "torch_plane_injected_per_s": main["injected_per_s"],
          "grid": GRID, "machines": MACHINES, "lambda_max": LAMBDA,
          "queries": QUERIES, "ticks": TICKS, "shards": runs,
          "traced": {"shards": SHARD_COUNTS[-1], "wall_s": traced_wall,
                     "spans": spans},
          "timelines": timelines})
    return {"k1_launches": k1_total}


def phase_profile(torch, T, np, main) -> None:
    """The same run under ``torch.profiler``: the card's busy seconds
    over the (profiler-lengthened) wall time, and its largest items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng, _ = _main_engine(T, T.TorchPlane("cuda"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _run(torch, np, eng, main)
    # device-side events only (kernels, copies, sets): the host ops that
    # launched them carry the same time as their own
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total  # noqa: E731
    busy_us = sum(dev(e) for e in evs)
    check(busy_us > 0, "profile: no device time recorded")
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "top_device_ops": [[e.key, dev(e) / 1e3, e.count] for e in
                             sorted(evs, key=dev, reverse=True)[:8]]})


# ---------------------------------------------------------------------------
# the LM serving path: kernels K5 and K6, qwen2-moe-a2.7b served
# ---------------------------------------------------------------------------

def k5_cost(n: int, e: int) -> dict:
    """K5's least time: ids and gates (n assignments, 4 bytes each) read
    once, the two (E,) float32 outputs written once; one add to a count
    and one to a load per assignment."""
    nbytes = n * 8 + 2 * e * 4
    ops = 2 * n
    bound_ms, bound_by = roofline(nbytes, ops)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "peak_ops_per_s": FP32_OPS_PER_S}


def launch_floor_ms(torch) -> float:
    """Device time of one empty kernel (``torch.cuda._sleep(0)``), timed
    as :func:`time_call_ms` times a kernel: the floor under a launch."""
    return time_ms(torch, [lambda: torch.cuda._sleep(0)])


def k5_row(torch, MH, MO, idx, gates, e: int) -> dict:
    """K5 against its plain version on card tensors: counts exact, load
    within rtol 1e-5, equal bit for bit to the kernel's written-out sum
    order (``order.py``) and identical across two launches; times beside
    ``torch.bincount`` of the counts plus a weighted one of the load (on
    ids shifted by one, so that −1 falls into a bin of its own) and an
    empty kernel's."""
    counts, load = MH.moe_histogram(idx, gates, num_experts=e)
    again = MH.moe_histogram(idx, gates, num_experts=e)
    want_c, want_l = MH.moe_histogram_ref(idx, gates, e)
    order_c, order_l = (torch.from_numpy(a).to(idx.device) for a in
                        MO.moe_histogram_order(idx.cpu().numpy(),
                                               gates.cpu().numpy(), e))
    torch.cuda.synchronize()
    check(torch.equal(counts, want_c), "K5: counts differ from the plain "
          "version")
    torch.testing.assert_close(load, want_l, rtol=1e-5, atol=1e-5)
    check(torch.equal(counts, order_c) and torch.equal(load, order_l),
          "K5: load differs from the kernel's written-out sum order")
    check(torch.equal(counts, again[0]) and torch.equal(load, again[1]),
          "K5: two launches on the same input differ")
    shifted = (idx.reshape(-1) + 1).long()
    flat_g = gates.reshape(-1)

    def library():
        torch.bincount(shifted, minlength=e + 1)
        torch.bincount(shifted, weights=flat_g, minlength=e + 1)

    return {"max_abs_err": float((counts - want_c).abs().max()),
            "load_max_rel_err": float(((load - want_l).abs()
                                       / want_l.abs().clamp_min(1e-30))
                                      .max()),
            "ms": time_call_ms(torch, lambda: MH.moe_histogram(
                idx, gates, num_experts=e)),
            "plain_ms": time_call_ms(
                torch, lambda: MH.moe_histogram_ref(idx, gates, e)),
            "library_ms": time_call_ms(torch, library),
            "launch_floor_ms": launch_floor_ms(torch),
            **k5_cost(idx.numel(), e)}


def phase_k5(torch, np, MH, MO, device) -> float:
    """K5 at (T, K, E) in K5_SHAPES, a tenth of the ids −1 (padding)."""
    worst = 0.0
    for t, k, e in K5_SHAPES:
        rng = np.random.default_rng(t + k + e)
        idx = rng.integers(0, e, (t, k)).astype(np.int32)
        idx[rng.random((t, k)) < 0.1] = -1
        gates = rng.uniform(0, 1, (t, k)).astype(np.float32)
        idx_d, gates_d = _on(torch, device, idx, gates)
        row = k5_row(torch, MH, MO, idx_d, gates_d, e)
        worst = max(worst, row["max_abs_err"])
        emit({"phase": "k5", "t": t, "k": k, "e": e, **row})
    return worst


def visible_keys(s: int, skv: int, causal: bool, window, q_offset: int):
    """Keys the query rows may see, summed over the rows, and the key
    range [lo, hi) they see together."""
    seen, lo, hi = 0, skv, 0
    for i in range(s):
        r = i + q_offset
        a = max(0, r - window + 1) if window else 0
        b = min(skv, r + 1) if causal else skv
        if b > a:
            seen, lo, hi = seen + b - a, min(lo, a), max(hi, b)
    return seen, min(lo, hi), hi


def k6_cost(q, k, causal, window, q_offset) -> dict:
    """K6's least time: q read and o written once, and of k and v the
    rows some query may see, each once; 4·D operations per visible
    (query, key) pair (Q·Kᵀ and P·V), against the bf16 tensor-core peak
    for bf16 inputs and the float32 peak for float32 inputs."""
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    seen, lo, hi = visible_keys(s, skv, causal, window, q_offset)
    elem = q.element_size()
    nbytes = elem * (2 * b * h * s * d + 2 * b * hkv * (hi - lo) * d)
    ops = 4 * d * b * h * seen
    peak = BF16_OPS_PER_S if elem == 2 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "peak_ops_per_s": peak,
            "visible_pairs": seen * b * h}


def k6_kernel(FA, q) -> tuple[str, int]:
    """Which of K6's kernels takes q, and the operations it issues per
    visible pair: the bf16 tensor-core kernel 6·D (P·V runs twice, P as
    two bf16 terms), the float32 tile and the decode kernels 4·D."""
    d = q.shape[3]
    if q.shape[2] <= FA.ops.ROW_MAX:
        return "flash_decode", 4 * d
    return ("flash_mma", 6 * d) if q.element_size() == 2 else ("flash_tile",
                                                                4 * d)


# the kernels of K3's and K5's sources, by a part of each mangled name:
# K3's match kernel for one mask word and for more, its two packing
# kernels and its word lister; K5's one kernel
PTXAS_KERNELS = {
    "keyword_match": ("keyword_match_kernelILb0E", "keyword_match_kernelILb1E",
                      "pack_bits_kernel", "rect_keys_kernel",
                      "list_words_kernel"),
    "moe_histogram": ("moe_histogram_kernel",),
}
# K4's and K6's decode kernels, by a part of each mangled name and how
# many instantiations each source must list: K4's match and merge
# kernels for list lengths 1 … 16, 24 and 32; K6's decode kernel for
# D in {16, 80, 128, 256} × {float32, bfloat16} × {1, 4} rows and its
# merge for each D and type
PTXAS_NEW_KERNELS = {
    "knn_match": {"knn_match_kernel": 18, "knn_merge_kernel": 18},
    "flash_attention": {"flash_decode": 16, "flash_merge": 8},
}


def ptxas(log: str) -> list:
    """Registers, spills and stack of each kernel of a source from nvcc's
    ``-Xptxas -v`` output (``_build.BUILD_LOG``: the log of the build
    that was loaded, kept beside the library)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
        elif cur is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("stack_frame", r"(\d+) bytes stack frame")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    return out


def _sdpa_call(torch, q, k, v, causal, window, q_offset):
    """One ``scaled_dot_product_attention`` call computing what K6 does
    on these inputs (a timing yardstick only): on the keys the rows can
    see, ``is_causal`` where that is the mask, else a boolean mask; GQA
    by ``enable_gqa``."""
    import torch.nn.functional as F
    s, skv = q.shape[2], k.shape[2]
    _, lo, hi = visible_keys(s, skv, causal, window, q_offset)
    kk, vv = k[:, :, lo:hi], v[:, :, lo:hi]
    gqa = q.shape[1] != k.shape[1]
    if s == 1 or (causal and not window and q_offset == 0 and hi == s):
        return lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=s > 1, enable_gqa=gqa)
    rows = torch.arange(s, device=q.device)[:, None] + q_offset
    cols = torch.arange(lo, hi, device=q.device)[None, :]
    mask = torch.ones((s, hi - lo), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    return lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                                  enable_gqa=gqa)


# K6's tolerances: the JAX package's (tests/test_kernels.py), float32
# atol 2e-5 and bfloat16 atol 3e-2, and for bfloat16 outputs also one
# that scales with the output (k6_check)
K6_F32_TOL, K6_BF16_TOL = 2e-5, 3e-2


def k6_check(torch, got, want, what: str) -> dict:
    """K6's output against its plain version's.  float32: within
    K6_F32_TOL everywhere.  bfloat16: within K6_BF16_TOL, and each
    element within two bfloat16 steps at its plain value plus
    K6_F32_TOL: the two compute in float32 and each round once to
    bfloat16, so they may differ by a step where their float32 sums
    round apart.  That bound shrinks with the output, so a kernel that
    dropped keys fails even where the outputs are far below 3e-2.  The
    error relative to the plain output's RMS is reported beside it."""
    w = want.float()
    diff = (got.float() - w).abs()
    err = float(diff.max())
    rms = float(w.square().mean().sqrt())
    out = {"max_abs_err": err, "rms_want": rms,
           "max_err_over_rms": err / max(rms, 1e-30)}
    finite = bool(torch.isfinite(got).all())
    if got.dtype == torch.float32:
        out["tol"] = K6_F32_TOL
        check(err <= K6_F32_TOL and finite,
              f"{what}: error {err} above {K6_F32_TOL}")
        return out
    _, e = torch.frexp(w)                 # |w| = m·2**e, m in [0.5, 1)
    step = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 8))
    worst = float((diff / (2 * step + K6_F32_TOL)).max())
    out.update(tol=K6_BF16_TOL, elementwise_tol="2 bf16 steps + 2e-5",
               elementwise_worst=worst)
    check(err <= K6_BF16_TOL and worst <= 1.0 and finite,
          f"{what}: error {err} (above {K6_BF16_TOL}) or {worst} of the "
          f"per-element bound")
    return out


def k6_row(torch, FA, q, k, v, causal=True, window=None, q_offset=0,
           timed=True) -> dict:
    """K6 against its plain version on card tensors (:func:`k6_check`),
    the plain version's float32 products in full float32 (TF32 off);
    if ``timed``, times beside one ``scaled_dot_product_attention``
    call, the rate on the 4·D count (``tflops``) and the operations the
    kernel issues (``issued_ops``, 6·D a pair on the tensor cores)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with tf32(torch, False):              # a float32 reference
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        out = k6_check(torch, got, want, f"K6 at {tuple(q.shape)} "
                       f"{q.dtype} window {window} offset {q_offset}")
        del got, want
        if not timed:
            return out
        ms = time_call_ms(torch, lambda: FA.flash_attention(q, k, v, **kw))
        cost = k6_cost(q, k, causal, window, q_offset)
        kernel, per_pair = k6_kernel(FA, q)
        return {**out, "ms": ms,
                "plain_ms": time_call_ms(
                    torch, lambda: FA.attention_ref(q, k, v, **kw)),
                "library_ms": time_call_ms(
                    torch, _sdpa_call(torch, q, k, v, causal, window,
                                      q_offset)),
                **cost, "tflops": cost["ops"] / ms / 1e9, "kernel": kernel,
                "issued_ops": per_pair * cost["visible_pairs"],
                "issued_tflops": per_pair * cost["visible_pairs"] / ms / 1e9}


def phase_k6(torch, FA, device) -> dict:
    """K6 at the cases of K6_CASES: qwen2-moe's prefill and decode (at
    the cache's end and mid-cache), h2o-danube's GQA sliding window at
    D = 80, gemma's D = 256, in bfloat16 and again in float32.  Returns
    the worst error of the prefill cases and of the decode cases."""
    worst = {"prefill": 0.0, "decode": 0.0}
    gen = torch.Generator(device=device).manual_seed(6)
    for name, b, h, hkv, s, skv, d, dt, window, off in K6_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   .to(dtype) for shape in ((b, h, s, d), (b, hkv, skv, d),
                                            (b, hkv, skv, d)))
        row = k6_row(torch, FA, q, k, v, True, window, off)
        kind = "decode" if s <= FA.ops.ROW_MAX else "prefill"
        worst[kind] = max(worst[kind], row["max_abs_err"])
        emit({"phase": "k6", "case": name, "shape": [b, h, hkv, s, skv, d],
              "dtype": dt, "window": window, "q_offset": off, **row})
        del q, k, v
        torch.cuda.empty_cache()
    return worst


class _Recorder:
    """Keeps the arguments of the last call of ``fn`` under the key
    ``want`` gives it ("prefill" or "decode": the serve path's last
    inputs of a kernel), and passes every call on to ``fn``."""

    def __init__(self, fn, want):
        self.fn, self.want, self.calls, self.last = fn, want, {}, None

    def __call__(self, *args, **kw):
        self.last = self.want(*args, **kw)
        self.calls[self.last] = (args, kw)
        return self.fn(*args, **kw)


def phase_serve(torch, kern, LS, L, MOE, device) -> dict:
    """The port's serving entry point, ``launch.serve.serve``, on
    qwen2-moe-a2.7b at full width and depth (PERF.md §4): LM_SESSIONS
    sessions routed over LM_REPLICAS replicas, replica 0's batch
    prefilled at LM_PROMPT tokens and decoded for LM_STEPS tokens.  K5
    must launch once per layer per prefill or decode call; K6's prefill
    kernel once per layer, its decode kernel once per layer per decode
    call and its merge after each decode launch whose keys are chunked
    (counted by the wrapper, by kernel); every logit must be finite.
    The kernels' last prefill and decode inputs are kept for the kernels
    line.  TF32 is off, as a user's process has it by default, so the
    MoE router's product is float32 as the config states."""
    fa = _Recorder(L.flash_attention,
                   lambda q, *a, **kw: "decode" if q.shape[2] == 1
                   else "prefill")
    mh = _Recorder(MOE.moe_histogram,        # the layer's attention call
                   lambda *a, **kw: fa.last)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L.flash_attention, MOE.moe_histogram = fa, mh
    try:
        with tf32(torch, False):              # the router's float32 product
            reset_launches(kern)              # counts from here …
            out = LS.serve(LM_ARCH, sessions=LM_SESSIONS,
                           prompt_len=LM_PROMPT, steps=LM_STEPS,
                           replicas=LM_REPLICAS, device=device,
                           log=logs.append)
            launches = read_launches(kern)    # … to here
            by_kernel = read_by_kernel(kern)
    finally:
        L.flash_attention, MOE.moe_histogram = fa.fn, mh.fn
    peak = torch.cuda.max_memory_allocated()
    layers = out["layers"]
    calls = 1 + out["decode_calls"]
    check(out["d_model"] == 2048 and layers == 24,
          "serve: not qwen2-moe-a2.7b at full width and depth")
    FA = kern["flash_attention"]
    (q, k, _), fkw = fa.calls["decode"]
    merge = int(FA.ops.decode_chunks(FA.ops.build(), q, k, **fkw) > 1)
    decodes = layers * (calls - 1)
    check(launches["moe_histogram"] == layers * calls
          and by_kernel["flash_attention"] == {
              "flash_decode": decodes, "flash_merge": merge * decodes,
              "flash_tile": 0, "flash_mma": layers}
          and launches["flash_attention"] == layers + (1 + merge) * decodes,
          f"serve: launches {launches} ({by_kernel}), {layers} K5 and "
          f"{layers} K6 calls per call expected over {calls} calls")
    check(all(launches[n] == 0 for n in ("stats_update", "spatial_match",
                                         "keyword_match", "knn_match")),
          f"serve: launches {launches}")
    check(out["logits_finite"], "serve: a logit is not finite")
    check(out["tokens"].shape == (out["batch"], LM_STEPS),
          "serve: token shape")
    counts = out["expert_counts"]
    k = 4                                         # qwen2-moe top-k
    check(counts[0].sum() == out["batch"] * LM_PROMPT * k * layers
          and (counts[1:].sum(1) == out["batch"] * k * layers).all(),
          "serve: expert counts do not add up to the assignments")
    prefill_tokens = out["batch"] * LM_PROMPT
    emit({"phase": "serve", "arch": LM_ARCH, "model": out["model"],
          "layers": layers, "d_model": out["d_model"], "experts": 60,
          "sessions": LM_SESSIONS, "replicas": LM_REPLICAS,
          "initial_spread": out["initial_spread"], "batch": out["batch"],
          "prompt_len": LM_PROMPT, "steps": LM_STEPS,
          "max_seq": out["max_seq"], "init_s": out["init_s"],
          "prefill_s": out["prefill_s"],
          "prefill_tokens_per_s": prefill_tokens / out["prefill_s"],
          "decode_s": out["decode_s"], "decode_calls": out["decode_calls"],
          "decode_tokens": out["decode_tokens"],
          "decode_tok_per_s": out["decode_tok_per_s"],
          "decode_ms_per_call": out["decode_s"] / out["decode_calls"] * 1e3,
          "max_memory_allocated": peak, "launches": launches,
          "launches_by_kernel": by_kernel,
          "replica_load_cv": out["replica_load_cv"],
          "rebalances": out["rebalances"], "ep_moves": out["ep_moves"],
          "ep_imbalance": out["ep_imbalance"],
          "logits_finite": out["logits_finite"], "log": logs})
    return {"launches": launches, "by_kernel": by_kernel, "fa": fa.calls,
            "mh": mh.calls, "batch": out["batch"], "layers": layers}


def _serve_calls(torch, M, cfg, params, prompts, cache, constraint, place,
                 teacher=None):
    """Prefill ``prompts`` and LM_STEPS − 1 greedy decode calls (fed
    ``teacher``'s tokens when given), timed with the card drained:
    (prefill s, decode s, logits of every call, the greedy tokens)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, _ = M.prefill(params, cfg, token_ids=place(prompts),
                                 max_seq=LM_PROMPT + LM_STEPS, cache=cache,
                                 constraint=constraint)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    outs, toks = [logits], [tok]
    t0 = time.perf_counter()
    for i in range(LM_STEPS - 1):
        feed = tok if teacher is None else teacher[i]
        logits, cache, _ = M.decode_step(params, cfg, cache, place(feed),
                                         constraint=constraint)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        outs.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    return prefill_s, time.perf_counter() - t0, outs, toks


def phase_serve_mesh(torch, np, kern, M, configs, serve, device) -> dict:
    """Phase serve's model (qwen2-moe-a2.7b at full width and depth, the
    seed-0 weights) and replica 0's traffic (its batch prefilled at
    LM_PROMPT tokens, LM_STEPS − 1 decode calls) on a (1, 1) ("data",
    "model") mesh of a one-rank NCCL group: the weights placed by
    ``param_shardings`` (``DTensor.from_local`` on the same tensors, no
    copy), the cache by ``cache_shardings``, ``make_constraint`` on,
    beside the same calls unsharded in the same call.  The sharded run
    is fed the unsharded run's greedy tokens.  Gates: every logit equal
    to the unsharded path's (bit for bit expected; within serving's 4
    bf16 steps at the largest logit, else), K5 and K6 launched as often.
    The group is destroyed before the phase returns."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import cache_shardings
    cfg = configs.get_config(LM_ARCH)
    batch = serve["batch"]
    _free_card(torch)
    params = M.init_params(cfg, 0, device=device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, LM_PROMPT)).astype(np.int32)).to(device)
    out = {}
    with tf32(torch, False):
        reset_launches(kern)
        torch.cuda.reset_peak_memory_stats()
        pre, dec, plain, teacher = _serve_calls(torch, M, cfg, params,
                                                prompts, None, None,
                                                lambda t: t)
        out["plain"] = {"prefill_s": pre, "decode_s": dec,
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(),
                        "launches": read_launches(kern),
                        "by_kernel": read_by_kernel(kern)}
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device(
                                    "cuda", torch.cuda.current_device()))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            placed = SH.shard_params(params, SH.param_shardings(cfg, mesh))
            check(all(p.to_local().data_ptr() == q.data_ptr() for p, q in
                      zip(_tree_leaves(placed), _tree_leaves(params))),
                  "serve_mesh: the placed weights are copies")
            cache = SH.shard_params(
                M.init_cache(cfg, batch, LM_PROMPT + LM_STEPS,
                             device=device),
                cache_shardings(cfg, mesh, batch, LM_PROMPT + LM_STEPS))
            torch.cuda.reset_peak_memory_stats()
            reset_launches(kern)
            with implicit_replication():
                pre, dec, sharded, _ = _serve_calls(
                    torch, M, cfg, placed, prompts, cache,
                    SH.make_constraint(mesh),
                    lambda t: SH.shard_tensor(t, SH.batch_sharding(mesh, 2)),
                    teacher=teacher)
                sharded = [t.to_local() for t in sharded]
            out["mesh"] = {"prefill_s": pre, "decode_s": dec,
                           "max_memory_allocated":
                               torch.cuda.max_memory_allocated(),
                           "launches": read_launches(kern),
                           "by_kernel": read_by_kernel(kern)}
        finally:
            dist.destroy_process_group()
    exact = all(torch.equal(a, b) for a, b in zip(sharded, plain))
    largest = max(float(t.float().abs().max()) for t in plain)
    tol = 4 * 2.0 ** (math.floor(math.log2(largest)) - 7)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(sharded, plain))
    check(exact or worst <= tol, f"serve_mesh: logits differ from the "
          f"unsharded path by {worst} (4 bf16 steps: {tol})")
    check(out["mesh"]["launches"] == out["plain"]["launches"]
          and out["mesh"]["by_kernel"] == out["plain"]["by_kernel"],
          f"serve_mesh: launches {out['mesh']['launches']} against the "
          f"unsharded path's {out['plain']['launches']}")
    for run in out.values():
        run["decode_ms_per_call"] = run["decode_s"] / (LM_STEPS - 1) * 1e3
    emit({"phase": "serve_mesh", "arch": LM_ARCH, "batch": batch,
          "prompt_len": LM_PROMPT, "decode_calls": LM_STEPS - 1,
          "mesh": [["data", 1], ["model", 1]], "bit_for_bit": exact,
          "max_abs_diff": worst, "tolerance": tol, **out})
    del params, placed, cache, plain, sharded
    _free_card(torch)
    return {"launches": out["mesh"]["launches"],
            "by_kernel": out["mesh"]["by_kernel"]}


def _rules_param_bytes(SH, configs, M, arch: str, train: bool) -> int:
    """Per-device parameter bytes of ``arch`` on DRYRUN_MESH by the
    sharding rules' arithmetic: each leaf's elements over the product of
    the mesh axes its spec names, at float32 (training's masters) or at
    ``init_params``'s types (serving)."""
    import types
    mesh = types.SimpleNamespace(shape=DRYRUN_MESH,
                                 axis_names=tuple(DRYRUN_MESH))
    cfg = configs.get_config(arch)
    total = 0
    for (path, leaf), (_, sh) in zip(
            _items(M.abstract_params(cfg)),
            _items(SH.param_shardings(cfg, mesh))):
        split = math.prod(DRYRUN_MESH[a] for entry in sh.spec if entry
                          for a in (entry if isinstance(entry, tuple)
                                    else (entry,)))
        keys = tuple(k for k in path if isinstance(k, str))
        wide = train or M.keeps_float32(keys) or cfg.dtype != "bfloat16"
        total += leaf.numel() // split * (4 if wide else 2)
    return total


def _items(tree) -> list:
    from repro_torch import tree as TR
    return list(TR.items(tree))


def phase_dryrun(SH, configs, M) -> None:
    """``python -m repro_torch.launch.dryrun`` on the 16×16 production
    mesh for DRYRUN_CELLS, one child process a cell (a fake process
    group of 256 ranks each; fake CUDA shards, no card used).  Prints
    each record's status, per-device bytes, FLOPs, collective bytes by
    kind, dominant term, trace seconds and K5/K6 op calls.  Gates:
    status ok, per-device parameter bytes equal to the rules' shard
    sizes, 0 < useful_fraction ≤ 1.5."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        for arch, shape in DRYRUN_CELLS:
            res = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", d],
                capture_output=True, text=True, timeout=DRYRUN_TIMEOUT,
                env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
            path = os.path.join(d, f"{arch}__{shape}__16x16.json")
            check(res.returncode == 0 and os.path.exists(path),
                  f"dryrun {arch} × {shape}: exit {res.returncode}\n"
                  f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
            with open(path) as f:
                rec = json.load(f)
            rl, mem = rec["roofline"], rec["memory"]
            emit({"phase": "dryrun", "arch": arch, "shape": shape,
                  "mesh": rec["mesh"], "status": rec["status"],
                  "fake_device": rec["fake_device"],
                  "argument_bytes_by_group": mem["argument_bytes_by_group"],
                  "eager_peak_bytes": mem["eager_peak_bytes"],
                  "flops_per_device": rl["flops_per_device"],
                  "traced_flops_per_device": rl["traced_flops_per_device"],
                  "collectives": rl["collectives"],
                  "collective_ops": rl["collective_ops"],
                  "dominant": rl["dominant"], "t_compute": rl["t_compute"],
                  "t_memory": rl["t_memory"],
                  "t_collective": rl["t_collective"],
                  "useful_fraction": rec["model"]["useful_fraction"],
                  "build_s": rec["build_s"], "trace_s": rec["trace_s"],
                  "kernel_calls": rec["kernel_calls"]})
            check(rec["status"] == "ok", f"dryrun {arch} × {shape}: "
                  f"{rec.get('error')}")
            want = _rules_param_bytes(SH, configs, M, arch,
                                      rec["kind"] == "train")
            check(mem["argument_bytes_by_group"]["params"] == want,
                  f"dryrun {arch} × {shape}: parameter bytes "
                  f"{mem['argument_bytes_by_group']['params']}, the rules "
                  f"give {want}")
            check(0 < rec["model"]["useful_fraction"] <= 1.5,
                  f"dryrun {arch} × {shape}: useful fraction "
                  f"{rec['model']['useful_fraction']}")
            if (arch, shape) == ("jamba_v0_1_52b", "long_500k"):
                was = LONG_500K_PR20
                emit({"phase": "dryrun", "arch": arch, "shape": shape,
                      "pr20": was})
                check(all(rl["collectives"].get(kind, 0) <= n
                          for kind, n in was["collectives"].items())
                      and set(rl["collectives"]) <= set(was["collectives"])
                      and rec["kernel_calls"] == was["kernel_calls"]
                      and rl["traced_flops_per_device"]
                      == was["traced_flops_per_device"],
                      f"dryrun {arch} × {shape}: {rl['collectives']}, "
                      f"{rec['kernel_calls']}, "
                      f"{rl['traced_flops_per_device']} against PR 20's "
                      f"{was}")


def _breakdown(prof, wall: float, calls: int) -> dict:
    """Device seconds of a profiled window by kind: kernels K6 and K5 by
    name, the expert FFNs as ``aten::bmm`` and every other product as
    ``aten::mm`` (the device time of the kernels each launched), the
    rest by kernel; the idle share against the host wall; K5's kernel
    launches and the window's memsets, in all and per call."""
    from torch.autograd import DeviceType
    evs = prof.key_averages()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    t = lambda e: e.self_device_time_total  # noqa: E731
    busy = sum(map(t, dev)) / 1e6
    check(busy > 0, "serve_profile: no device time recorded")

    def kern(*subs):
        return sum(t(e) for e in dev if any(x in e.key for x in subs)) / 1e6

    ops = {e.key: e.device_time_total / 1e6 for e in evs
           if e.device_type == DeviceType.CPU}
    k5 = sum(e.count for e in dev if "moe_histogram" in e.key)
    memsets = sum(e.count for e in dev if "memset" in e.key.lower())
    return {"calls": calls, "wall_s": wall, "device_busy_s": busy,
            "k5_kernels": k5, "k5_kernels_per_call": k5 / calls,
            "memsets": memsets, "memsets_per_call": memsets / calls,
            "device_idle_share": 1.0 - busy / wall,
            "k6_s": kern("flash_mma", "flash_tile", "flash_decode",
                         "flash_merge"),
            "k5_s": kern("moe_histogram"),
            "expert_bmm_s": ops.get("aten::bmm", 0.0),
            "other_mm_s": ops.get("aten::mm", 0.0),
            "top_device_ops": [[e.key[:96], t(e) / 1e3, e.count] for e in
                               sorted(dev, key=t, reverse=True)[:10]]}


def _k5_alone(torch, MH, mh_calls) -> dict:
    """The device work of ten K5 calls alone at each recorded serve
    input, read from a CUDA graph that captured them: its nodes by type
    (kernel, memset, memcpy or another), and the wrapper's launch count
    over the capture.  Capture records every operation the calls put on
    their stream; ``torch.profiler`` windows around the same calls
    reported 7, 0 and 9 of the ten kernels."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}   # CUgraphNodeType
    out = {}
    for kind, ((idx, gates), kw) in mh_calls.items():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            MH.moe_histogram(idx, gates, **kw)    # this stream's scratch
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = MH.ops.launches
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(10):
                MH.moe_histogram(idx, gates, **kw)
        launched = MH.ops.launches - before
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
              "serve_profile: cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * count.value)()
        check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
              "serve_profile: cuGraphGetNodes failed")
        found: dict = {}
        for node in nodes:
            code = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(node, ctypes.byref(code)) == 0,
                  "serve_profile: cuGraphNodeGetType failed")
            name = kinds.get(code.value, f"type {code.value}")
            found[name] = found.get(name, 0) + 1
        out[kind] = {"nodes": found, "launches": launched}
        del graph
    return out


def phase_serve_profile(torch, M, MH, configs, serve: dict, device) -> dict:
    """Where the serve path's device time goes: the model of phase serve
    (qwen2-moe-a2.7b, full width and depth, replica 0's batch, prompt
    LM_PROMPT) rebuilt and run under ``torch.profiler`` — one prefill,
    then four decode calls after a warm one — as phase ``profile`` does
    for the main path.  The window must show one K5 kernel per MoE layer
    and call, and ten K5 calls alone at each of the serve path's recorded
    inputs, captured in a CUDA graph, exactly ten kernels and nothing
    else (no memset: the profiled window's own memsets are PyTorch's)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    check(not torch.backends.cuda.matmul.allow_tf32,
          "serve_profile: TF32 left on by an earlier phase")
    cfg = configs.get_config(LM_ARCH)
    batch, layers = serve["batch"], serve["layers"]
    params = M.init_params(cfg, 1, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (batch, LM_PROMPT),
                         generator=gen, device=device, dtype=torch.int32)
    out = {"phase": "serve_profile", "batch": batch,
           "prompt_len": LM_PROMPT}
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, _ = M.prefill(params, cfg, token_ids=toks,
                                     max_seq=LM_PROMPT + LM_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["prefill"] = _breakdown(prof, wall, 1)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    logits, cache, _ = M.decode_step(params, cfg, cache, tok)
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            logits, cache, _ = M.decode_step(params, cfg, cache, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["decode"] = _breakdown(prof, wall, 4)
    out["k5_alone"] = _k5_alone(torch, MH, serve["mh"])
    emit(out)
    for kind, calls in (("prefill", 1), ("decode", 4)):
        check(out[kind]["k5_kernels"] == layers * calls,
              f"serve_profile {kind}: {out[kind]['k5_kernels']} K5 kernels "
              f"for {calls} calls of {layers} MoE layers, one per layer and "
              f"call expected")
        alone = out["k5_alone"][kind]
        check(alone == {"nodes": {"kernel": 10}, "launches": 10},
              f"serve_profile: ten K5 calls at the {kind} input captured "
              f"{alone}, ten kernels and nothing else expected")
    del params, cache
    torch.cuda.empty_cache()
    return out


def bf16_step(x: float) -> float:
    """The spacing of bfloat16 numbers at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


class _Paths:
    """A model's kernel path and plain path on the same weights and
    tokens (phases serve_check and hybrid_check): :meth:`run` prefills
    the first CHECK_PROMPT tokens and decodes the next ``steps``
    (teacher-forced) through K5 and K6, or, given the plain ``attention``
    to swap in for K6, through K5's and K6's plain versions; it checks
    one K6 call per attention layer and one K5 launch per MoE layer and
    call on the kernel path, none on the plain path."""

    def __init__(self, torch, kern, FA, MH, L, MOE, M, phase: str):
        self.torch, self.kern, self.L, self.MOE, self.M = (torch, kern, L,
                                                           MOE, M)
        self.FA, self.phase = FA, phase
        self.histogram = (lambda idx, gates, *, num_experts:
                          MH.moe_histogram_ref(idx, gates, num_experts))

    def run(self, cfg, params, toks, steps, attention=None):
        L, MOE, M, kern = self.L, self.MOE, self.M, self.kern
        saved = L.flash_attention, MOE.moe_histogram
        if attention is not None:
            L.flash_attention, MOE.moe_histogram = attention, self.histogram
        try:
            reset_launches(kern)
            logits, cache, aux = M.prefill(
                params, cfg, token_ids=toks[:, :CHECK_PROMPT],
                max_seq=CHECK_PROMPT + steps)
            outs, counts = [logits], [aux["expert_counts"]]
            for t in range(steps):
                logits, cache, aux = M.decode_step(
                    params, cfg, cache,
                    toks[:, CHECK_PROMPT + t:CHECK_PROMPT + t + 1])
                outs.append(logits)
                counts.append(aux["expert_counts"])
            launches = read_launches(kern)
            fa_calls = launches["flash_attention"] - read_by_kernel(
                kern)["flash_attention"]["flash_merge"]
        finally:
            L.flash_attention, MOE.moe_histogram = saved
        calls = 0 if attention is not None else 1 + steps
        kinds = _kinds(M, cfg)
        want = (calls * kinds.get("moe", 0), calls * kinds.get("attn", 0))
        check((launches["moe_histogram"], fa_calls) == want,
              f"{self.phase}: launches {launches} on the "
              f"{'plain' if attention is not None else 'kernel'} path, "
              f"{want[0]} K5 and {want[1]} K6 calls expected")
        return outs, counts

    def compare(self, cfg, params, toks, steps):
        """The kernel path against the plain path: (the kernel path's
        logits per call, the plain path's, the numbers)."""
        torch = self.torch
        kern_out, kern_counts = self.run(cfg, params, toks, steps)
        plain_out, plain_counts = self.run(cfg, params, toks, steps,
                                           self.FA.attention_ref)
        check(all(bool(torch.isfinite(a).all()) for a in kern_out),
              f"{self.phase}: a logit is not finite")
        return kern_out, plain_out, {
            "batch": CHECK_BATCH, "prompt": CHECK_PROMPT,
            "decode_steps": steps,
            "max_abs_logit": max(float(p.float().abs().max())
                                 for p in plain_out),
            "max_abs_err_per_call": max_abs_errs(kern_out, plain_out),
            "expert_counts_equal": all(
                torch.equal(a, b) for a, b in zip(kern_counts, plain_counts))}


def max_abs_errs(a_outs, b_outs) -> list:
    return [float((a.float() - b.float()).abs().max())
            for a, b in zip(a_outs, b_outs)]


def phase_serve_check(torch, kern, FA, MH, L, MOE, M, configs,
                      device) -> dict:
    """qwen2-moe-a2.7b at full width, two layers, on the card.  The
    kernel path (K5 and K6 swapped in by ``models``: each launches twice
    per prefill or decode call, counted) against the plain path (their
    plain versions swapped in: no launch) on the same weights and tokens.
    (1) bfloat16, a prefill and three decode steps: within 4 bfloat16
    steps at the largest logit (K6 and its plain version each round an
    output once, so a hidden state may differ by a step here and there).
    (2) float32, a prefill and four decode steps: within 1e-4, the
    float32 parity tolerance of tests/test_torch_models.py, and the last
    decode step's logits against a full ``forward`` over the same tokens
    (KV-cache consistency) within the reference's 2e-2
    (tests/test_models.py); capacity factor raised to 15 so that no
    token is dropped (top-4 of 60 experts)."""
    import dataclasses
    full = configs.get_config(LM_ARCH)
    out = {"phase": "serve_check", "layers": 2, "d_model": full.d_model}
    paths = _Paths(torch, kern, FA, MH, L, MOE, M, "serve_check")
    gen = torch.Generator(device=device).manual_seed(5)
    toks = torch.randint(0, full.vocab_size, (CHECK_BATCH, CHECK_PROMPT + 4),
                         generator=gen, device=device, dtype=torch.int32)
    with tf32(torch, False):                  # float32 in float32
        cfg = dataclasses.replace(full, num_layers=2)
        params = M.init_params(cfg, 3, device=device)
        _, _, res = paths.compare(cfg, params, toks, 3)
        res["tol"] = 4 * bf16_step(res["max_abs_logit"])
        check(max(res["max_abs_err_per_call"]) <= res["tol"],
              f"serve_check: kernel path vs plain path "
              f"{max(res['max_abs_err_per_call'])} above {res['tol']} "
              f"(bf16)")
        out["bf16"] = res
        del params
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(
            full, num_layers=2, dtype="float32",
            moe=dataclasses.replace(full.moe, capacity_factor=15.0))
        params = M.init_params(cfg, 4, device=device)
        kern_out, _, res = paths.compare(cfg, params, toks, 4)
        res["tol"] = 1e-4
        check(max(res["max_abs_err_per_call"]) <= res["tol"],
              f"serve_check: kernel path vs plain path "
              f"{max(res['max_abs_err_per_call'])} above 1e-4 (float32)")
        fwd, _ = M.forward(params, cfg, token_ids=toks)
        err = float((kern_out[-1][:, 0] - fwd[:, -1]).abs().max())
        check(err < 2e-2, f"serve_check: decode vs forward {err} (float32)")
        out["float32"] = {**res, "decode_vs_forward_max_abs_err": err,
                          "decode_vs_forward_tol": 2e-2,
                          "capacity_factor": 15.0}
    emit(out)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the recurrent families (PERF.md §4): jamba-v0.1-52b (one full-width
# period: attention on K6, four MoE layers on K5, seven Mamba scans) and
# xlstm-1.3b (full width and depth: sLSTM and mLSTM scans, no kernel)
# ---------------------------------------------------------------------------

def _hybrid_config(configs, **over):
    """jamba-v0.1-52b at full width, its depth cut to HYBRID_LAYERS."""
    import dataclasses
    return dataclasses.replace(configs.get_config(HYBRID_ARCH),
                               num_layers=HYBRID_LAYERS, **over)


def _kinds(M, cfg) -> dict:
    """Layers per mixer and per feed-forward of ``cfg``."""
    out: dict = {}
    for mixer, ffn, _ in M.layer_kinds(cfg):
        out[mixer] = out.get(mixer, 0) + 1
        out[ffn or "none"] = out.get(ffn or "none", 0) + 1
    return out


@contextlib.contextmanager
def _ranges(mods):
    """Mark each call of a scan (the scan ops' wrappers as the mixer
    modules call them), of attention and of the MoE feed-forward with a
    ``torch.profiler`` range of that name, for :func:`_split`."""
    from torch.profiler import record_function
    saved = []

    def marked(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    for mod, attr, name in mods:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, marked(name, getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


RANGES = ("scan", "attention", "moe")


def _split(prof, wall: float) -> dict:
    """One profiled call's time, read from the profiler's raw events
    (``key_averages`` takes minutes over a prefill's million events):
    the card's busy seconds (kernels, copies and sets; the ranges' own
    device rows left out) and idle share; per range of :func:`_ranges`
    its host seconds and the device seconds of the work launched inside
    it (a device event belongs to the range whose span holds the host
    call that launched it, matched by correlation id); K6's and K5's
    kernels by name; the products as the work launched inside
    ``aten::mm`` (every projection) and ``aten::bmm`` (the expert FFNs
    and the scans' einsums)."""
    import bisect

    from torch.autograd import DeviceType
    spans = {name: [] for name in RANGES + ("aten::mm", "aten::bmm")}
    launched_at, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", lambda: False)():
                dev.append(e)
        elif e.name() in spans:
            spans[e.name()].append((e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):       # the CUDA API calls
            launched_at[e.correlation_id()] = e.start_ns()
    ns = lambda e: e.duration_ns()  # noqa: E731
    busy = sum(map(ns, dev)) / 1e9
    check(busy > 0, "recurrent profile: no device time recorded")
    matched = [(launched_at.get(e.correlation_id()), ns(e)) for e in dev]

    def inside(name):
        iv = sorted(spans[name])
        starts = [a for a, _ in iv]
        total = 0
        for t, d in matched:
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= iv[i][1]:
                total += d
        return total / 1e9

    def kern(*subs):
        return sum(ns(e) for e in dev
                   if any(x in e.name() for x in subs)) / 1e9

    out = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "device_events": len(dev),
           "device_events_matched": sum(t is not None for t, _ in matched),
           "k6_s": kern("flash_mma", "flash_tile", "flash_decode",
                        "flash_merge"),
           "k5_s": kern("moe_histogram"),
           "mm_s": inside("aten::mm"), "bmm_s": inside("aten::bmm")}
    for name in RANGES:
        out[f"{name}_device_s"] = inside(name)
        out[f"{name}_host_s"] = sum(b - a for a, b in spans[name]) / 1e9
        out[f"{name}_calls"] = len(spans[name])
    out["scan_device_share"] = out["scan_device_s"] / max(busy, 1e-30)
    out["scan_host_share"] = out["scan_host_s"] / wall
    by_name: dict = {}
    for e in dev:
        by_name[e.name()[:80]] = by_name.get(e.name()[:80], 0) + ns(e)
    out["top_device_ops"] = sorted(([k, v / 1e9] for k, v in
                                    by_name.items()),
                                   key=lambda kv: -kv[1])[:8]
    return out


def _profile_calls(torch, M, mods, cfg, batch: int, prompt: int,
                   max_seq: int, device) -> dict:
    """:func:`_split` of one prefill of ``batch`` × ``prompt`` random
    tokens and of one decode call after a warm one, on ``cfg`` with
    weights from seed 1 (TF32 off); ``seconds``: the whole of it, the
    profiler's own processing included."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    start = time.perf_counter()
    params = M.init_params(cfg, 1, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=device, dtype=torch.int32)
    out = {}
    with tf32(torch, False), _ranges(mods):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache, _ = M.prefill(params, cfg, token_ids=toks,
                                         max_seq=max_seq)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = _split(prof, wall)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, cache, _ = M.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.decode_step(params, cfg, cache, tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["decode"] = _split(prof, wall)
    out["seconds"] = time.perf_counter() - start
    del params, cache
    return out


def _serve_numbers(out: dict, peak: int, prompt: int) -> dict:
    """The end-to-end numbers of a ``serve_config`` run."""
    return {"model": out["model"], "layers": out["layers"],
            "d_model": out["d_model"], "sessions": out["sessions"],
            "replicas": out["replicas"],
            "initial_spread": out["initial_spread"], "batch": out["batch"],
            "prompt_len": prompt, "steps": out["steps"],
            "max_seq": out["max_seq"], "init_s": out["init_s"],
            "prefill_s": out["prefill_s"],
            "prefill_tokens_per_s": out["batch"] * prompt / out["prefill_s"],
            "decode_s": out["decode_s"], "decode_calls": out["decode_calls"],
            "decode_ms_per_call": out["decode_s"] / out["decode_calls"] * 1e3,
            "decode_tok_per_s": out["decode_tok_per_s"],
            "max_memory_allocated": peak,
            "replica_load_cv": out["replica_load_cv"],
            "rebalances": out["rebalances"],
            "logits_finite": out["logits_finite"]}


def phase_serve_hybrid(torch, kern, LS, L, MOE, M, MO, mods, configs,
                       device) -> dict:
    """``launch.serve.serve_config`` on jamba-v0.1-52b at full width
    (d_model 4096, 32/8 heads, 16 experts top-2, Mamba d_state 16),
    depth cut to one period of HYBRID_LAYERS (attention, 7 Mamba, 4 MoE
    and 4 MLP layers), with phase serve's traffic: LM_SESSIONS sessions
    over LM_REPLICAS replicas, replica 0's batch prefilled at LM_PROMPT
    tokens and decoded for LM_STEPS.  K6 must launch once per call (its
    prefill kernel at the prefill, its decode kernel, and the merge if
    the keys are chunked, at each decode call) and K5 once per MoE layer
    and call; the kernels' last prefill and decode inputs are held
    against their plain versions there; then the profile split of one
    prefill and one decode call (:func:`_profile_calls`)."""
    cfg = _hybrid_config(configs)
    kinds = _kinds(M, cfg)
    check(cfg.d_model == 4096 and cfg.moe.num_experts == 16
          and kinds == {"attn": 1, "mamba": 7, "moe": 4, "mlp": 4},
          f"serve_hybrid: not one full-width jamba period ({kinds})")
    n_params = cfg.param_count()
    fa = _Recorder(L.flash_attention,
                   lambda q, *a, **kw: "decode" if q.shape[2] == 1
                   else "prefill")
    mh = _Recorder(MOE.moe_histogram, lambda idx, *a, **kw:
                   "prefill" if idx.shape[0] > HYBRID_BATCH else "decode")
    logs = []
    _free_card(torch)
    L.flash_attention, MOE.moe_histogram = fa, mh
    try:
        with tf32(torch, False):              # the router's float32 product
            reset_launches(kern)              # counts from here …
            out = LS.serve_config(cfg, sessions=LM_SESSIONS,
                                  prompt_len=LM_PROMPT, steps=LM_STEPS,
                                  replicas=LM_REPLICAS, device=device,
                                  log=logs.append)
            launches = read_launches(kern)    # … to here
            by_kernel = read_by_kernel(kern)
    finally:
        L.flash_attention, MOE.moe_histogram = fa.fn, mh.fn
    peak = torch.cuda.max_memory_allocated()
    calls = 1 + out["decode_calls"]
    FA, MH = kern["flash_attention"], kern["moe_histogram"]
    (q, k, _), fkw = fa.calls["decode"]
    merge = int(FA.ops.decode_chunks(FA.ops.build(), q, k, **fkw) > 1)
    decodes = kinds["attn"] * (calls - 1)
    check(launches["moe_histogram"] == kinds["moe"] * calls
          and by_kernel["flash_attention"] == {
              "flash_decode": decodes, "flash_merge": merge * decodes,
              "flash_tile": 0, "flash_mma": kinds["attn"]}
          and launches["flash_attention"]
          == kinds["attn"] + (1 + merge) * decodes,
          f"serve_hybrid: launches {launches} ({by_kernel}), "
          f"{kinds['moe']} K5 and {kinds['attn']} K6 calls per call "
          f"expected over {calls} calls")
    check(all(launches[n] == 0 for n in ("stats_update", "spatial_match",
                                         "keyword_match", "knn_match")),
          f"serve_hybrid: launches {launches}")
    check(out["logits_finite"], "serve_hybrid: a logit is not finite")
    check(out["batch"] == HYBRID_BATCH
          and out["tokens"].shape == (HYBRID_BATCH, LM_STEPS),
          f"serve_hybrid: batch {out['batch']}, {HYBRID_BATCH} expected")
    counts = out["expert_counts"]
    top = cfg.moe.top_k * kinds["moe"]
    check(counts[0].sum() == HYBRID_BATCH * LM_PROMPT * top
          and (counts[1:].sum(1) == HYBRID_BATCH * top).all(),
          "serve_hybrid: expert counts do not add up to the assignments")
    # K5 and K6 at the path's own last prefill and decode inputs, against
    # their plain versions; phases k5 and k6 time them at these shapes
    at_path = {}
    for call in ("prefill", "decode"):
        (idx, gates), kw = mh.calls[call]
        (q, k, v), fkw = fa.calls[call]
        case = next(c for c in K6_CASES if c[0] == f"jamba {call}")
        check(list(q.shape) == [case[1], case[2], case[4], case[6]]
              and list(k.shape) == [case[1], case[3], case[5], case[6]]
              and fkw["q_offset"] == case[9]
              and (idx.shape[0], idx.shape[1], kw["num_experts"])
              in K5_SHAPES,
              f"serve_hybrid: the {call} inputs {tuple(q.shape)} "
              f"{tuple(k.shape)} {fkw} {tuple(idx.shape)} are not phase "
              f"k5's and k6's jamba cases")
        at_path[call] = {
            "moe_histogram": {"shape": list(idx.shape),
                              **k5_row(torch, MH, MO, idx, gates,
                                       kw["num_experts"])},
            "flash_attention": {"q": list(q.shape), "kv": list(k.shape),
                                **fkw, **k6_row(torch, FA, q, k, v, **fkw,
                                                timed=False)}}
    del fa, mh, out["tokens"]
    res = {"phase": "serve_hybrid", "arch": HYBRID_ARCH,
           "cut": {"num_layers": [configs.get_config(HYBRID_ARCH).num_layers,
                                  HYBRID_LAYERS],
                   "why": "51.6 B parameters (~103 GB in bf16) do not fit "
                          "the 80 GB card; one whole period kept"},
           "params": n_params, "layers_by_kind": kinds,
           **_serve_numbers(out, peak, LM_PROMPT),
           "launches": launches, "launches_by_kernel": by_kernel,
           "k5_per_call": launches["moe_histogram"] / calls,
           "k6_calls_per_call": (launches["flash_attention"]
                                 - by_kernel["flash_attention"]["flash_merge"])
           / calls,
           "ep_moves": out["ep_moves"], "ep_imbalance": out["ep_imbalance"],
           "kernels_at_path_inputs": at_path,
           "pr20_run_z": PR20_RUN_Z["serve_hybrid"], "log": logs}
    _free_card(torch)
    res["profile"] = _profile_calls(torch, M, mods, cfg, HYBRID_BATCH,
                                    LM_PROMPT, LM_PROMPT + LM_STEPS, device)
    emit(res)
    _free_card(torch)
    return {"launches": launches, "by_kernel": by_kernel}


def phase_serve_ssm(torch, kern, LS, M, mods, configs, device) -> dict:
    """``launch.serve.serve_config`` on xlstm-1.3b at full width and
    depth (48 layers: 6 sLSTM, 42 mLSTM; d_model 2048, 4 heads, no FFN):
    SSM_SESSIONS sessions over LM_REPLICAS replicas, replica 0's batch
    prefilled at SSM_PROMPT tokens and decoded for SSM_DECODE_CALLS
    calls.  No kernel of the port runs (its mixers are scans, and it has
    no attention and no MoE); then the profile split of one prefill and
    one decode call."""
    cfg = configs.get_config(SSM_ARCH)
    kinds = _kinds(M, cfg)
    check(cfg.d_model == 2048 and kinds == {"slstm": 6, "mlstm": 42,
                                            "none": 48},
          f"serve_ssm: not xlstm-1.3b at full width and depth ({kinds})")
    logs = []
    _free_card(torch)
    with tf32(torch, False):
        reset_launches(kern)                  # counts from here …
        out = LS.serve_config(cfg, sessions=SSM_SESSIONS,
                              prompt_len=SSM_PROMPT,
                              steps=SSM_DECODE_CALLS + 1,
                              replicas=LM_REPLICAS, device=device,
                              log=logs.append)
        launches = read_launches(kern)        # … to here
    peak = torch.cuda.max_memory_allocated()
    check(all(n == 0 for n in launches.values()),
          f"serve_ssm: a kernel launched ({launches})")
    check(out["logits_finite"], "serve_ssm: a logit is not finite")
    check(out["tokens"].shape == (out["batch"], SSM_DECODE_CALLS + 1),
          "serve_ssm: token shape")
    res = {"phase": "serve_ssm", "arch": SSM_ARCH, "cut": None,
           "params": cfg.param_count(), "layers_by_kind": kinds,
           **_serve_numbers(out, peak, SSM_PROMPT), "launches": launches,
           "pr20_run_z": PR20_RUN_Z["serve_ssm"], "log": logs}
    _free_card(torch)
    res["profile"] = _profile_calls(torch, M, mods, cfg, out["batch"],
                                    SSM_PROMPT,
                                    SSM_PROMPT + SSM_DECODE_CALLS + 1, device)
    emit(res)
    _free_card(torch)
    return res


# the recurrent families' bfloat16 bound, in bfloat16 steps at the largest
# logit: 16, not serve_check's 4.  One bf16 step of K6's output (it and
# its plain version each round once) reaches the logits through seven
# Mamba scans and four MoE routers, which carry it further than phase
# serve_check's attention layers do; tests/test_torch_models.py holds
# xlstm's bf16 logits to the JAX package's at the same 16 steps
# (XLSTM_BF16_TOL).  Phase hybrid_check measures that reach on the plain
# path itself: one element of its prefill attention output moved by one
# bf16 step (``plain_vs_nudged_max_abs_err``)
RECURRENT_BF16_STEPS = 16


def phase_hybrid_check(torch, kern, FA, MH, L, MOE, M, configs,
                       device) -> dict:
    """jamba at full width, one period, on the card, B = CHECK_BATCH:
    (1) bfloat16, the kernel path (K5 and K6) against the plain path
    (``moe_histogram_ref`` / ``attention_ref`` swapped in) on the same
    weights and tokens, a prefill and three decode steps, within
    RECURRENT_BF16_STEPS bfloat16 steps at the largest logit, beside the
    plain path against itself with one element of its prefill attention
    output moved by one bf16 step; (2) float32 with the capacity factor
    at 16 (no token dropped, top-2 of 16), within 1e-4, expert counts
    equal, and the last decode step against a full ``forward`` within
    2e-2.  Then xlstm-1.3b at full width cut to one period
    (SSM_CHECK_LAYERS), float32: a prefill of SSM_CHECK_PROMPT tokens
    and SSM_CHECK_STEPS decode steps on the card against the same on
    the CPU, logits and every cache tensor within 1e-4."""
    import dataclasses
    out = {"phase": "hybrid_check", "layers": HYBRID_LAYERS}
    paths = _Paths(torch, kern, FA, MH, L, MOE, M, "hybrid_check")

    def nudged_ref(q, k, v, **kw):
        """The plain attention, one element of a prefill output moved up
        by one step of its type."""
        o = FA.attention_ref(q, k, v, **kw)
        if q.shape[2] > 1:
            flat = o.view(-1)
            flat[0] = flat[0] + bf16_step(abs(float(flat[0])))
        return o

    full = configs.get_config(HYBRID_ARCH)
    gen = torch.Generator(device=device).manual_seed(5)
    toks = torch.randint(0, full.vocab_size, (CHECK_BATCH, CHECK_PROMPT + 4),
                         generator=gen, device=device, dtype=torch.int32)
    _free_card(torch)
    with tf32(torch, False):
        cfg = _hybrid_config(configs)
        params = M.init_params(cfg, 3, device=device)
        _, plain_out, res = paths.compare(cfg, params, toks, 3)
        nudged, _ = paths.run(cfg, params, toks, 3, nudged_ref)
        res["plain_vs_nudged_max_abs_err_per_call"] = max_abs_errs(
            nudged, plain_out)
        res["tol"] = RECURRENT_BF16_STEPS * bf16_step(res["max_abs_logit"])
        res["tol_bf16_steps"] = RECURRENT_BF16_STEPS
        check(max(res["max_abs_err_per_call"]) <= res["tol"],
              f"hybrid_check: kernel path vs plain path "
              f"{max(res['max_abs_err_per_call'])} above {res['tol']} "
              f"(bf16)")
        out["bf16"] = res
        del params, plain_out, nudged
        _free_card(torch)

        cfg = _hybrid_config(configs, dtype="float32", moe=dataclasses.replace(
            full.moe, capacity_factor=16.0))
        params = M.init_params(cfg, 4, device=device)
        kern_out, _, res = paths.compare(cfg, params, toks, 4)
        res["tol"] = 1e-4
        check(max(res["max_abs_err_per_call"]) <= res["tol"]
              and res["expert_counts_equal"],
              f"hybrid_check: kernel path vs plain path "
              f"{max(res['max_abs_err_per_call'])} above 1e-4 or expert "
              f"counts differ (float32)")
        fwd, _ = M.forward(params, cfg, token_ids=toks)
        err = float((kern_out[-1][:, 0] - fwd[:, -1]).abs().max())
        check(err < 2e-2, f"hybrid_check: decode vs forward {err} "
              f"(float32)")
        out["float32"] = {**res, "decode_vs_forward_max_abs_err": err,
                          "decode_vs_forward_tol": 2e-2,
                          "capacity_factor": 16.0,
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        del params, fwd, kern_out
        _free_card(torch)
        out["ssm_float32"] = _ssm_card_vs_cpu(torch, M, configs, device)
    emit(out)
    _free_card(torch)
    return out


def _ssm_card_vs_cpu(torch, M, configs, device) -> dict:
    """xlstm-1.3b at full width, SSM_CHECK_LAYERS layers, float32: the
    same weights (made on the CPU, copied) and tokens through a prefill
    and SSM_CHECK_STEPS decode steps on the card and on the CPU; logits
    and every cache tensor within 1e-4."""
    import dataclasses

    from repro_torch import tree as TR
    cfg = dataclasses.replace(configs.get_config(SSM_ARCH),
                              num_layers=SSM_CHECK_LAYERS, dtype="float32")
    cpu = M.init_params(cfg, 2, device="cpu")
    card = TR.map(lambda t: t.to(device), cpu)
    gen = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size,
                         (SSM_CHECK_BATCH, SSM_CHECK_PROMPT + SSM_CHECK_STEPS),
                         generator=gen, dtype=torch.int32)
    runs = []
    for params, dev in ((cpu, "cpu"), (card, device)):
        t0 = time.perf_counter()
        logits, cache, _ = M.prefill(
            params, cfg, token_ids=toks[:, :SSM_CHECK_PROMPT].to(dev),
            max_seq=SSM_CHECK_PROMPT + SSM_CHECK_STEPS)
        outs = [logits]
        for t in range(SSM_CHECK_STEPS):
            i = SSM_CHECK_PROMPT + t
            logits, cache, _ = M.decode_step(params, cfg, cache,
                                             toks[:, i:i + 1].to(dev))
            outs.append(logits)
        runs.append((outs, cache, time.perf_counter() - t0))
    (c_out, c_cache, c_s), (g_out, g_cache, g_s) = runs
    errs = [float((a - b.cpu()).abs().max()) for a, b in zip(c_out, g_out)]
    state_errs = {name: float((c_cache[name] - g_cache[name].cpu())
                              .abs().max())
                  for name in c_cache if name != "offset"}
    check(all(bool(torch.isfinite(o).all()) for o in g_out),
          "hybrid_check: an xlstm logit on the card is not finite")
    check(max(errs) <= 1e-4 and max(state_errs.values()) <= 1e-4,
          f"hybrid_check: xlstm card vs CPU {errs} {state_errs} above 1e-4")
    return {"layers": SSM_CHECK_LAYERS, "d_model": cfg.d_model,
            "batch": SSM_CHECK_BATCH, "prompt": SSM_CHECK_PROMPT,
            "decode_steps": SSM_CHECK_STEPS, "tol": 1e-4,
            "max_abs_logit": max(float(o.abs().max()) for o in c_out),
            "max_abs_err_per_call": errs, "state_max_abs_err": state_errs,
            "cpu_s": c_s, "card_s": g_s}


# ---------------------------------------------------------------------------
# training (PERF.md §4): internlm2-1.8b at full width and depth through the
# launcher's Trainer; a 2-layer float32 step against the CPU; qwen2-moe at
# full width, depth cut, through K5
# ---------------------------------------------------------------------------

def _free_card(torch) -> int:
    """Drop what earlier phases left (collected cycles, cached blocks)
    and restart the peak; returns the bytes still allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _quiet_data(run) -> None:
    """Wait until the trainer's prefetch thread has filled its queue and
    blocks, so that its NumPy loop no longer competes with the steps for
    the interpreter."""
    while not run.data.q.full():
        time.sleep(0.05)


def _tree_leaves(tree) -> list:
    from repro_torch import tree as TR
    return TR.leaves(tree)


def _k6_split(kern) -> dict:
    return read_by_kernel(kern)["flash_attention"]


def _profile_steps(torch, run, batches) -> dict:
    """Device busy seconds against the host wall over ``batches`` train
    steps under ``torch.profiler``, device seconds by kind (K6, K5,
    float32 and bf16 products, copies, elementwise, reductions), the
    device events counted (``kernel_launches``, memcpys included), the
    host's self seconds by op, and the steps' losses."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = [float(run.step(b)["loss"]) for b in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    t = lambda e: e.self_device_time_total / 1e6  # noqa: E731
    busy = sum(map(t, dev))
    check(busy > 0, "train: no device time recorded under the profiler")

    # device seconds by kind, each kernel in the first kind it matches
    kinds = (("k6_s", ("flash_mma", "flash_tile")),
             ("k5_s", ("moe_histogram",)),
             ("f32_gemm_s", ("sgemm", "f32f32")),     # the attention twin
             ("gemm_s", ("nvjet", "gemm", "Gemm")),   # bf16 products
             ("copy_s", ("copy", "Memcpy")),          # casts, copies
             ("elementwise_s", ("elementwise",)),
             ("reduce_s", ("reduce", "softmax", "Softmax")))
    by_kind = dict.fromkeys([k for k, _ in kinds] + ["other_s"], 0.0)
    for e in dev:
        kind = next((k for k, subs in kinds
                     if any(x in e.key for x in subs)), "other_s")
        by_kind[kind] += t(e)
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU]
    h = lambda e: e.self_cpu_time_total / 1e6  # noqa: E731
    return {"steps": len(batches), "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, **by_kind,
            "kernel_launches": sum(e.count for e in dev),
            "top_device_ops": [[e.key[:96], t(e), e.count] for e in
                               sorted(dev, key=t, reverse=True)[:12]],
            "host_self_s": sum(map(h, host)),
            "top_host_ops": [[e.key[:64], h(e), e.count] for e in
                             sorted(host, key=h, reverse=True)[:12]],
            "losses": losses}


def phase_train(torch, kern, LT, M, configs, device) -> dict:
    """The training path at full width and depth (PERF.md §4):
    internlm2-1.8b (24 layers, d_model 2048, 16/8 heads, d_ff 8192,
    vocab 92 544) through ``launch.train.Trainer`` with float32 masters
    and AdamW state, bfloat16 compute, batch TRAIN_BATCH × TRAIN_SEQ,
    remat ``dots_no_batch``.  The phase's batches are drawn from the
    trainer's stream first (their host seconds reported); then
    TRAIN_STEPS steps (the counts read over them), an F6 guard (every
    layer's attention weights get a finite, non-zero gradient; K6's
    launches split into the forward and the backward's recompute), a
    checkpoint, two more steps under
    ``torch.profiler`` (the card's busy share), a restore (bit-identical
    to what was saved, ``count`` equal to the step) and the same two
    steps again (losses against the continuous run's within 1e-3
    relative); last, LAUNCHER_STEPS steps as the launcher's loop runs
    them, each drawing its batch from the stream.  MFU: ``launch.analytic``'s FLOPs at this shape and remat
    over the median step time and BF16_OPS_PER_S."""
    import shutil
    from repro_torch.launch.analytic import analytic_cost
    cfg = configs.get_config(TRAIN_ARCH)
    check(cfg.num_layers == 24 and cfg.d_model == 2048
          and cfg.vocab_size == 92544,
          "train: not internlm2-1.8b at full width and depth")
    at_start = _free_card(torch)
    t0 = time.perf_counter()
    run = LT.Trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=TRAIN_STEPS + TRAIN_RESUME, lr=TRAIN_LR,
                     remat=TRAIN_REMAT, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _tree_leaves(run.params))
    check(all(p.dtype == torch.float32 for p in _tree_leaves(run.params)),
          "train: the masters are not float32")
    # every batch of the phase first (the synthetic stream makes one in
    # about 1.9 s of host NumPy, slower than a step), then the steps with
    # the producer thread idle
    data_s, batches = [], []
    for _ in range(TRAIN_STEPS + 1 + TRAIN_RESUME):
        t0 = time.perf_counter()
        batches.append(run.next_batch())
        data_s.append(time.perf_counter() - t0)
    _quiet_data(run)
    step_s, losses, per_step = [], [], []
    reset_launches(kern)                      # counts from here …
    for batch in batches[:TRAIN_STEPS]:
        before = _k6_split(kern)["flash_mma"]
        t0 = time.perf_counter()
        m = run.step(batch)
        losses.append(float(m["loss"]))       # drains the card
        step_s.append(time.perf_counter() - t0)
        per_step.append(_k6_split(kern)["flash_mma"] - before)
    launches = read_launches(kern)            # … to here
    by_kernel = read_by_kernel(kern)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    check(launches["flash_attention"] == 2 * layers * TRAIN_STEPS
          and by_kernel["flash_attention"]["flash_mma"]
          == 2 * layers * TRAIN_STEPS and launches["moe_histogram"] == 0,
          f"train: launches {launches} ({by_kernel}); {2 * layers} "
          f"flash_mma a step expected (forward and recompute)")
    check(all(launches[n] == 0 for n in ("stats_update", "spatial_match",
                                         "keyword_match", "knn_match")),
          f"train: launches {launches}")

    # F6's guard: the step's loss and gradient, forward and backward apart
    batch = batches[TRAIN_STEPS]
    leaves = _tree_leaves(run.params)
    for p in leaves:
        p.requires_grad_(True)
    reset_launches(kern)
    loss, _ = M.loss_fn(run.params, cfg, batch, remat=TRAIN_REMAT)
    fwd = _k6_split(kern)
    grads = torch.autograd.grad(loss, leaves)
    recompute = {k: v - fwd[k] for k, v in _k6_split(kern).items()}
    for p in leaves:
        p.requires_grad_(False)
    from repro_torch import tree as TR
    grads = TR.unflatten(run.params, grads)
    attn = {w: [float(g["attn"][w].float().abs().max())
                for g in grads["layers"]] for w in ("wq", "wk", "wv", "wo")}
    finite = all(bool(torch.isfinite(g["attn"][w]).all())
                 for g in grads["layers"] for w in attn)
    check(finite and all(x > 0 for xs in attn.values() for x in xs),
          f"train: an attention weight's gradient is zero or not finite "
          f"(F6): {attn}")
    check(fwd["flash_mma"] == layers and recompute["flash_mma"] == layers,
          f"train: K6 launched {fwd} forward and {recompute} in the "
          f"backward, {layers} flash_mma each expected")
    del grads, loss
    torch.cuda.empty_cache()

    # checkpoint, two steps on, restore, the same two steps again
    batches = batches[TRAIN_STEPS + 1:]
    ckpt = os.path.join(ROOT, CKPT_DIR)
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        saved = [t.detach().to("cpu", copy=True)
                 for t in _tree_leaves((run.params, run.opt))]
        t0 = time.perf_counter()
        run.save(ckpt, TRAIN_STEPS)
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(
            ckpt, f"step_{TRAIN_STEPS:08d}", "arrays.npz"))
        prof = _profile_steps(torch, run, batches)
        continuous = prof.pop("losses")
        t0 = time.perf_counter()
        step = run.restore(ckpt, TRAIN_STEPS)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = _tree_leaves((run.params, run.opt))
        identical = len(restored) == len(saved) and all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b)
            for a, b in zip(restored, saved))
        del saved, restored
        check(step == TRAIN_STEPS and identical
              and int(run.opt["count"]) == TRAIN_STEPS,
              f"train: the restored state differs from the saved one "
              f"(step {step}, count {int(run.opt['count'])})")
        resumed, resumed_s = [], []
        for b in batches:
            t0 = time.perf_counter()
            resumed.append(float(run.step(b)["loss"]))
            resumed_s.append(time.perf_counter() - t0)
        # the launcher's own loop: each step draws the stream's next
        # batch while the producer thread makes the one after
        launcher_s = []
        for _ in range(LAUNCHER_STEPS):
            t0 = time.perf_counter()
            float(run.step()["loss"])
            launcher_s.append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        run.close()
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, continuous)]
    check(max(rel) <= 1e-3, f"train: resumed losses {resumed} against the "
          f"continuous run's {continuous}")
    del run, batches, batch
    torch.cuda.empty_cache()

    med = statistics.median(step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    cost = analytic_cost(cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
                         remat=TRAIN_REMAT)
    out = {"phase": "train", "arch": TRAIN_ARCH, "model": cfg.name,
           "layers": layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": n_params,
           "allocated_at_start": at_start,
           "masters": "float32", "compute": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": TRAIN_REMAT,
           "steps": TRAIN_STEPS, "init_s": init_s, "step_s": step_s,
           "step_s_median": med, "tokens_per_s": tokens / med,
           "data_s": data_s,
           "analytic_flops": cost["flops"],
           "remat_factor": cost["remat_factor"],
           "mfu": cost["flops"] / med / BF16_OPS_PER_S,
           "max_memory_allocated": peak, "losses": losses,
           "launches": launches, "launches_by_kernel": by_kernel,
           "k6_flash_mma_per_step": per_step,
           "k6_forward": fwd, "k6_recompute": recompute,
           "attn_grad_max_abs": {w: [min(x), max(x)]
                                 for w, x in attn.items()},
           "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
           "restore_s": restore_s, "restored_bit_identical": identical,
           "continuous_losses": continuous, "resumed_losses": resumed,
           "resumed_step_s": resumed_s, "launcher_step_s": launcher_s,
           # past the two batches the prefetch queue held
           "launcher_tokens_per_s": tokens / statistics.median(
               launcher_s[2:]),
           "resume_rel_diff": rel,
           "resume_bit_identical": resumed == continuous,
           "profile": prof}
    emit(out)
    return out


def phase_train_check(torch, kern, FA, L, M, T, configs, device) -> dict:
    """internlm2-1.8b at full width cut to TRAIN_CHECK_LAYERS layers,
    float32: one train step on the card against the same step on the CPU
    from the same params and batch (loss within 1e-4, grad norm within
    1e-3 relative); then, at one full-width layer's shape (TRAIN_BATCH,
    16 heads, TRAIN_SEQ, 128; 8 kv heads), bfloat16, causal: K6's
    forward through ``FlashAttentionFn`` (grad enabled, one flash_mma)
    against ``attention_ref`` at K6's tolerance (:func:`k6_check`), and
    the backward's recompute (``layers.sdpa_grad``) — dq, dk, dv —
    against autograd through ``layers._sdpa_chunked`` on the card
    (within 4 bf16 steps at the largest |gradient|; the backward reads
    no kernel output, so this holds the recompute, not the kernel),
    timed beside SDPA's forward and backward."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.data import make_batch_iterator
    full = configs.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_CHECK_LAYERS,
                              dtype="float32")
    out = {"phase": "train_check", "arch": TRAIN_ARCH,
           "layers": TRAIN_CHECK_LAYERS, "d_model": cfg.d_model,
           "cut": f"depth 24 -> {TRAIN_CHECK_LAYERS}, float32",
           "batch": TRAIN_CHECK_BATCH, "seq": TRAIN_CHECK_SEQ}
    cpu = M.init_params(cfg, 1, device="cpu", dtype=torch.float32)
    b = next(make_batch_iterator(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                                 seed=2))
    step = T.make_train_step(cfg, T.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=4))
    res = {}
    with tf32(torch, False):
        for dev in ("cpu", device):     # the step updates its copy in place
            params = _tree_to(cpu, dev)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            reset_launches(kern)
            _, _, m = step(params, T.init_opt_state(params), batch)
            res[str(dev)] = {"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "k6": _k6_split(kern)}
            del params, batch, m
    c, g = res["cpu"], res[str(device)]
    loss_err = abs(c["loss"] - g["loss"])
    gn_rel = abs(c["grad_norm"] - g["grad_norm"]) / c["grad_norm"]
    check(loss_err <= 1e-4 and gn_rel <= 1e-3,
          f"train_check: card {g} against cpu {c}")
    check(g["k6"]["flash_tile"] == 2 * TRAIN_CHECK_LAYERS
          and c["k6"]["flash_tile"] == 0,
          f"train_check: K6 launches {g['k6']}")
    out.update(cpu=c, card=g, loss_abs_err=loss_err, loss_tol=1e-4,
               grad_norm_rel_err=gn_rel, grad_norm_tol=1e-3)
    del cpu
    torch.cuda.empty_cache()

    # K6's backward at one full-width layer's shape
    h, hkv, d = full.num_heads, full.num_kv_heads, full.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v, go = (torch.randn(shape, generator=gen, device=device
                               ).to(torch.bfloat16)
                   for shape in ((TRAIN_BATCH, h, TRAIN_SEQ, d),
                                 (TRAIN_BATCH, hkv, TRAIN_SEQ, d),
                                 (TRAIN_BATCH, hkv, TRAIN_SEQ, d),
                                 (TRAIN_BATCH, h, TRAIN_SEQ, d)))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))

    def k6_fwd_bwd():
        o = FA.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o, (q, k, v), go)

    def twin_fwd_bwd():
        o = L._sdpa_chunked(*(t.transpose(1, 2) for t in (q, k, v)),
                            causal=True, window=None, q_offset=0)
        return torch.autograd.grad(o.transpose(1, 2), (q, k, v), go)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (q, k, v), go)

    # the forward a train step takes (through FlashAttentionFn, grad
    # enabled) against the plain version, at K6's bf16 tolerance
    reset_launches(kern)
    with tf32(torch, False):
        o = FA.flash_attention(q, k, v, causal=True)
        fwd_launches = _k6_split(kern)
        check(o.requires_grad and fwd_launches["flash_mma"] == 1
              and sum(fwd_launches.values()) == 1,
              f"train_check: the forward launched {fwd_launches}, one "
              f"flash_mma through FlashAttentionFn expected")
        forward = k6_check(torch, o.detach(),
                           FA.attention_ref(q.detach(), k.detach(),
                                            v.detach(), causal=True),
                           "train_check: K6's forward under autograd")
        del o
    # the backward's recompute (layers.sdpa_grad) against autograd
    # through layers._sdpa_chunked: no kernel output enters either
    got, want = k6_fwd_bwd(), twin_fwd_bwd()
    grads = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        top = float(w.float().abs().max())
        tol = 4 * bf16_step(top)
        err = float((a.float() - w.float()).abs().max())
        check(bool(torch.isfinite(a).all()) and err <= tol,
              f"train_check: the recompute's {name} off the twin's by "
              f"{err} (> {tol})")
        grads[name] = {"max_abs_err": err, "max_abs": top, "tol": tol}
    out["k6_autograd"] = {
        "q": list(q.shape), "kv": list(k.shape), "dtype": "bfloat16",
        "causal": True, "forward": forward,
        "forward_launches": fwd_launches, "recompute_grads": grads,
        "recompute_tol": "4 bf16 steps at the largest |gradient|",
        "k6_fwd_bwd_ms": time_call_ms(torch, k6_fwd_bwd),
        "twin_fwd_bwd_ms": time_call_ms(torch, twin_fwd_bwd),
        "library_fwd_bwd_ms": time_call_ms(torch, sdpa_fwd_bwd),
        "k6_fwd_ms": time_call_ms(torch, lambda: FA.flash_attention(
            q.detach(), k.detach(), v.detach(), causal=True))}
    emit(out)
    del q, k, v, go, got, want
    torch.cuda.empty_cache()
    return out


def _tree_to(tree, device):
    from repro_torch import tree as TR
    return TR.map(lambda t: t.to(device, copy=True), tree)


def phase_train_moe(torch, kern, TR, M, MH, MOE, configs, device) -> dict:
    """K5 on the training path: qwen2-moe-a2.7b (hf:Qwen/Qwen1.5-MoE-
    A2.7B) at full width (60 experts top-4 + 4 shared, vocab 151 936),
    depth cut to MOE_TRAIN_LAYERS (its float32 masters and AdamW state
    at 24 layers need about 229 GB), batch MOE_TRAIN_BATCH ×
    MOE_TRAIN_SEQ, MOE_TRAIN_STEPS steps of ``train.make_train_step``
    with the launcher's schedule.  The launcher's balancer,
    ``ExpertBalancer(E, min(8, E))``, asserts at E = 60 as the
    reference's does (ROADMAP F7), so the phase balances over
    MOE_EP_SHARDS shards itself and installs the placement after swaps
    as the launcher does.  K5 must launch twice a MoE layer a step
    (forward and the backward's recompute); every loss finite; each
    forward call's counts equal to the plain version's on its inputs
    and their sum the step's expert counts; the swaps reported."""
    import dataclasses
    import numpy as np
    from repro_torch.data import make_batch_iterator
    from repro_torch.distributed import ExpertBalancer
    full = configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS)
    n_exp = cfg.moe.num_experts
    at_start = _free_card(torch)
    calls = []
    wrapped = MOE.moe_histogram

    def spy(idx, gates, *, num_experts):
        out = wrapped(idx, gates, num_experts=num_experts)
        calls.append((idx, gates, out[0]))
        return out

    params = M.init_params(cfg, 0, device=device, dtype=torch.float32)
    opt = TR.init_opt_state(params)
    step_fn = TR.make_train_step(cfg, TR.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(MOE_TRAIN_STEPS // 10, 1),
        total_steps=MOE_TRAIN_STEPS))
    balancer = ExpertBalancer(n_exp, MOE_EP_SHARDS)
    placement = torch.arange(n_exp, dtype=torch.int32, device=device)
    n_params = sum(p.numel() for p in _tree_leaves(params))
    data = make_batch_iterator(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in next(data).items()}
               for _ in range(MOE_TRAIN_STEPS)]
    step_s, losses, swaps, counts_ok = [], [], [], True
    MOE.moe_histogram = spy
    try:
        reset_launches(kern)                  # counts from here …
        for batch in batches:
            calls.clear()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch, placement)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
            rep = balancer.update(m["expert_counts"].cpu().numpy())
            swaps.append(rep["swaps"])
            if rep["swaps"]:
                placement = torch.as_tensor(
                    np.asarray(balancer.placement), dtype=torch.int32,
                    device=device)
            fwd = calls[:MOE_TRAIN_LAYERS]
            summed = sum(c for _, _, c in fwd)
            counts_ok &= len(calls) == 2 * MOE_TRAIN_LAYERS and all(
                torch.equal(c, MH.moe_histogram_ref(i, g, n_exp)[0])
                for i, g, c in fwd) \
                and torch.equal(summed, m["expert_counts"])
        launches = read_launches(kern)        # … to here
    finally:
        MOE.moe_histogram = wrapped
    peak = torch.cuda.max_memory_allocated()
    check(launches["moe_histogram"] == 2 * MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS
          and launches["flash_attention"]
          == 2 * MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS,
          f"train_moe: launches {launches}, {2 * MOE_TRAIN_LAYERS} K5 and "
          f"K6 a step expected (forward and recompute)")
    check(all(math.isfinite(x) for x in losses), f"train_moe: {losses}")
    check(counts_ok, "train_moe: K5's counts differ from its plain "
          "version's or do not sum to the step's expert counts")
    med = statistics.median(step_s[1:])
    out = {"phase": "train_moe", "arch": LM_ARCH, "model": cfg.name,
           "layers": MOE_TRAIN_LAYERS, "d_model": cfg.d_model,
           "experts": n_exp, "top_k": cfg.moe.top_k,
           "shared": cfg.moe.num_shared, "vocab": cfg.vocab_size,
           "cut": f"depth {full.num_layers} -> {MOE_TRAIN_LAYERS}",
           "params": n_params, "allocated_at_start": at_start,
           "batch": MOE_TRAIN_BATCH,
           "seq": MOE_TRAIN_SEQ, "remat": "dots_no_batch",
           "steps": MOE_TRAIN_STEPS, "step_s": step_s,
           "step_s_median": med,
           "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / med,
           "max_memory_allocated": peak, "losses": losses,
           "launches": launches, "counts_exact": counts_ok,
           "ep_shards": MOE_EP_SHARDS,
           "ep_shards_note": "the launcher's min(8, E) asserts at E = 60 "
                             "(F7); the phase's own balancer",
           "balancer_swaps": swaps, "ep_moves": balancer.moves}
    emit(out)
    del params, opt, batches, m
    torch.cuda.empty_cache()
    return out


def _scan_inputs(torch, cfg_h, cfg_s, device) -> dict:
    """Each scan op's inputs at phase scan_ops's shapes, from a seed:
    sequences in bfloat16 (the served compute type), parameters and
    states float32, the stabilisers at the mixers' −1e30 start."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(5)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    b, s = HYBRID_BATCH, LM_PROMPT
    c, n = cfg_h.mamba.expand * cfg_h.d_model, cfg_h.mamba.d_state
    mamba = (F.softplus(randn(b, s, c) - 2.0).to(bf), randn(b, s, n, dtype=bf),
             randn(b, s, n, dtype=bf), randn(b, s, c, dtype=bf),
             -torch.exp(randn(c, n, scale=0.5)), zeros(b, c, n))
    b, s, h, d = SCAN_SSM_BATCH, SSM_PROMPT, cfg_s.num_heads, cfg_s.d_model
    up = int(d * cfg_s.xlstm.proj_factor)
    dk, dv = int(up * cfg_s.xlstm.qk_dim_factor) // h, up // h
    mlstm = (randn(b, s, h, dk, dtype=bf),
             randn(b, s, h, dk, scale=dk ** -0.5, dtype=bf),
             randn(b, s, h, dv, dtype=bf), randn(b, s, h, dtype=bf),
             randn(b, s, h, scale=2.0, dtype=bf), zeros(b, h, dk, dv),
             zeros(b, h, dk), torch.full((b, h), -1e30, device=device))
    dh = d // h
    slstm = (*(randn(b, s, d, dtype=bf) for _ in range(4)),
             *(randn(h, dh, dh, scale=dh ** -0.5) for _ in range(4)),
             zeros(b, d), zeros(b, d), zeros(b, d),
             torch.full((b, d), -1e30, device=device))
    return {"mamba_scan": mamba, "mlstm_scan": mlstm, "slstm_scan": slstm}


def _scan_loop(L, SO, name, args):
    """The loop the op replaces: ``layers.segmented_scan`` over the op's
    step function → (ys batch-major, last carry)."""
    spec = SO.OPS[name]
    seqs, params, carry = spec.split(args)
    step = spec.step(seqs, params)
    carry, ys = L.segmented_scan(step, tuple(carry),
                                 tuple(t.transpose(0, 1) for t in seqs))
    return ys.transpose(0, 1), carry


def phase_scan_ops(torch, L, SO, configs, device) -> dict:
    """The three scan ops (``models/scan_ops.py``) on the card at the
    served shapes (jamba's Mamba layer at B = HYBRID_BATCH, S =
    LM_PROMPT, full d_inner and d_state; xlstm-1.3b's mLSTM and sLSTM at
    B = SCAN_SSM_BATCH, S = SSM_PROMPT), each against the loop it
    replaced, ``layers.segmented_scan`` over the same step: outputs and
    last state bit for bit, the op's and the loop's times.  Then the
    sLSTM op's gradients under autograd (float32 inputs, two segments
    recomputed from the boundary carries) against the loop's
    (``torch.utils.checkpoint`` per segment), within SCAN_GRAD_RTOL of
    each gradient's largest magnitude, and both times.  The ops are loops of torch ops, not kernels: no launch
    is counted."""
    cfg_h = configs.get_config(HYBRID_ARCH)
    cfg_s = configs.get_config(SSM_ARCH)
    res = {"phase": "scan_ops", "ops": {}}
    inputs = _scan_inputs(torch, cfg_h, cfg_s, device)
    with tf32(torch, False), torch.no_grad():
        for name, args in inputs.items():
            op = getattr(torch.ops.repro_torch, name)
            out = op(*args)
            nc = len(SO.OPS[name].split(args)[2])
            ys, carry = _scan_loop(L, SO, name, args)
            torch.cuda.synchronize()
            same = torch.equal(out[0], ys) and all(
                torch.equal(a, b) for a, b in zip(out[1:1 + nc], carry))
            check(same, f"scan_ops: {name} differs from the loop")
            check(all(bool(t.isfinite().all()) for t in out[:1 + nc]),
                  f"scan_ops: {name} gave a value that is not finite")
            res["ops"][name] = {
                "inputs": [list(t.shape) for t in args],
                "ys": list(out[0].shape), "ys_dtype": str(out[0].dtype),
                "bounds": list(out[1 + nc].shape), "bit_for_bit": same,
                "op_ms": time_call_ms(torch, lambda: op(*args)),
                "loop_ms": time_call_ms(
                    torch, lambda: _scan_loop(L, SO, name, args))}
            del out, ys, carry
    args = [t.float() for t in inputs.pop("slstm_scan")]
    del inputs
    _free_card(torch)
    gen = torch.Generator(device=device).manual_seed(6)
    cot = torch.randn(args[0].shape, generator=gen, device=device)

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in args]
        ys = fn(leaves)
        return torch.autograd.grad((ys * cot).sum(), leaves)

    def op_ys(leaves):
        return torch.ops.repro_torch.slstm_scan(*leaves)[0]

    def loop_ys(leaves):
        return _scan_loop(L, SO, "slstm_scan", leaves)[0]

    with tf32(torch, False):
        got, want = grads(op_ys), grads(loop_ys)
        torch.cuda.synchronize()
        worst = 0.0
        for k, (g, w) in enumerate(zip(got, want)):
            err = float((g - w).abs().max())
            check(err <= SCAN_GRAD_RTOL * float(w.abs().max())
                  + SCAN_GRAD_ATOL,
                  f"scan_ops: slstm_scan's gradient of input {k} differs "
                  f"from the loop's by {err}")
            worst = max(worst, err)
        res["slstm_grad"] = {
            "inputs": [list(t.shape) for t in args], "dtype": "float32",
            "max_abs_err": worst, "rtol": SCAN_GRAD_RTOL,
            "atol": SCAN_GRAD_ATOL,
            "op_ms": time_call_ms(torch, lambda: grads(op_ys)),
            "loop_ms": time_call_ms(torch, lambda: grads(loop_ys))}
    emit(res)
    del got, want, args, cot
    _free_card(torch)
    return res


def phase_k1_bank(torch, SU, bank6, decay) -> dict:
    """``stats_update.close_round`` on the whole (8, P, G1) bank at the
    main path's (P, G1): the six input channels of its last round close
    and R, preSpanQ' random; one K1 launch, bit for bit
    ``close_round_ref``; the JAX package's portable fold's twin
    (``close_round_xla``, the blocked cumsum in torch ops) too."""
    ch = [None] * SU.ops.NUM_CH
    for c, plane in zip(SU.IN_CH, bank6.unbind(0)):
        ch[c] = plane
    gen = torch.Generator(device=bank6.device).manual_seed(12)
    for c in range(SU.ops.NUM_CH):
        if ch[c] is None:
            ch[c] = torch.rand(bank6.shape[1:], generator=gen,
                               device=bank6.device)
    bank = torch.stack(ch)
    before = SU.ops.launches
    got = SU.close_round(bank, decay)
    launched = SU.ops.launches - before
    want = SU.close_round_ref(bank, decay)
    twin = SU.close_round_xla(bank, decay)
    torch.cuda.synchronize()
    check(launched == 1, f"k1: close_round launched K1 {launched} times")
    check(torch.equal(got, want), "k1: close_round differs from "
          "close_round_ref")
    check(torch.equal(twin, want), "k1: close_round_xla differs from "
          "close_round_ref")
    res = {"phase": "k1", "entry": "close_round", "bank": list(bank.shape),
           "decay": decay, "launches": launched, "bit_for_bit": True,
           "max_abs_err": float((got - want).abs().max()),
           "ms": time_call_ms(torch, lambda: SU.close_round(bank, decay)),
           "plain_ms": time_call_ms(
               torch, lambda: SU.close_round_ref(bank, decay)),
           "close_round_xla_ms": time_call_ms(
               torch, lambda: SU.close_round_xla(bank, decay))}
    emit(res)
    return res


def phase_analysis() -> dict:
    """``python -m repro_torch.analysis src/repro_torch`` on the card's
    host (a CUDA build of torch): the SWM lint rules over the port, then
    the 19 kernel signature checks, every entry traced on fake CUDA
    tensors through its op's fake implementation.  Fails on a violation
    or a mismatch."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         os.path.join("src", "repro_torch")],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    seconds = time.perf_counter() - t0
    lines = [ln for ln in res.stderr.splitlines() if "[swarmlint]" in ln]
    emit({"phase": "analysis", "exit": res.returncode, "seconds": seconds,
          "summary": lines, "findings": res.stdout.splitlines()[-20:]})
    check(res.returncode == 0
          and any(" 0 violation(s)" in ln for ln in lines)
          and any("kernel signatures: 19 checked, 0 mismatch(es)" in ln
                  for ln in lines),
          f"analysis: exit {res.returncode}\n{res.stdout[-2000:]}"
          f"{res.stderr[-2000:]}")
    return {"seconds": seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import numpy as np

    import repro_torch.streaming as T
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels import keyword_match as KM
    from repro_torch.kernels import knn_match as KN
    from repro_torch.kernels import spatial_match as SM
    from repro_torch.kernels import stats_update as SU
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.kernels.moe_histogram import order as MO
    from repro_torch import configs
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    from repro_torch import train as TR
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import scan_ops as SO
    from repro_torch.models import xlstm as XL
    from repro_torch.distributed import sharding as SH
    kern = {"stats_update": SU, "spatial_match": SM, "keyword_match": KM,
            "knn_match": KN, "moe_histogram": MH, "flash_attention": FA}

    device = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": smi, "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": _build.BUILD_LOG})
    emit({"phase": "k6_ptxas",
          "kernels": ptxas(_build.BUILD_LOG.get("flash_attention", ""))})
    redesigned = {name: ptxas(_build.BUILD_LOG.get(name, ""))
                  for name in PTXAS_KERNELS}
    emit({"phase": "k3_k5_ptxas", **redesigned})
    for name, want in PTXAS_KERNELS.items():
        found = [k["function"] for k in redesigned[name]]
        check(len(found) == len(want) and all(
            sum(w in f for f in found) == 1 for w in want),
            f"k3_k5_ptxas: {name}'s build log lists {found}, one each of "
            f"{want} expected")
    check(all(k.get("spill_stores", 0) == 0 and k.get("spill_loads", 0) == 0
              for ks in redesigned.values() for k in ks),
          f"K3/K5 spill registers: {redesigned}")
    new = {name: [k for k in ptxas(_build.BUILD_LOG.get(name, ""))
                  if any(w in k["function"] for w in want)]
           for name, want in PTXAS_NEW_KERNELS.items()}
    emit({"phase": "k4_k6_ptxas", **new})
    for name, want in PTXAS_NEW_KERNELS.items():
        found = {w: sum(w in k["function"] for k in new[name]) for w in want}
        check(found == want, f"k4_k6_ptxas: {name}'s build log lists "
              f"{found} kernels, {want} expected")
    check(all(k.get("spill_stores", 0) == 0 and k.get("spill_loads", 0) == 0
              for ks in new.values() for k in ks),
          f"K4/K6-decode spill registers: {new}")
    worst = phase_kernel(torch, SU, device)
    worst_k2 = phase_k2(torch, T, np, SM, device)
    worst_k3 = phase_k3(torch, T, np, SM, KM, device)
    worst_k4 = phase_k4(torch, T, np, KN, device)
    worst_k5 = phase_k5(torch, np, MH, MO, device)
    worst_k6 = phase_k6(torch, FA, device)
    plane = T.TorchPlane("cuda")
    phase_parity(T, np, plane)
    phase_tf32(torch, T, np, plane)
    main_out = phase_main(torch, T, np, SU)
    last = phase_breakdown(torch, T, np, SU, main_out)
    live_k1 = phase_k1_live(torch, np, SU, last, main_out, device)
    sharded = phase_sharded(torch, T, np, SU, main_out, smi)
    phase_profile(torch, T, np, main_out)
    match = phase_match(torch, T, np, kern, plane, device)
    pubsub = phase_pubsub(torch, T, np, kern, plane, "torch", device)
    serve = phase_serve(torch, kern, LS, L, MOE, device)
    lm_launches = serve["launches"]
    fa_by = serve["by_kernel"]["flash_attention"]   # K6's launches by kernel
    phase_serve_profile(torch, M, MH, configs, serve, device)
    phase_serve_check(torch, kern, FA, MH, L, MOE, M, configs, device)
    mesh_run = phase_serve_mesh(torch, np, kern, M, configs, serve, device)
    mesh_launches = mesh_run["launches"]
    mesh_by = mesh_run["by_kernel"]["flash_attention"]

    # the kernels line: each kernel at the input its path gave it — K1 at
    # the main path's last round-close input, K2 and K4 at phase match's
    # tick, K3 at phase pubsub's delivery tick, K5 and K6 at the serve
    # path's last prefill call (its decode call in the serve_kernels line,
    # and K6 at both in float32 too)
    bank6, decay = last["bank6"], last["decay"]
    worst = max(worst, k1_error(torch, SU, bank6, decay))
    times = k1_times(torch, SU, bank6, decay)
    phase_k1_bank(torch, SU, bank6, decay)
    k2 = k2_row(torch, SM, match["pts"], match["rects"])
    k3 = k3_row(torch, SM, KM, pubsub["pts"], pubsub["pm"], pubsub["rects"],
                pubsub["sm"])
    k4 = k4_row(torch, KN, match["pts"], match["foci"], KNN_K)
    lm = {}
    for call in ("prefill", "decode"):
        (idx, gates), kw = serve["mh"][call]
        (q, k, v), fkw = serve["fa"][call]
        lm[call] = {
            "moe_histogram": {"shape": list(idx.shape),
                              **k5_row(torch, MH, MO, idx, gates,
                                       kw["num_experts"])},
            "flash_attention": {"q": list(q.shape), "kv": list(k.shape),
                                "dtype": str(q.dtype), **fkw,
                                **k6_row(torch, FA, q, k, v, **fkw)},
            # the same inputs widened to float32, held at 2e-5
            "flash_attention_f32": k6_row(
                torch, FA, *(t.float() for t in (q, k, v)), **fkw,
                timed=False)}
    emit({"serve_kernels": lm})
    del serve
    torch.cuda.empty_cache()
    phase_scan_ops(torch, L, SO, configs, device)
    # the recurrent families; each scan, attention and MoE call marked
    # for the profile split
    mods = ((MB, "mamba_scan", "scan"), (XL, "mlstm_scan", "scan"),
            (XL, "slstm_scan", "scan"),
            (L, "attention", "attention"), (MOE, "moe_ffn", "moe"))
    hybrid = phase_serve_hybrid(torch, kern, LS, L, MOE, M, MO, mods,
                                configs, device)
    phase_hybrid_check(torch, kern, FA, MH, L, MOE, M, configs, device)
    phase_serve_ssm(torch, kern, LS, M, mods, configs, device)
    hy_launches = hybrid["launches"]
    hy_by = hybrid["by_kernel"]["flash_attention"]
    phase_train(torch, kern, LT, M, configs, device)
    phase_train_check(torch, kern, FA, L, M, TR, configs, device)
    phase_train_moe(torch, kern, TR, M, MH, MOE, configs, device)
    phase_dryrun(SH, configs, M)
    phase_analysis()
    emit({"library_ms": {
        "stats_update": "null: no PyTorch call folds rows of host banks "
                        "in place (stats_update_inputs: cumsum of the three "
                        "collectors on the card)",
        "spatial_match": "null: no single PyTorch call computes the "
                         "inclusive containment counts of both sides",
        "keyword_match": "null: no single PyTorch call computes the join; "
                         "a matmul gives only the keyword miss counts",
        "knn_match": "null: no single PyTorch call gives the k smallest "
                     "squared distances (cdist and topk are two calls)"}})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)

    def row(name, launches, err, t, library_ms=None, source=None,
            by_path=None):
        """A kernel's row; ``launches`` a count or, for a wrapper of more
        than one kernel, the split by kernel that the row sums; with
        ``by_path``, the counts of each path it sums."""
        source = source or name
        split = launches if isinstance(launches, dict) else None
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}/{source}.cu",
                "replaces": REPLACES[source],
                "launches": sum(split.values()) if split else launches,
                **({"launches_by_kernel": split} if split else {}),
                **({"launches_by_path": by_path} if by_path else {}),
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library_ms}

    k1_paths = {"main": main_out["k1_launches"],
                "sharded": sharded["k1_launches"],
                "pubsub": pubsub["k1_launches"]}
    emit({"kernels": [
        # K1 in place on the host banks, as every round close runs it
        {**row("stats_update", sum(k1_paths.values()),
               live_k1["max_abs_err"], live_k1, by_path=k1_paths),
         "entry": "stats_update_live_launch"},
        # K1's device contract at the last round close's live rows
        {**row("stats_update_inputs", 0, worst, times, times["library_ms"],
               source="stats_update"),
         "entry": "stats_update_launch"},
        row("spatial_match", match["launches"]["spatial_match"],
            max(worst_k2, k2["max_abs_err"]), k2),
        row("keyword_match", pubsub["launches"]["keyword_match"],
            max(worst_k3, k3["max_abs_err"]), k3),
        row("knn_match", match["by_kernel"],
            max(worst_k4, k4["max_abs_err"]), k4),
        row("moe_histogram",
            lm_launches["moe_histogram"] + hy_launches["moe_histogram"]
            + mesh_launches["moe_histogram"],
            max(worst_k5, lm["prefill"]["moe_histogram"]["max_abs_err"]),
            lm["prefill"]["moe_histogram"],
            lm["prefill"]["moe_histogram"]["library_ms"],
            by_path={"serve": lm_launches["moe_histogram"],
                     "serve_hybrid": hy_launches["moe_histogram"],
                     "serve_mesh": mesh_launches["moe_histogram"]}),
        row("flash_attention",
            {n: fa_by[n] + hy_by[n] + mesh_by[n]
             for n in ("flash_mma", "flash_tile")},
            max(worst_k6["prefill"],
                lm["prefill"]["flash_attention"]["max_abs_err"]),
            lm["prefill"]["flash_attention"],
            lm["prefill"]["flash_attention"]["library_ms"],
            by_path={p: sum(by[n] for n in ("flash_mma", "flash_tile"))
                     for p, by in (("serve", fa_by),
                                   ("serve_hybrid", hy_by),
                                   ("serve_mesh", mesh_by))}),
        # the same source's decode kernels at the serve path's decode input
        row("flash_attention_decode",
            {n: fa_by[n] + hy_by[n] + mesh_by[n]
             for n in ("flash_decode", "flash_merge")},
            max(worst_k6["decode"],
                lm["decode"]["flash_attention"]["max_abs_err"]),
            lm["decode"]["flash_attention"],
            lm["decode"]["flash_attention"]["library_ms"],
            source="flash_attention",
            by_path={p: sum(by[n] for n in ("flash_decode", "flash_merge"))
                     for p, by in (("serve", fa_by),
                                   ("serve_hybrid", hy_by),
                                   ("serve_mesh", mesh_by))})]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
