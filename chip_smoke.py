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
  full forward.

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
kernels); each wrapper counts every kernel it launches, and K4's and
K6's rows split their count by kernel.  K2–K4's operation bounds count one
instruction per lane and clock (SINGLE_ISSUE_OPS_PER_S).

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
# phase k5: (assignments T, top-k K, experts E)
K5_SHAPES = ((256, 4, 60), (65536, 4, 60), (65536, 6, 64))
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
)

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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

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
            "launches": launches}


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
           "transfers": transfers,
           "live_partitions": int(len(router.index.parts.live_ids())),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(out)
    return out


def phase_breakdown(torch, T, np, SU, main) -> dict:
    """The same run with the engine's tracer on: host seconds per span
    (``round_close`` a whole round, host planner included;
    ``stats_close`` inside it the gather, upload, K1 launch and download
    of ``TorchPlane.close_round``; ``fused_window`` a
    whole window, staging included; ``fused_window_dispatch`` the body
    of ``TorchPlane.run_window``; ``tick`` the per-tick boundary steps),
    the declined windows, and the last round close's K1 input, kept for
    the kernels line."""
    eng, _ = _main_engine(T, T.TorchPlane("cuda"),
                          telemetry=T.TelemetryConfig(tick_spans=False))
    last = {}
    real = SU.close_round_inputs

    def keep_input(bank6, decay=0.5):
        last["bank6"], last["decay"] = bank6, decay
        return real(bank6, decay)

    SU.close_round_inputs = keep_input
    try:
        wall = _run(torch, np, eng, main)
    finally:
        SU.close_round_inputs = real
    spans, declined = {}, 0
    for ev in eng.tracer.events:
        if ev.kind != "span":
            continue
        s = spans.setdefault(ev.name, {"s": 0.0, "calls": 0})
        s["s"] += ev.dur / 1e9
        s["calls"] += 1
        if ev.name == "fused_window" and not ev.args.get("ok", True):
            declined += 1
    check(spans.get("stats_close", {}).get("calls") == main["rounds"]
          and "fused_window_dispatch" in spans,
          "traced run: round-close or window spans missing")
    emit({"phase": "breakdown", "wall_s": wall, "declined_windows": declined,
          "spans": spans, "k1_last_shape": list(last["bank6"].shape)})
    return last


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
    plain = {"attention": lambda q, k, v, **kw: FA.attention_ref(q, k, v,
                                                                 **kw),
             "histogram": lambda idx, gates, *, num_experts:
                 MH.moe_histogram_ref(idx, gates, num_experts)}

    def run(cfg, params, toks, steps, plain_path):
        """Prefill on the first CHECK_PROMPT tokens, then decode the
        next ``steps`` of ``toks`` (teacher-forced); checks the launch
        counts of the path."""
        saved = L.flash_attention, MOE.moe_histogram
        if plain_path:
            L.flash_attention = plain["attention"]
            MOE.moe_histogram = plain["histogram"]
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
        n = 0 if plain_path else cfg.num_layers * (1 + steps)
        check(launches["moe_histogram"] == n and fa_calls == n,
              f"serve_check: launches {launches} on the "
              f"{'plain' if plain_path else 'kernel'} path, {n} K5 and "
              f"{n} K6 calls expected")
        return outs, counts

    def compare(cfg, params, steps):
        kern_out, kern_counts = run(cfg, params, toks, steps, False)
        plain_out, plain_counts = run(cfg, params, toks, steps, True)
        check(all(bool(torch.isfinite(a).all()) for a in kern_out),
              "serve_check: a logit is not finite")
        largest = max(float(p.float().abs().max()) for p in plain_out)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(kern_out, plain_out)]
        return kern_out, {
            "batch": CHECK_BATCH, "prompt": CHECK_PROMPT,
            "decode_steps": steps, "max_abs_logit": largest,
            "max_abs_err_per_call": errs,
            "expert_counts_equal": all(
                torch.equal(a, b) for a, b in zip(kern_counts, plain_counts))}

    gen = torch.Generator(device=device).manual_seed(5)
    toks = torch.randint(0, full.vocab_size, (CHECK_BATCH, CHECK_PROMPT + 4),
                         generator=gen, device=device, dtype=torch.int32)
    with tf32(torch, False):                  # float32 in float32
        cfg = dataclasses.replace(full, num_layers=2)
        params = M.init_params(cfg, 3, device=device)
        _, res = compare(cfg, params, 3)
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
        kern_out, res = compare(cfg, params, 4)
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
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
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
    phase_profile(torch, T, np, main_out)
    match = phase_match(torch, T, np, kern, plane, device)
    pubsub = phase_pubsub(torch, T, np, kern, plane, "torch", device)
    serve = phase_serve(torch, kern, LS, L, MOE, device)
    lm_launches = serve["launches"]
    fa_by = serve["by_kernel"]["flash_attention"]   # K6's launches by kernel
    phase_serve_profile(torch, M, MH, configs, serve, device)
    phase_serve_check(torch, kern, FA, MH, L, MOE, M, configs, device)

    # the kernels line: each kernel at the input its path gave it — K1 at
    # the main path's last round-close input, K2 and K4 at phase match's
    # tick, K3 at phase pubsub's delivery tick, K5 and K6 at the serve
    # path's last prefill call (its decode call in the serve_kernels line,
    # and K6 at both in float32 too)
    bank6, decay = last["bank6"], last["decay"]
    worst = max(worst, k1_error(torch, SU, bank6, decay))
    times = k1_times(torch, SU, bank6, decay)
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
    emit({"library_ms": {
        "spatial_match": "null: no single PyTorch call computes the "
                         "inclusive containment counts of both sides",
        "keyword_match": "null: no single PyTorch call computes the join; "
                         "a matmul gives only the keyword miss counts",
        "knn_match": "null: no single PyTorch call gives the k smallest "
                     "squared distances (cdist and topk are two calls)"}})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)

    def row(name, launches, err, t, library_ms=None, source=None):
        """A kernel's row; ``launches`` a count or, for a wrapper of more
        than one kernel, the split by kernel that the row sums."""
        source = source or name
        split = launches if isinstance(launches, dict) else None
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}/{source}.cu",
                "replaces": REPLACES[source],
                "launches": sum(split.values()) if split else launches,
                **({"launches_by_kernel": split} if split else {}),
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library_ms}

    emit({"kernels": [
        row("stats_update", main_out["k1_launches"], worst, times,
            times["library_ms"]),
        row("spatial_match", match["launches"]["spatial_match"],
            max(worst_k2, k2["max_abs_err"]), k2),
        row("keyword_match", pubsub["launches"]["keyword_match"],
            max(worst_k3, k3["max_abs_err"]), k3),
        row("knn_match", match["by_kernel"],
            max(worst_k4, k4["max_abs_err"]), k4),
        row("moe_histogram", lm_launches["moe_histogram"],
            max(worst_k5, lm["prefill"]["moe_histogram"]["max_abs_err"]),
            lm["prefill"]["moe_histogram"],
            lm["prefill"]["moe_histogram"]["library_ms"]),
        row("flash_attention",
            {n: fa_by[n] for n in ("flash_mma", "flash_tile")},
            max(worst_k6["prefill"],
                lm["prefill"]["flash_attention"]["max_abs_err"]),
            lm["prefill"]["flash_attention"],
            lm["prefill"]["flash_attention"]["library_ms"]),
        # the same source's decode kernels at the serve path's decode input
        row("flash_attention_decode",
            {n: fa_by[n] for n in ("flash_decode", "flash_merge")},
            max(worst_k6["decode"],
                lm["decode"]["flash_attention"]["max_abs_err"]),
            lm["decode"]["flash_attention"],
            lm["decode"]["flash_attention"]["library_ms"],
            source="flash_attention")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
