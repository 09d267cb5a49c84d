#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It builds every kernel of the streaming main path from the sources in
the checkout (nvcc, at first use), holds each kernel against its plain
PyTorch version on the card, checks the port against its own NumPy
reference plane on a small timeline, checks that window counts stay
exact with TF32 enabled globally, and drives the main path —
``StreamingEngine`` → ``SwarmRouter`` → ``TorchPlane`` — at a realistic
size: grid 512, 64 machines, 131 072 tuples per tick, 100 000 resident
queries, the paper's Fig-12 hotspot timeline — three times: as a user
runs it (the end-to-end rate), with the engine's own tracer on (time
per layer) and under ``torch.profiler`` (the card's busy share).  Each
phase prints one JSON line; then the card's name and power limit as
nvidia-smi gives them, the ``kernels`` line, and last
``{"ok": true, "device": ...}``.
Any failed check raises and the script exits non-zero; without a CUDA
card, or without the repository around it, it exits non-zero before
printing any result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# the main path's realistic size (see PERF.md, "Cells")
GRID, MACHINES = 512, 64       # largest cell of benchmarks/control_plane.py
LAMBDA = 131072                # largest batch of benchmarks/engine_throughput.py
QUERIES = 100_000              # README pub/sub quickstart scale
TICKS, ROUND_EVERY, WINDOW = 96, 8, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def k1_bound(p: int, g1: int) -> tuple[float, str, int]:
    """Least time for one round close of a (6, p, g1) bank: each input
    read once, each of the 5 outputs written once, against the adds of
    three scans and the five channel updates."""
    nbytes = (6 + 5) * p * g1 * 4
    ops = (3 + 5) * p * g1
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


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
    torch.backends.cuda.matmul.allow_tf32 = True
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
        st, _, _, ok = pl.run_window(pl.make_state(host), cp, fp, carry, xy)
        check(ok, "F2 window declined")
        banks[name] = pl.collector_banks(st)
    for a, c in zip(banks["torch"], banks["numpy"]):
        check(np.array_equal(a, c), "F2: collector banks differ with TF32")
    from repro_torch.core.geometry import points_to_cells
    row, col = points_to_cells(xy[0], g)
    emit({"phase": "f2", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
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
    from repro_torch.kernels import stats_update as SU

    device = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": smi, "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": _build.BUILD_LOG})
    worst = phase_kernel(torch, SU, device)
    plane = T.TorchPlane("cuda")
    phase_parity(T, np, plane)
    phase_tf32(torch, T, np, plane)
    main_out = phase_main(torch, T, np, SU)
    last = phase_breakdown(torch, T, np, SU, main_out)
    phase_profile(torch, T, np, main_out)

    # the kernels line: K1 at the main path's last round-close input
    bank6, decay = last["bank6"], last["decay"]
    worst = max(worst, k1_error(torch, SU, bank6, decay))
    times = k1_times(torch, SU, bank6, decay)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "stats_update", "route": "cuda",
        "source": "src/repro_torch/kernels/stats_update/stats_update.cu",
        "replaces": "src/repro/kernels/stats_update/stats_update.py:38",
        "launches": main_out["k1_launches"], "max_abs_err": worst,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
