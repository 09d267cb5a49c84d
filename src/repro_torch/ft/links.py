"""Geo-distributed link model: per-pair base latency + jitter.

The paper's cluster is a single pod — every machine pair is one switch
hop away and SWARM prices all migrations identically.  The scalehub
measurements (PAPERS.md) show that assumption is exactly what breaks
first in a geo-distributed deployment: inter-region links add tens of
milliseconds of latency with non-trivial jitter, heartbeats arrive
late, transfers take real time, and backpressure stops being a
trustworthy rebalance trigger.  :class:`LinkSpec` describes a static
region topology (which machine lives where, how expensive each pair
is); :class:`LinkModel` samples concrete per-message delays from it.

Determinism contract
--------------------
Delay sampling is *order-invariant*: ``delay_ms(src, dst, tick)`` is a
pure hash of ``(seed, src, dst, tick)`` — no sequential RNG stream is
consumed.  The fused engine path and the per-tick reference loop query
delays in different orders (a window fast-forwards heartbeats after
the scan; the per-tick loop interleaves them with injection), and a
counter-based sample is the only way both see bit-identical link
behaviour.  ``LinkSpec() is None``-gating keeps every existing golden
untouched: an engine without a spec never calls into this module.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer — avalanches a 64-bit counter."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def _u01(seed: int, src: int, dst: int, tick: int) -> float:
    """Uniform [0, 1) keyed on the full sample coordinate."""
    h = _mix(seed * 0x9E3779B97F4A7C15 + _mix(
        (src + 1) * 0xD6E8FEB86659FD93 + _mix(
            (dst + 1) * 0xC2B2AE3D27D4EB4F + tick)))
    return h / float(1 << 64)


@dataclass(frozen=True)
class LinkSpec:
    """Static description of a geo link topology.

    ``regions`` assigns each machine a region id (an empty tuple puts
    everyone in region 0 — a zero-latency pod).  Latency within a
    region is ``intra_ms`` ± ``intra_jitter_ms``; across regions it is
    ``inter_ms`` ± ``jitter_ms`` (uniform jitter).  ``tick_ms`` maps
    wall milliseconds onto engine ticks, so the same topology can be
    stressed at different tick granularities (the paper's 15 s rounds
    make any link latency invisible; benchmarks shrink the tick).
    Frozen + comparable so it folds into experiment labels."""

    regions: tuple[int, ...] = ()
    intra_ms: float = 0.0
    inter_ms: float = 25.0
    jitter_ms: float = 10.0
    intra_jitter_ms: float = 0.0
    tick_ms: float = 10.0
    seed: int = 0

    def __str__(self):  # compact label for Experiment.label folding
        reg = "".join(str(r) for r in self.regions) or "0*"
        return (f"geo[{reg}|{self.inter_ms:g}±{self.jitter_ms:g}ms"
                f"/{self.tick_ms:g}ms]")


def two_region(num_machines: int, *, inter_ms: float = 25.0,
               jitter_ms: float = 10.0, tick_ms: float = 10.0,
               seed: int = 0) -> LinkSpec:
    """The benchmark topology: machines split evenly across two
    regions, 25 ms base / 10 ms jitter links between them (the
    scalehub geo setup), free links within a region."""
    half = num_machines // 2
    regions = tuple(0 if m < half else 1 for m in range(num_machines))
    return LinkSpec(regions=regions, inter_ms=inter_ms,
                    jitter_ms=jitter_ms, tick_ms=tick_ms, seed=seed)


class LinkModel:
    """Runtime sampler for a :class:`LinkSpec` over ``num_machines``
    machines (machine ``num_machines`` indexes the control plane /
    Coordinator side of heartbeat links)."""

    def __init__(self, spec: LinkSpec, num_machines: int):
        self.spec = spec
        self.m = int(num_machines)
        reg = list(spec.regions[:self.m])
        reg += [0] * (self.m - len(reg))
        self.regions = np.asarray(reg, np.int64)
        cross = self.regions[:, None] != self.regions[None, :]
        self._base = np.where(cross, spec.inter_ms, spec.intra_ms)
        self._jit = np.where(cross, spec.jitter_ms, spec.intra_jitter_ms)
        np.fill_diagonal(self._base, 0.0)
        np.fill_diagonal(self._jit, 0.0)

    # -- sampling ------------------------------------------------------
    def delay_ms(self, src: int, dst: int, tick: int) -> float:
        """One-way delay of a message sent ``src → dst`` at ``tick``."""
        if src == dst:
            return 0.0
        base = float(self._base[src, dst])
        jit = float(self._jit[src, dst])
        if jit <= 0.0:
            return base
        return base + jit * _u01(self.spec.seed, src, dst, tick)

    def delay_ticks(self, src: int, dst: int, tick: int) -> int:
        """The same delay quantized to whole engine ticks (floor: a
        message arriving mid-tick is visible at that tick's scan)."""
        ms = self.delay_ms(src, dst, tick)
        return int(ms / max(self.spec.tick_ms, 1e-9))

    def max_delay_ticks(self) -> int:
        """Upper bound on any sampled delay, in ticks — the adaptive
        failure detector and window-boundary logic size buffers by it."""
        worst = float((self._base + self._jit).max(initial=0.0))
        return int(np.ceil(worst / max(self.spec.tick_ms, 1e-9)))

    # -- planner view --------------------------------------------------
    def cost_matrix(self) -> np.ndarray:
        """(M, M) expected one-way delay in *ticks* per pair — the
        planner's per-link extension of the per-machine capacity
        factors (``plan_round(link_cost=...)``).  Expected, not
        sampled: plans must not depend on jitter realizations."""
        return (self._base + 0.5 * self._jit) / max(self.spec.tick_ms, 1e-9)
