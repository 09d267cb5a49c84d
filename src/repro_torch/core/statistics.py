"""SWARM partition statistics (paper §4.2).

Each partition maintains, for its rows and for its columns, five
statistics (N, Q, R, spanQ, preSpanQ') plus three *Statistics Collectors*
(N', Q', spanQ') that absorb per-tuple updates so the maintained stats
are touched only at round close (Algorithm 2).

Array-native layout
-------------------
All partitions' stats live in two dense arrays::

    rows: (NUM_CH, P_MAX, G + 1) float32     # per-global-row channel
    cols: (NUM_CH, P_MAX, G + 1) float32     # per-global-col channel

Entries are indexed by *global* grid row/col; only indices inside the
partition's span are meaningful.  Cumulative stats are cumulative from
the partition's first row/col, exactly as the paper maintains them —
because collectors outside the span are never touched, a plain prefix
sum along the last axis realizes the paper's "carry the summation" trick
(Algorithm 2) for *all* partitions at once.

The spanQ' collector is stored in *difference* form (+1 at range start,
-1 past range end) so a query spanning k rows costs O(1) updates instead
of O(k); the prefix sum at round close materializes it.  Width G+1 gives
the difference form a slot past the last row.

TPU note: the per-round close is a bank of independent prefix sums —
see kernels/stats_update for the Pallas realization; this module is the
reference (and the control-plane implementation).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Channel indices.
N = 0          # cumulative data-point count
Q = 1          # cumulative query count (counted at clipped start row/col)
R = 2          # cumulative new points+queries received last round
SPANQ = 3      # queries spanning from previous row/col
PRESPANQ = 4   # new (last-round) queries spanning from previous row/col
C_N = 5        # collector N'
C_Q = 6        # collector Q'
C_SPAN = 7     # collector spanQ' (difference form)
NUM_CH = 8

MAINTAINED = (N, Q, R, SPANQ, PRESPANQ)
COLLECTORS = (C_N, C_Q, C_SPAN)


@dataclass
class StatsState:
    """Dense stats for up to P_MAX partitions on a G×G grid."""

    rows: np.ndarray  # (NUM_CH, P_MAX, G+1)
    cols: np.ndarray  # (NUM_CH, P_MAX, G+1)
    grid_size: int

    @classmethod
    def zeros(cls, p_max: int, grid_size: int) -> "StatsState":
        shape = (NUM_CH, p_max, grid_size + 1)
        return cls(np.zeros(shape, np.float32), np.zeros(shape, np.float32), grid_size)

    def copy(self) -> "StatsState":
        return StatsState(self.rows.copy(), self.cols.copy(), self.grid_size)


# ---------------------------------------------------------------------------
# Ingest (per-tick hot path): touch only collectors (§4.2.2).
# ---------------------------------------------------------------------------

def ingest_points(st: StatsState, pid, row, col, weight=None) -> None:
    """Record new data points.  pid/row/col: int arrays of equal length.

    Per the paper, a new data point increments N' of the row and the
    column containing it — two collector updates.  ``weight`` (optional,
    defaults to 1) supports expiry as negative-weight ingest.
    """
    w = np.ones(len(np.atleast_1d(pid)), np.float32) if weight is None else weight
    np.add.at(st.rows[C_N], (pid, row), w)
    np.add.at(st.cols[C_N], (pid, col), w)


def ingest_queries(st: StatsState, pid, r0, c0, r1, c1) -> None:
    """Record new (clipped-to-partition) query rectangles.

    Increments Q' at the start row/col and spanQ' (difference form) for
    the rows/cols the range spans beyond its first (§4.2.2).
    """
    pid = np.atleast_1d(pid)
    one = np.ones(len(pid), np.float32)
    np.add.at(st.rows[C_Q], (pid, r0), one)
    np.add.at(st.cols[C_Q], (pid, c0), one)
    # spanQ' over rows r0+1 .. r1  (empty when r1 == r0)
    np.add.at(st.rows[C_SPAN], (pid, r0 + 1), one)
    np.add.at(st.rows[C_SPAN], (pid, r1 + 1), -one)
    np.add.at(st.cols[C_SPAN], (pid, c0 + 1), one)
    np.add.at(st.cols[C_SPAN], (pid, c1 + 1), -one)


# ---------------------------------------------------------------------------
# Round close (Algorithm 2) — one prefix-sum pass for every partition.
# ---------------------------------------------------------------------------

def close_round(st: StatsState, decay: float = 0.5) -> None:
    """Fold collectors into maintained stats; reset collectors.

    ``decay`` scales old N before the update (paper: "N is divided by 2
    before it is updated in each round"); use decay=1.0 for exact
    counting (the §4.2.3 correctness regime, used by the tests).
    """
    for axis in (st.rows, st.cols):
        cum_n = np.cumsum(axis[C_N], axis=-1)
        cum_q = np.cumsum(axis[C_Q], axis=-1)
        span_new = np.cumsum(axis[C_SPAN], axis=-1)  # materialize diff form
        axis[N] = axis[N] * decay + cum_n
        axis[Q] = axis[Q] + cum_q
        axis[R] = cum_n + cum_q
        axis[PRESPANQ] = span_new
        axis[SPANQ] = axis[SPANQ] + span_new
        axis[C_N] = 0.0
        axis[C_Q] = 0.0
        axis[C_SPAN] = 0.0


# ---------------------------------------------------------------------------
# Totals & reconstruction (§4.2.3 — the split-exactness identities).
# ---------------------------------------------------------------------------

def partition_totals(st: StatsState, pid: int, r1: int, c1: int):
    """(N(p), Q(p), R(p)) read from the last row of the partition."""
    return (
        float(st.rows[N, pid, r1]),
        float(st.rows[Q, pid, r1]),
        float(st.rows[R, pid, r1]),
    )


def count_points_rows(st: StatsState, pid: int, r0: int, u: int, l: int) -> float:
    """True #points in rows [u..l] of partition pid: N(l) − N(u−1)."""
    below = st.rows[N, pid, u - 1] if u > r0 else 0.0
    return float(st.rows[N, pid, l] - below)


def count_queries_rows(st: StatsState, pid: int, r0: int, u: int, l: int) -> float:
    """True #queries overlapping rows [u..l]: Eqn 9 via Q and spanQ.

    q(u, l) = Q(l) − Q(u−1) + spanQ(u)   (spanQ(r0) ≡ 0).
    """
    below = st.rows[Q, pid, u - 1] if u > r0 else 0.0
    span = st.rows[SPANQ, pid, u] if u > r0 else 0.0
    return float(st.rows[Q, pid, l] - below + span)


def count_recent_rows(st: StatsState, pid: int, r0: int, u: int, l: int) -> float:
    """True #new objects overlapping rows [u..l] (R with preSpanQ')."""
    below = st.rows[R, pid, u - 1] if u > r0 else 0.0
    span = st.rows[PRESPANQ, pid, u] if u > r0 else 0.0
    return float(st.rows[R, pid, l] - below + span)


# ---------------------------------------------------------------------------
# Split derivation — exact along the split axis (the point of §4.2.3),
# proportional rescale on the orthogonal axis (engineering choice, see
# DESIGN.md §3; fresh arrivals re-sharpen it every round).
# ---------------------------------------------------------------------------

def derive_row_split(st: StatsState, pid: int, pid_lo: int, pid_hi: int,
                     r0: int, sp: int, r1: int, c0: int, c1: int) -> None:
    """Split partition ``pid`` at row ``sp`` into pid_lo (rows r0..sp) and
    pid_hi (rows sp+1..r1).  Row stats are derived exactly; column stats
    are rescaled by each side's share of the per-stat total."""
    g1 = st.grid_size + 1
    rows = st.rows
    # --- exact row stats ---
    for ch in MAINTAINED:
        rows[ch, pid_lo] = 0.0
        rows[ch, pid_hi] = 0.0
        rows[ch, pid_lo, r0:sp + 1] = rows[ch, pid, r0:sp + 1]
    hi = slice(sp + 1, r1 + 1)
    rows[N, pid_hi, hi] = rows[N, pid, hi] - rows[N, pid, sp]
    rows[Q, pid_hi, hi] = rows[Q, pid, hi] - rows[Q, pid, sp] + rows[SPANQ, pid, sp + 1]
    rows[R, pid_hi, hi] = rows[R, pid, hi] - rows[R, pid, sp] + rows[PRESPANQ, pid, sp + 1]
    rows[SPANQ, pid_hi, hi] = rows[SPANQ, pid, hi]
    rows[SPANQ, pid_hi, sp + 1] = 0.0
    rows[PRESPANQ, pid_hi, hi] = rows[PRESPANQ, pid, hi]
    rows[PRESPANQ, pid_hi, sp + 1] = 0.0
    # --- proportional column stats ---
    _rescale_orthogonal(st.cols, st.rows, pid, pid_lo, pid_hi, r0, sp, r1, c0, c1, g1)
    _clear_partition(st, pid)


def derive_col_split(st: StatsState, pid: int, pid_lo: int, pid_hi: int,
                     c0: int, sp: int, c1: int, r0: int, r1: int) -> None:
    """Column-axis analogue of :func:`derive_row_split`."""
    cols = st.cols
    for ch in MAINTAINED:
        cols[ch, pid_lo] = 0.0
        cols[ch, pid_hi] = 0.0
        cols[ch, pid_lo, c0:sp + 1] = cols[ch, pid, c0:sp + 1]
    hi = slice(sp + 1, c1 + 1)
    cols[N, pid_hi, hi] = cols[N, pid, hi] - cols[N, pid, sp]
    cols[Q, pid_hi, hi] = cols[Q, pid, hi] - cols[Q, pid, sp] + cols[SPANQ, pid, sp + 1]
    cols[R, pid_hi, hi] = cols[R, pid, hi] - cols[R, pid, sp] + cols[PRESPANQ, pid, sp + 1]
    cols[SPANQ, pid_hi, hi] = cols[SPANQ, pid, hi]
    cols[SPANQ, pid_hi, sp + 1] = 0.0
    cols[PRESPANQ, pid_hi, hi] = cols[PRESPANQ, pid, hi]
    cols[PRESPANQ, pid_hi, sp + 1] = 0.0
    _rescale_orthogonal(st.rows, st.cols, pid, pid_lo, pid_hi, c0, sp, c1, r0, r1,
                        st.grid_size + 1)
    _clear_partition(st, pid)


def _rescale_orthogonal(dst, src, pid, pid_lo, pid_hi, a0, sp, a1, b0, b1, g1):
    """Rescale the orthogonal-axis stats to each side's *exact* total.

    dst: the orthogonal axis bank (cols for a row split); src: the split
    axis bank used to read exact side totals.  Note f_lo + f_hi can
    exceed 1: a query spanning the split line is genuinely resident on
    BOTH children (it must be checked on both), so children totals may
    sum to more than the parent's — scaling each side independently
    keeps both banks' totals equal to the exact split-axis totals.
    Span channels (per-row values, not cumulative) reuse the Q/R
    fractions — spanning queries distribute like queries.
    """
    area_f_lo = (sp - a0 + 1) / (a1 - a0 + 1)
    fractions = {}
    for ch in (N, Q, R):
        tot = src[ch, pid, a1]
        if ch in (Q, R):
            span_ch = SPANQ if ch == Q else PRESPANQ
            hi_tot = tot - src[ch, pid, sp] + src[span_ch, pid, sp + 1]
        else:
            hi_tot = tot - src[ch, pid, sp]
        lo_tot = src[ch, pid, sp]
        if tot <= 0:
            fractions[ch] = (area_f_lo, 1.0 - area_f_lo)
        else:
            fractions[ch] = (lo_tot / tot, hi_tot / tot)
    fractions[SPANQ] = fractions[Q]
    fractions[PRESPANQ] = fractions[R]
    for ch in MAINTAINED:
        f_lo, f_hi = fractions[ch]
        dst[ch, pid_lo] = dst[ch, pid] * f_lo
        dst[ch, pid_hi] = dst[ch, pid] * f_hi


def move_partition_stats(st: StatsState, pid_src: int, pid_dst: int) -> None:
    """Relabel stats when a whole partition moves (new unique ID)."""
    st.rows[:, pid_dst] = st.rows[:, pid_src]
    st.cols[:, pid_dst] = st.cols[:, pid_src]
    _clear_partition(st, pid_src)


def _clear_partition(st: StatsState, pid: int) -> None:
    st.rows[:, pid] = 0.0
    st.cols[:, pid] = 0.0
