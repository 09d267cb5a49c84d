"""The plain reference of SWARM's streaming main path, for both
configurations: what one round must produce, worked out again from the
tuples and standing queries the benchmark generated and from the plan
the program reports.

Plain PyTorch on the CPU, in a dtype the caller names: ``float64`` is the
reference, ``bfloat16`` the control (the nearest precision below the
configurations' float32).  It imports nothing of the program.  Counts of
queries over partitions are integers in both; every quantity the
configurations compute in floating point (per-tuple costs, queues,
backpressure, expected deliveries, the statistics collectors and their
round close) is computed in ``dtype``.

The semantics are those of the paper's cost model (§6) and Algorithm 2:

* a tuple at (x, y) lies in cell (⌊y·G⌋, ⌊x·G⌋) (float32 coordinates) and
  goes to the partition that the plan's grid gives that cell, and so to
  the partition's owner;
* it costs ``c0 + κp·log2(1 + Q_m)·(1 + max(0, (Q_m − q_cache)/q_cache))
  + κm·E[matches]`` on its owner m, where Q_m counts the standing queries
  resident on m's partitions, and E[matches] the partition's resident
  queries times min(query area / partition area, 1); a keyword tuple's
  resident queries are those whose pivot bucket it probes, and it adds
  ``delivery_cost`` per expected delivery;
* each tick injects ⌊min(λmax, λ)⌋ tuples, processes each machine's queue
  up to its capacity at its average cost, and moves λ by the spout's
  backpressure rule;
* a round close folds the N′ collectors (one count per tuple in its
  partition's row and column) into the maintained statistics.
"""
from __future__ import annotations

import numpy as np
import torch

# statistics channels (the paper's N, Q, R, spanQ, preSpanQ and the three
# collectors N', Q', spanQ')
N, Q, R, SPANQ, PRESPANQ, C_N, C_Q, C_SPAN = range(8)
MAINTAINED, COLLECTORS = (N, Q, R, SPANQ, PRESPANQ), (C_N, C_Q, C_SPAN)


# -- geometry ----------------------------------------------------------------

def cell_of(v: np.ndarray, g: int) -> np.ndarray:
    """Cell index along one axis of float32 coordinates."""
    v = np.asarray(v, np.float32) * np.float32(g)
    return np.clip(v.astype(np.int64), 0, g - 1)


def point_cells(xy: np.ndarray, g: int) -> tuple[np.ndarray, np.ndarray]:
    return cell_of(xy[:, 1], g), cell_of(xy[:, 0], g)


def rect_cells(rects: np.ndarray, g: int):
    c0, r0 = cell_of(rects[:, 0], g), cell_of(rects[:, 1], g)
    c1 = np.maximum(cell_of(rects[:, 2], g), c0)
    r1 = np.maximum(cell_of(rects[:, 3], g), r0)
    return r0, c0, r1, c1


# -- term hashing (keyword workloads) -------------------------------------------

def mix32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.int64) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def term_buckets(terms: np.ndarray, t: int) -> np.ndarray:
    return (mix32(terms) % t).astype(np.int64)


def pivots(terms: np.ndarray, t: int) -> np.ndarray:
    """A subscription's pivot: its smallest term bucket."""
    return term_buckets(terms, t).min(axis=1)


def probe_onehot(terms: np.ndarray, t: int) -> np.ndarray:
    """(N, T+1) indicator of the buckets a tuple probes: its terms'
    buckets and the wildcard bucket T."""
    out = np.zeros((len(terms), t + 1), bool)
    rows = np.repeat(np.arange(len(terms)), terms.shape[1])
    out[rows, term_buckets(terms, t).reshape(-1)] = True
    out[:, t] = True
    return out


# -- standing queries over the plan ------------------------------------------

def resident_counts(qcells, boxes: np.ndarray, piv: np.ndarray | None = None,
                    t1: int = 0, chunk: int = 65536):
    """Queries overlapping each partition box (inclusive cell bounds),
    and with ``piv`` the (P, t1) counts by pivot bucket."""
    r0, c0, r1, c1 = qcells
    br0, bc0, br1, bc1 = (boxes[:, i][None, :] for i in range(4))
    qres = np.zeros(len(boxes), np.int64)
    by_piv = np.zeros((len(boxes), t1), np.int64) if piv is not None else None
    for lo in range(0, len(r0), chunk):
        s = slice(lo, lo + chunk)
        hit = ((r0[s, None] <= br1) & (r1[s, None] >= br0)
               & (c0[s, None] <= bc1) & (c1[s, None] >= bc0))
        qres += hit.sum(0)
        if piv is not None:
            qi, pi = np.nonzero(hit)
            np.add.at(by_piv, (pi, piv[s][qi]), 1)
    return qres, by_piv


# -- one round -----------------------------------------------------------------

def replay_round(rnd: dict, sysp: dict, queries: dict, dtype) -> dict:
    """The per-tick outputs and the N′ collectors of one round.

    ``rnd`` holds the round's tuples (``points``, and ``terms`` for a
    keyword deployment: full per-tick batches), the plan at its start
    (``grid``, ``boxes``, ``owner``, ``live``) and the engine's queue
    state at its start (``queue_units``, ``queue_tuples``, ``lam``).
    ``queries`` holds the standing set's cells and, for a keyword
    deployment, pivots.  Returns per tick ``injected``, ``throughput``,
    ``latency``, ``utilization`` (M,), ``deliveries``; and ``cn_rows``,
    ``cn_cols``: (P, G+1) counts by partition and row or column."""
    f = lambda v: torch.as_tensor(v, dtype=dtype)  # noqa: E731
    g, m = int(sysp["grid"]), int(sysp["machines"])
    cost = sysp["cost"]
    keyword = sysp["query_model"] == "spatial_keyword"
    t = int(sysp.get("term_buckets", 0))
    grid = torch.as_tensor(rnd["grid"], dtype=torch.long)
    owner = torch.as_tensor(rnd["owner"], dtype=torch.long)
    boxes = rnd["boxes"]
    live = rnd["live"]
    p = len(owner)

    qres, qres_kw = resident_counts(
        queries["cells"], boxes[live], queries.get("pivots"), t + 1)
    qres_all = np.zeros(p, np.int64)
    qres_all[live] = qres
    q_machine = np.zeros(m, np.int64)
    np.add.at(q_machine, rnd["owner"][live], qres)
    area = ((boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
            ).astype(np.float64) / (g * g)
    area[area <= 0] = 1.0
    cov = torch.clamp_max(f(float(sysp["query_side"]) ** 2) / f(area), 1.0)
    qm = f(q_machine)
    qc = f(cost["q_cache"])
    probe_m = (f(cost["kappa_probe"]) * torch.log2(1.0 + qm)
               * (1.0 + torch.clamp_min((qm - qc) / qc, 0.0)))
    if keyword:
        kw_all = np.zeros((p, t + 1), np.int64)
        kw_all[live] = qres_kw
        kw = f(kw_all)
    qres_f = f(qres_all)

    cap = f(float(sysp["cap_units"]))
    lmax = f(float(sysp["lambda_max"]))
    bp_high, bp_dec = f(sysp["bp_high"]), f(sysp["bp_dec"])
    lam_up = f(sysp["bp_inc"]) * lmax
    eps = f(1e-9)
    qu, qt = f(rnd["queue_units"]), f(rnd["queue_tuples"])
    lam = f(rnd["lam"])
    cn_rows = torch.zeros((p, g + 1), dtype=dtype)
    cn_cols = torch.zeros((p, g + 1), dtype=dtype)
    outs = {k: [] for k in ("injected", "throughput", "latency",
                            "utilization", "deliveries")}
    for i, xy in enumerate(rnd["points"]):
        n = int(torch.floor(torch.minimum(lmax, lam)))
        row, col = point_cells(xy[:n], g)
        row_t, col_t = torch.as_tensor(row), torch.as_tensor(col)
        pid = grid[row_t, col_t]
        own = owner[pid]
        c = f(cost["c0"]) + probe_m[own]
        dels = f(0.0)
        if keyword:
            hot = torch.as_tensor(probe_onehot(rnd["terms"][i][:n], t))
            cand = (kw[pid] * hot.to(dtype)).sum(1)
            d = cand * cov[pid]
            c = (c + f(cost["kappa_match"]) * d
                 + f(sysp["delivery_cost"]) * d)
            dels = d.sum()
        else:
            c = c + f(cost["kappa_match"]) * qres_f[pid] * cov[pid]
        one = torch.ones(n, dtype=dtype)
        qu = qu + torch.zeros(m, dtype=dtype).index_add_(0, own, c)
        qt = qt + torch.zeros(m, dtype=dtype).index_add_(0, own, one)
        cn_rows.index_put_((pid, row_t), one, accumulate=True)
        cn_cols.index_put_((pid, col_t), one, accumulate=True)
        # process each queue up to capacity at its average cost, then
        # the spout's backpressure (multiplicative down, additive up)
        pu = torch.minimum(qu, cap)
        avg = torch.where(qt > 0, qu / torch.maximum(qt, eps), f(1.0))
        pt = torch.minimum(pu / torch.maximum(avg, eps), qt)
        qu = qu - pt * avg
        qt = qt - pt
        delay = qu / cap + avg / cap
        w = pt.sum()
        latency = (delay * pt).sum() / w if float(w) > 0 else f(0.0)
        if bool((qu > bp_high * cap).any()):
            lam = torch.maximum(lam * bp_dec, f(1.0))
        else:
            lam = torch.minimum(lam + lam_up, lmax)
        outs["injected"].append(n)
        outs["throughput"].append(float(w))
        outs["latency"].append(float(latency))
        outs["utilization"].append((pu / cap).double().numpy())
        outs["deliveries"].append(float(dels))
    res = {k: np.asarray(v) for k, v in outs.items()}
    res["cn_rows"] = cn_rows.double().numpy()
    res["cn_cols"] = cn_cols.double().numpy()
    res["qres"] = qres_all
    return res


def close_bank(bank: np.ndarray, decay: float, dtype) -> np.ndarray:
    """Algorithm 2 on one bank (8, L, G+1): fold the collectors into the
    maintained statistics by prefix sums; the collectors read 0 after."""
    b = torch.as_tensor(bank, dtype=dtype)
    cum_n = torch.cumsum(b[C_N], -1)
    cum_q = torch.cumsum(b[C_Q], -1)
    span = torch.cumsum(b[C_SPAN], -1)
    zero = torch.zeros_like(cum_n)
    out = torch.stack([b[N] * decay + cum_n, b[Q] + cum_q, cum_n + cum_q,
                       b[SPANQ] + span, span, zero, zero, zero])
    return out.double().numpy()


def plan_faults(grid: np.ndarray, boxes: np.ndarray, owner: np.ndarray,
                live: np.ndarray, machines: int) -> int:
    """Violations of the plan's guarantee: every cell belongs to a live
    partition whose box holds it, each live box holds exactly its own
    cells (so the boxes tile the grid), and each live partition is owned
    by a machine of the cluster."""
    g = grid.shape[0]
    p = len(owner)
    alive = np.zeros(p, bool)
    alive[live] = True
    pid = grid.reshape(-1).astype(np.int64)
    bad = int(((pid < 0) | (pid >= p)).sum())
    pid = np.clip(pid, 0, p - 1)
    bad += int((~alive[pid]).sum())
    rr, cc = np.divmod(np.arange(g * g), g)
    b = boxes[pid]
    bad += int(((rr < b[:, 0]) | (rr > b[:, 2])
                | (cc < b[:, 1]) | (cc > b[:, 3])).sum())
    area = ((boxes[live, 2] - boxes[live, 0] + 1)
            * (boxes[live, 3] - boxes[live, 1] + 1))
    bad += int(np.abs(np.bincount(pid, minlength=p)[live] - area).sum())
    bad += int(((owner[live] < 0) | (owner[live] >= machines)).sum())
    return bad
