"""Roofline terms of a traced dry-run cell, against one NVIDIA H100.

The JAX package's ``launch/roofline.py``.  Three terms per (arch × shape
× mesh), all in seconds, per device:

  compute    = analytic FLOPs / (chips × PEAK_FLOPS)
  memory     = analytic bytes / (chips × HBM_BW)
  collective = collective bytes per device / LINK_BW

The compute and memory terms come from ``launch.analytic`` (the
reference's choice, since XLA's cost analysis undercounts scanned
bodies).  The collective term comes from the functional collectives the
traced step ran on rank 0's shards (``specs.TraceCounters``), each sized
by its tensors — the twin of the reference's parse of the partitioned
HLO: an all-gather by what a device receives (its output), an
all-reduce, reduce-scatter or all-to-all by its input.  The traced FLOPs
(``torch.utils.flop_counter``'s formulas on rank 0's local operations,
the kernels' own formulas included) are recorded beside the analytic
count, per device.

What XLA's compile gives the reference and nothing here reproduces is
named in each record (:data:`NO_TWIN`), never filled in.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet (dense, no sparsity, 700 W)
PEAK_FLOPS = 989e12      # bf16 tensor-core FLOP/s per device
HBM_BW = 3.35e12         # HBM3 bytes/s per device
LINK_BW = 450e9          # NVLink 4 bytes/s per device, each direction

# the reference's fields that come from XLA's compiled artifact
NO_TWIN = {
    "roofline": ["xla_flops_per_device", "xla_bytes_per_device",
                 "xla_flops_undercount",
                 "collectives from the partitioned HLO text (here: the "
                 "traced functional collectives)"],
    "memory": ["output_bytes", "temp_bytes", "alias_bytes", "code_bytes",
               "peak_hbm_bytes (XLA's buffer assignment; here: "
               "eager_peak_bytes)"],
}


def roofline_terms(counters, num_chips: int, analytic: dict) -> dict:
    """The three terms of a cell traced with ``counters`` on a mesh of
    ``num_chips`` devices, its compute and memory from ``analytic``
    (``launch.analytic.analytic_cost``)."""
    flops_dev = analytic["flops"] / num_chips
    bytes_dev = analytic["bytes"] / num_chips
    coll = dict(counters.collective_bytes)
    coll_total = float(sum(coll.values()))
    terms = {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "traced_flops_per_device": counters.flops,
        "collective_bytes_per_device": coll_total,
        "collectives": coll,
        "collective_op_count": sum(counters.collective_ops.values()),
        "collective_ops": dict(counters.collective_ops),
        "t_compute": flops_dev / PEAK_FLOPS,
        "t_memory": bytes_dev / HBM_BW,
        "t_collective": coll_total / LINK_BW,
        "no_twin": NO_TWIN["roofline"],
    }
    dominant = max(("t_compute", "t_memory", "t_collective"),
                   key=lambda k: terms[k])
    terms["dominant"] = dominant.replace("t_", "")
    # roofline fraction: useful model flops over the bound implied by the
    # dominant term (what fraction of peak the step could reach)
    t_star = max(terms[dominant], 1e-30)
    terms["step_time_bound_s"] = t_star
    terms["achievable_flops_frac"] = min(1.0, terms["t_compute"] / t_star)
    return terms


def memory_stats(cell, counters) -> dict:
    """Per-device bytes: the arguments' shards by group (exact), and
    ``eager_peak_bytes`` — the arguments plus the most fake storage the
    traced step held at once on rank 0, as eager PyTorch would allocate
    it (no compiler's reuse or fusion)."""
    args = sum(cell.arg_bytes.values())
    return {
        "argument_bytes": args,
        "argument_bytes_by_group": dict(cell.arg_bytes),
        "eager_peak_bytes": args + counters.peak,
        "no_twin": NO_TWIN["memory"],
    }


def model_flops(cfg, kind: str, tokens: int) -> dict:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    n_total = cfg.param_count()
    n_active = active_param_count(cfg)
    factor = 6 if kind == "train" else 2
    return {
        "params_total": n_total,
        "params_active": n_active,
        "model_flops": factor * n_active * tokens,
        "factor": factor,
    }


def active_param_count(cfg) -> int:
    """Parameter count with routed experts scaled by top_k/num_experts."""
    from ..models import layers as L
    from ..models import model as M
    total = 0
    for path, lf in L.spec_items(M.param_spec(cfg)):
        n = math.prod(lf["shape"])
        if (cfg.moe is not None and L.P.EXPERT in lf["axes"]
                and "router" not in path):
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total
