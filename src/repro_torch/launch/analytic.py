"""Structure-aware analytic FLOPs/bytes accounting per (arch × shape).

Why this exists: XLA's ``cost_analysis`` counts a ``while`` body once,
so any scanned program (layers, CE chunks, attention chunks) is
undercounted by its trip count (verified in tests/test_dryrun_small.py).
The roofline compute/memory terms therefore come from this analytic
model — exact einsum accounting per layer family — while the compiled
artifact still supplies the collective schedule and the memory fit.
The dry-run records both and their ratio, so the undercount is visible
rather than hidden.

Conventions:
 * matmul (M, K)×(K, N): 2·M·K·N flops.
 * attention scores/AV over context C: 2·T·H·Dh·C each (full C for
   decode; C/2 average for causal training; min(C, window) for SWA).
 * training flops = 3× forward (bwd = 2× fwd); full-remat (policy
   "nothing") adds one forward recompute → 4× total, reported as
   ``remat_factor``.
 * bytes: parameter traffic (fwd read + bwd read + grad write + Adam
   read/write of p/m/v fp32), activation carry traffic per layer, KV/
   state cache read+write for decode, logits and embedding traffic.
   Attention score matrices contribute **no** HBM bytes (flash/
   chunked execution keeps them in VMEM).
"""
from __future__ import annotations

from ..models.config import ModelConfig
from ..models.model import num_periods, period_pattern


def _attn_flops(cfg: ModelConfig, t: int, ctx: float) -> float:
    d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    proj = 2 * t * d * (h * dh + 2 * hkv * dh) + 2 * t * h * dh * d
    scores = 2 * t * h * dh * ctx * 2          # QKᵀ and PV
    return proj + scores


def _mlp_flops(cfg: ModelConfig, t: int, d_ff: int) -> float:
    n_mat = 3 if cfg.act in ("silu", "gelu_glu") else 2
    return 2 * t * cfg.d_model * d_ff * n_mat


def _moe_flops(cfg: ModelConfig, t: int) -> float:
    m = cfg.moe
    routed = 2 * t * cfg.d_model * m.d_ff_expert * 3 * m.top_k
    shared = 2 * t * cfg.d_model * m.shared_ff * 3 * m.num_shared
    router = 2 * t * cfg.d_model * m.num_experts
    return routed + shared + router


def _mamba_flops(cfg: ModelConfig, t: int) -> float:
    m = cfg.mamba
    d = cfg.d_model
    di = m.expand * d
    dtr = m.dt_rank or (d + 15) // 16
    proj = 2 * t * d * 2 * di + 2 * t * di * d
    conv = 2 * t * di * m.d_conv
    ssm_proj = 2 * t * di * (dtr + 2 * m.d_state) + 2 * t * dtr * di
    scan = 6 * t * di * m.d_state               # state update + output
    return proj + conv + ssm_proj + scan


def _mlstm_flops(cfg: ModelConfig, t: int) -> float:
    x = cfg.xlstm
    d = cfg.d_model
    up = int(d * x.proj_factor)
    dqk = int(up * x.qk_dim_factor)
    proj = 2 * t * d * 2 * up + 2 * t * up * d + 2 * t * up * up
    qkv = 2 * t * up * (2 * dqk + up)
    recur = 3 * t * dqk * up + 2 * t * dqk * up  # C update + readout
    return proj + qkv + recur


def _slstm_flops(cfg: ModelConfig, t: int) -> float:
    d = cfg.d_model
    dh = d // cfg.num_heads
    gates = 4 * 2 * t * d * d
    mix = 4 * 2 * t * d * dh
    return gates + mix + 2 * t * d * d


def flops_per_token_layer(cfg: ModelConfig, mixer: str, ffn, ctx: float):
    f = {"attn": lambda: _attn_flops(cfg, 1, ctx),
         "mamba": lambda: _mamba_flops(cfg, 1),
         "mlstm": lambda: _mlstm_flops(cfg, 1),
         "slstm": lambda: _slstm_flops(cfg, 1)}[mixer]()
    if ffn == "mlp":
        f += _mlp_flops(cfg, 1, cfg.d_ff)
    elif ffn == "moe":
        f += _moe_flops(cfg, 1)
    return f


def analytic_cost(cfg: ModelConfig, kind: str, batch: int, seq: int,
                  *, remat: str = "nothing") -> dict:
    """Returns dict with flops (total, per step) and bytes (total)."""
    if kind == "train":
        t = batch * seq
        ctx = (min(seq, cfg.sliding_window) if cfg.sliding_window
               else seq / 2)          # causal average
    elif kind == "prefill":
        t = batch * seq
        ctx = (min(seq, cfg.sliding_window) if cfg.sliding_window
               else seq / 2)
    else:  # decode: 1 token against a seq-long cache
        t = batch
        ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq

    pat = period_pattern(cfg)
    n_per = num_periods(cfg)
    fwd = sum(flops_per_token_layer(cfg, mixer, ffn, ctx)
              for mixer, ffn in pat) * n_per * t
    fwd += 2 * t * cfg.d_model * cfg.vocab_size          # lm head
    params = cfg.param_count()

    if kind == "train":
        remat_factor = 4 / 3 if remat == "nothing" else 1.0
        flops = 3 * fwd * remat_factor
    else:
        remat_factor = 1.0
        flops = fwd

    # ---- bytes ----
    d = cfg.d_model
    act_bytes_layer = 6 * t * d * 2                       # carry in/out + resid
    n_layers = cfg.num_layers
    if kind == "train":
        param_traffic = params * (4 + 4 + 4 + 12 * 2)     # fwd+bwd reads, grad w, adam rw of p/m/v
        act_traffic = act_bytes_layer * n_layers * 3      # fwd + recompute + bwd
        logits_traffic = 2 * t * cfg.vocab_size * 2       # bf16 chunked, w+r
        cache_traffic = 0
    elif kind == "prefill":
        param_traffic = params * 2                        # bf16 weight reads
        act_traffic = act_bytes_layer * n_layers
        logits_traffic = 2 * batch * cfg.vocab_size * 2
        cache_traffic = _cache_bytes(cfg, batch, seq)     # cache write
    else:
        param_traffic = params * 2
        act_traffic = act_bytes_layer * n_layers
        logits_traffic = 2 * batch * cfg.vocab_size * 2
        cache_traffic = _cache_bytes(cfg, batch, seq) * 1  # full cache read
    embed_traffic = t * d * 2 * 2
    total_bytes = (param_traffic + act_traffic + logits_traffic
                   + cache_traffic + embed_traffic)
    return {
        "flops": float(flops),
        "fwd_flops": float(fwd),
        "bytes": float(total_bytes),
        "param_traffic": float(param_traffic),
        "cache_traffic": float(cache_traffic),
        "remat_factor": remat_factor,
        "tokens": t,
    }


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Decode-state bytes (read per decode step / written by prefill)."""
    pat = period_pattern(cfg)
    n_per = num_periods(cfg)
    total = 0.0
    for mixer, _ in pat:
        if mixer == "attn":
            ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
            total += 2 * batch * ctx * cfg.num_kv_heads * cfg.resolved_head_dim * 2
        elif mixer == "mamba":
            m = cfg.mamba
            total += batch * m.expand * cfg.d_model * m.d_state * 4
        elif mixer == "mlstm":
            x = cfg.xlstm
            up = int(cfg.d_model * x.proj_factor)
            dqk = int(up * x.qk_dim_factor)
            total += batch * dqk * up * 4
        elif mixer == "slstm":
            total += 4 * batch * cfg.d_model * 4
    return total * n_per
