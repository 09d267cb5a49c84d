"""Serving launcher: prefill + decode loop with SWARM request routing.

The JAX package's ``launch/serve.py`` on PyTorch.  Admits a stream of
sessions, routes them across replica groups with the SWARM protocol
(sessions = continuous queries over hash space), runs batched prefill
and greedy decode on the local replica (attention on kernel K6, the MoE
expert histogram on K5), and rebalances every decode step — the
serving-side integration of DESIGN.md §4.  For MoE archs the per-step
expert histograms also drive SWARM expert placement
(``distributed.ExpertBalancer``), whose plan is reported, not applied.

Usage (on the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \
      --smoke --sessions 64 --steps 16 [--replicas 4] [--device cpu]

:func:`serve` runs the same flow and returns its numbers;
:func:`serve_config` runs it on a ``ModelConfig`` the caller built.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .. import configs
from ..distributed import ExpertBalancer
from ..models import init_params
from ..models.config import ModelConfig
from ..models.model import decode_step, prefill
from ..serve import SwarmRequestRouter
from ..telemetry.timers import Stopwatch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str = "internlm2_1_8b", *, smoke: bool = False,
          sessions: int = 64, prompt_len: int = 32, steps: int = 16,
          replicas: int = 4, seed: int = 0, device="cuda",
          log=print) -> dict:
    """Admit ``sessions``, prefill replica 0's batch of ``prompt_len``
    random tokens and decode ``steps`` tokens greedily (``steps − 1``
    decode calls after the prefill), routing and rebalancing every step;
    ``log`` gets the lines the command prints.  Host seconds are taken
    with the device drained.  :func:`serve_config` with ``arch``'s
    config (its smoke config if ``smoke``)."""
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    return serve_config(cfg, sessions=sessions, prompt_len=prompt_len,
                        steps=steps, replicas=replicas, seed=seed,
                        device=device, log=log)


def serve_config(cfg: ModelConfig, *, sessions: int = 64,
                 prompt_len: int = 32, steps: int = 16, replicas: int = 4,
                 seed: int = 0, device="cuda", log=print) -> dict:
    """:func:`serve`'s flow on the model ``cfg`` (a config of
    ``configs``, or one cut from it)."""
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode path")
    with Stopwatch() as sw_init:
        params = init_params(cfg, seed, device=device)
        _sync(device)
    rng = np.random.default_rng(seed)

    router = SwarmRequestRouter(num_replicas=replicas, beta=4)
    ids = np.arange(sessions)
    assignment = router.admit(ids)
    spread = np.bincount(assignment, minlength=replicas).tolist()
    log(f"[serve] {cfg.name}: {sessions} sessions across {replicas} "
        f"replicas (initial spread: {spread})")

    # the local replica executes the batch assigned to replica 0
    local = ids[assignment == 0]
    if len(local) == 0:
        local = ids[:1]
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (len(local), prompt_len)).astype(np.int32)
    ).to(device)
    max_seq = prompt_len + steps
    with Stopwatch() as sw:
        logits, cache, aux = prefill(params, cfg, token_ids=prompts,
                                     max_seq=max_seq)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        finite = torch.isfinite(logits).all()
        _sync(device)
    prefill_s = sw.s
    log(f"[serve] prefill {tuple(prompts.shape)} in {prefill_s:.2f}s")

    counts = [aux["expert_counts"]]
    rebalances = 0
    sw = Stopwatch().start()
    out = [tok]
    for step in range(steps - 1):
        logits, cache, aux = decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        finite = finite & torch.isfinite(logits).all()
        counts.append(aux["expert_counts"])
        out.append(tok)
        router.step_tokens(local)           # SWARM decode-load accounting
        rep = router.rebalance()
        if rep.action != "none":
            rebalances += 1
            log(f"[serve]   round {step}: SWARM {rep.action} "
                f"(m_H={rep.m_h} → m_L={rep.m_l})")
    toks = torch.cat(out, 1)
    _sync(device)
    decode_s = sw.stop().s
    log(f"[serve] decoded {toks.shape[0]}×{toks.shape[1]} tokens in "
        f"{decode_s:.2f}s ({toks.numel() / decode_s:.0f} tok/s on this "
        f"host)")
    loads = router.replica_loads()
    cv = float(loads.std() / (loads.mean() + 1e-9))
    log(f"[serve] replica load CV = {cv:.3f}")

    result = {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "sessions": sessions, "replicas": replicas,
        "initial_spread": spread, "batch": len(local),
        "prompt_len": prompt_len, "steps": steps, "max_seq": max_seq,
        "decode_calls": steps - 1, "init_s": sw_init.s,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_tokens": int(toks.numel()),
        "decode_tok_per_s": toks.numel() / decode_s,
        "logits_finite": bool(finite), "tokens": toks.cpu().numpy(),
        "rebalances": rebalances, "replica_load_cv": cv}
    if cfg.moe is not None:
        # SWARM-EP on the per-call expert histograms (K5's counts)
        shards = math.gcd(cfg.moe.num_experts, replicas)
        ep = ExpertBalancer(cfg.moe.num_experts, shards)
        per_call = torch.stack(counts).cpu().numpy()
        for c in per_call[1:]:
            ep.update(c)
        result.update(expert_counts=per_call, ep_shards=shards,
                      ep_moves=ep.moves,
                      ep_imbalance=ep.imbalance(per_call[-1]))
        log(f"[serve] SWARM-EP over {shards} expert shards: {ep.moves} "
            f"swaps, last-step imbalance {result['ep_imbalance']:.3f}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sessions", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    serve(args.arch, smoke=args.smoke, sessions=args.sessions,
          prompt_len=args.prompt_len, steps=args.steps,
          replicas=args.replicas, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
