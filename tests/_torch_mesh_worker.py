"""The port's sharded path on a real 2×2 ("data", "model") mesh: four
processes on the CPU, a ``gloo`` group over a ``FileStore``.

    python tests/_torch_mesh_worker.py DIR

``DIR`` holds what the caller wrote: ``<arch>.pt`` (float32 smoke
parameters in the port's layout), ``tokens.npy``, ``train_batch.pt`` and
a one-device checkpoint under ``ckpt/``.  Each rank runs, for every
arch, the forward and a prefill + two decode steps sharded (parameters
by ``param_shardings``, the cache by ``cache_shardings``, the batch
over "data", ``make_constraint`` on) and unsharded; one train step
(ZeRO-1 optimizer state) sharded and unsharded; and the elastic restore
of the checkpoint onto the mesh.  Rank 0 writes ``out.pt`` with each
result's whole tensors, for the caller to hold against each other and
against the JAX package.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("internlm2_1_8b", "qwen2_moe_a2_7b", "jamba_v0_1_52b")
WORLD = 4
PROMPT, DECODES, MAX_SEQ = 8, 2, 12


def _f32_smoke(arch):
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32")


def _serve(params, cfg, tokens, cache, constraint=None):
    """Prefill logits and DECODES teacher-forced decode steps' logits."""
    from repro_torch.models import model as M
    logits, cache, _ = M.prefill(params, cfg, token_ids=tokens[:, :PROMPT],
                                 max_seq=MAX_SEQ, cache=cache,
                                 constraint=constraint)
    out = [logits]
    for i in range(DECODES):
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        logits, cache, _ = M.decode_step(params, cfg, cache, tok,
                                         constraint=constraint)
        out.append(logits)
    return out


def _rank(rank: int, d: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import checkpoint as CKPT
    from repro_torch import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.engine import cache_shardings
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, opt_state_shardings)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cons = SH.make_constraint(mesh)
    tokens = torch.from_numpy(np.load(os.path.join(d, "tokens.npy")))
    b = tokens.shape[0]
    out = {}
    with torch.no_grad():
        for arch in ARCHS:
            cfg = _f32_smoke(arch)
            params = torch.load(os.path.join(d, f"{arch}.pt"))
            placed = SH.shard_params(params, SH.param_shardings(cfg, mesh))
            toks = SH.shard_tensor(tokens, SH.batch_sharding(mesh, 2))
            with implicit_replication():
                logits, _ = M.forward(placed, cfg, token_ids=toks,
                                      constraint=cons)
                cache = SH.shard_params(
                    M.init_cache(cfg, b, MAX_SEQ, device="cpu"),
                    cache_shardings(cfg, mesh, b, MAX_SEQ))
                served = _serve(placed, cfg, toks, cache, cons)
            out[arch] = {
                "forward": SH.whole(logits),
                "forward_plain": M.forward(params, cfg, token_ids=tokens)[0],
                "serve": [SH.whole(t) for t in served],
                "serve_plain": _serve(params, cfg, tokens, None),
            }

    # one train step, ZeRO-1 state, against the same step unsharded
    cfg = _f32_smoke("internlm2_1_8b")
    batch = torch.load(os.path.join(d, "train_batch.pt"))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    plain = M.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    p_sh = SH.param_shardings(cfg, mesh)
    o_sh = opt_state_shardings(plain, p_sh, mesh)
    params = SH.shard_params(plain, p_sh, copy=True)
    opt = SH.shard_params(init_opt_state(plain), o_sh, copy=True)
    dbatch = {k: SH.shard_tensor(v, SH.batch_sharding(mesh, v.dim()))
              for k, v in batch.items()}
    step = make_train_step(cfg, opt_cfg, constraint=cons)
    with implicit_replication():
        params, opt, metrics = step(params, opt, dbatch)
        train = {"params": T.map(SH.whole, params),
                 "loss": SH.whole(metrics["loss"]),
                 "m_placements": [str(t.placements) for t in
                                  opt["m"]["layers"][0]["ffn"].values()]}
    plain_opt = init_opt_state(plain)
    plain, _, pm = make_train_step(cfg, opt_cfg)(plain, plain_opt, batch)
    train.update(plain_params=plain, plain_loss=pm["loss"])
    out["train"] = train

    # elastic restore of the one-device checkpoint onto the mesh
    from repro_torch.models import abstract_params
    restored, _, manifest = CKPT.restore(
        os.path.join(d, "ckpt"), 1, abstract_params=abstract_params(cfg),
        cfg=cfg, device="cpu", param_shardings=p_sh)
    local = restored["layers"][0]["ffn"]["w_up"]
    out["restore"] = {
        "params": T.map(SH.whole, restored),
        "manifest": manifest,
        "w_up_local": tuple(local.to_local().shape),
        "w_up_global": tuple(local.shape),
        "placements": str(local.placements)}
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(_rank, args=(sys.argv[1],), nprocs=WORLD,
                       start_method="spawn")
