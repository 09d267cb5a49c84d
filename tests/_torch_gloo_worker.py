"""Small sharded runs of the port on the CPU: ranks of a ``gloo`` group
over a ``FileStore``, one process each.

    python tests/_torch_gloo_worker.py MODE DIR

MODE ``microbatch``: four ranks on a 2×2 ("data", "model") mesh run one
microbatched train step (two microbatches) of the float32 qwen2-moe
smoke config sharded, and the same step unsharded; rank 0 writes both
losses and the gradients each step hands to AdamW to ``DIR/out.pt``.  ``DIR`` holds
``params.pt`` (the port's layout) and ``batch.pt``.

MODE ``scan_ops``: two ranks on a one-axis mesh run each recurrent scan
op (``models/scan_ops.py``) on inputs split along the batch and, where
its sharding rule allows it, along its channels (Mamba's ``d_inner``,
the mLSTM's heads), forward and backward; rank 0 writes the whole
outputs and gradients to ``DIR/out.pt``.  ``DIR`` holds ``inputs.pt``
(each op's inputs and output cotangents).
"""
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _microbatch(rank: int, d: str) -> None:
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, opt_state_shardings)
    from repro_torch.train import train_step as TS
    seen = []
    real = TS.adamw_update

    def spy(opt_cfg, params, grads, opt_state):
        seen.append(grads)
        return real(opt_cfg, params, grads, opt_state)

    TS.adamw_update = spy
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2_moe_a2_7b"),
                              dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    plain = torch.load(os.path.join(d, "params.pt"))
    batch = torch.load(os.path.join(d, "batch.pt"))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p_sh = SH.param_shardings(cfg, mesh)
    params = SH.shard_params(plain, p_sh, copy=True)
    opt = SH.shard_params(init_opt_state(plain),
                          opt_state_shardings(plain, p_sh, mesh), copy=True)
    dbatch = {k: SH.shard_tensor(v, SH.batch_sharding(mesh, v.dim()))
              for k, v in batch.items()}
    step = make_train_step(cfg, opt_cfg, microbatches=2,
                           constraint=SH.make_constraint(mesh))
    with implicit_replication():
        _, _, m = step(params, opt, dbatch)
        out = {"grads": T.map(SH.whole, seen[0]),
               "loss": SH.whole(m["loss"]),
               "counts": SH.whole(m["expert_counts"])}
    _, _, pm = make_train_step(cfg, opt_cfg, microbatches=2)(
        plain, init_opt_state(plain), batch)
    out.update(plain_grads=seen[1], plain_loss=pm["loss"],
               plain_counts=pm["expert_counts"])
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))


def _scan_ops(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import scan_ops as SO  # noqa: F401 (the ops)
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    cases = torch.load(os.path.join(d, "inputs.pt"))
    out = {}
    for (name, split), (args, cot) in cases.items():
        op = getattr(torch.ops.repro_torch, name)
        placed = []
        for a, dim in zip(args, split):
            pl = Replicate() if dim is None else Shard(dim)
            a = DTensor.from_local(a, mesh, (Replicate(),), run_check=False)
            a = a.redistribute(mesh, (pl,))
            placed.append(a.detach().requires_grad_(a.is_floating_point()))
        outs = op(*placed)[:len(cot)]       # ys and the last state
        loss = sum((o * DTensor.from_local(c, mesh, (Replicate(),),
                                           run_check=False)).sum()
                   for o, c in zip(outs, cot))
        grads = torch.autograd.grad(loss, placed)
        out[(name, split)] = {
            "outs": [o.full_tensor() for o in outs],
            "grads": [g.full_tensor() for g in grads],
            "placements": [str(o.placements) for o in outs]}
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))


MODES = {"microbatch": (_microbatch, 4), "scan_ops": (_scan_ops, 2)}


def _rank(rank: int, mode: str, d: str) -> None:
    torch.set_num_threads(1)
    fn, world = MODES[mode]
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    fn(rank, d)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, d = sys.argv[1], sys.argv[2]
    mp.start_processes(_rank, args=(mode, d), nprocs=MODES[mode][1],
                       start_method="spawn")
