"""Training launcher on PyTorch: the JAX package's ``launch/train.py``.

Wires the substrate together: config → mesh → float32 master weights
and AdamW state, sharded → prefetched data → train step (remat +
microbatching + optional SWARM-EP placement, attention on K6 and the
MoE expert histogram on K5) → periodic checkpoints → crash-safe resume.
It runs on the card unless ``--device cpu`` is given; without a card it
raises.

``--mesh-shape DxM`` (or PxDxM) runs one process per rank of a
("data", "model") (or ("pod", "data", "model")) mesh: the caller starts
the processes with the usual ``torch.distributed`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK`` — what
``torchrun`` sets), and the mesh's size must equal ``WORLD_SIZE``.
``1x1`` needs no environment: the launcher starts a one-rank group
itself.  Parameters are placed by ``distributed.sharding``'s rules,
AdamW's m and v ZeRO-1 sharded over "data", the batch split over the
data axes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
      --steps 8 --batch 4 --seq 2048 [--smoke] [--ckpt-dir DIR] [--resume] \
      [--device cpu] [--mesh-shape 1x1]

:class:`Trainer` is the same flow a step at a time, for callers that
time or check it.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os

import numpy as np
import torch

from .. import checkpoint as CKPT
from .. import configs
from .. import tree as T
from ..data import PrefetchIterator, make_batch_iterator
from ..distributed import ExpertBalancer
from ..distributed import sharding as SH
from ..ft import StragglerMitigator
from ..models import abstract_params, init_params
from ..telemetry.timers import Stopwatch
from ..train import (AdamWConfig, abstract_opt_state, init_opt_state,
                     make_train_step, opt_state_shardings)
from .mesh import make_mesh, parse_mesh_shape


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: train on the card, or pass "
                           "--device cpu")
    return device


def mesh_from_flag(text: str, device: torch.device):
    """The ``--mesh-shape`` mesh over this process's group: one rank a
    process, the group started from the ``torch.distributed``
    environment the caller set (a one-rank group here for ``1x1``).
    A mesh whose size is not ``WORLD_SIZE`` raises."""
    import torch.distributed as dist
    dims, axes = parse_mesh_shape(text)
    ranks = math.prod(dims)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks != world:
        raise SystemExit(
            f"--mesh-shape {text}: the mesh has {ranks} ranks but "
            f"WORLD_SIZE is {world}; start one process per rank (e.g. "
            f"torchrun --nproc-per-node {ranks}), which sets WORLD_SIZE, "
            f"RANK, MASTER_ADDR and MASTER_PORT")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if world == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            dist.init_process_group(backend)
    return make_mesh(dims, axes, device.type)


class Trainer:
    """One training run: parameters, optimizer state, the train step,
    the data stream and (MoE) the expert balancer with its placement.
    With a ``mesh`` the parameters are placed by
    ``sharding.param_shardings``, the optimizer state by
    ``opt_state_shardings`` (ZeRO-1), each batch split over the data
    axes, and the step runs with the mesh's activation constraint; every
    rank draws the same stream and keeps its piece."""

    def __init__(self, cfg, *, batch: int, seq: int, steps: int,
                 lr: float = 3e-3, remat: str = "dots_no_batch",
                 microbatches: int = 1, seed: int = 0, device="cuda",
                 mesh=None):
        self.cfg, self.batch, self.seq, self.mesh = cfg, batch, seq, mesh
        self.device = _device(device) if isinstance(device, str) else device
        self.balancer = (ExpertBalancer(cfg.moe.num_experts,
                                        min(8, cfg.moe.num_experts))
                         if cfg.moe else None)
        self.params = init_params(cfg, seed, device=self.device,
                                  dtype=torch.float32)
        self.opt = init_opt_state(self.params)
        constraint = None
        if mesh is not None:
            self.param_sh = SH.param_shardings(cfg, mesh)
            self.opt_sh = opt_state_shardings(self.params, self.param_sh,
                                              mesh)
            self.params = SH.shard_params(self.params, self.param_sh,
                                          copy=True)
            self.opt = SH.shard_params(self.opt, self.opt_sh, copy=True)
            constraint = SH.make_constraint(mesh)
        opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
        self.step_fn = make_train_step(cfg, opt_cfg, remat=remat,
                                       microbatches=microbatches,
                                       constraint=constraint)
        self.placement = (torch.arange(cfg.moe.num_experts,
                                       dtype=torch.int32, device=self.device)
                          if cfg.moe else None)
        self.straggler = StragglerMitigator(num_hosts=1)
        self.data = PrefetchIterator(make_batch_iterator(cfg, batch, seq,
                                                         seed=seed))
        self.swaps = []   # the balancer's swaps, one list a step

    def next_batch(self) -> dict:
        """The data stream's next batch, on the run's device (split over
        the mesh's data axes)."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in next(self.data).items()}
        if self.mesh is None:
            return batch
        return {k: SH.shard_tensor(v, SH.batch_sharding(self.mesh, v.dim()))
                for k, v in batch.items()}

    def _sharded(self):
        """Plain tensors (positions, masks, the rate) meet DTensors as
        replicated ones in a sharded run."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        return implicit_replication()

    def step(self, batch: dict | None = None) -> dict:
        """One train step on ``batch`` (the stream's next by default);
        returns its metrics as tensors.  An MoE run hands the step's
        expert counts to the balancer and installs its placement after
        swaps — routing-table only, the paper's "move the queries, not
        the data"."""
        batch = self.next_batch() if batch is None else batch
        with self._sharded():
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch, self.placement)
            metrics = T.map(SH.whole, metrics)
        if self.balancer is not None:
            rep = self.balancer.update(
                metrics["expert_counts"].cpu().numpy())
            self.swaps.append(rep["swaps"])
            if rep["swaps"]:
                self.placement = torch.as_tensor(
                    np.asarray(self.balancer.placement), dtype=torch.int32,
                    device=self.device)
        return metrics

    def save(self, ckpt_dir: str, step: int) -> str:
        return CKPT.save(ckpt_dir, step, params=self.params,
                         opt_state=self.opt, config_name=self.cfg.name,
                         cfg=self.cfg, mesh=self.mesh)

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        """Load a checkpoint (the latest committed one by default) in
        place of the run's parameters and optimizer state; returns its
        step."""
        step = CKPT.latest_step(ckpt_dir) if step is None else step
        self.params = self.opt = None      # free the card first
        aps = abstract_params(self.cfg)
        sharded = self.mesh is not None
        self.params, self.opt, _ = CKPT.restore(
            ckpt_dir, step, abstract_params=aps,
            abstract_opt=abstract_opt_state(aps), cfg=self.cfg,
            device=self.device,
            param_shardings=self.param_sh if sharded else None,
            opt_shardings=self.opt_sh if sharded else None)
        return step

    def close(self) -> None:
        self.data.close()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", default="dots_no_batch")
    ap.add_argument("--mesh-shape", default=None, help="e.g. 2x4")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    device = _device(args.device)
    mesh = mesh_from_flag(args.mesh_shape, device) if args.mesh_shape else None
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch {args.batch}×{args.seq}, "
          f"mesh={args.mesh_shape or '1 dev'} ({device})")

    run = Trainer(cfg, batch=args.batch, seq=args.seq, steps=args.steps,
                  lr=args.lr, remat=args.remat,
                  microbatches=args.microbatches, seed=args.seed,
                  device=device, mesh=mesh)
    start = 0
    if args.resume and args.ckpt_dir and CKPT.latest_step(args.ckpt_dir):
        start = run.restore(args.ckpt_dir)
        print(f"[train] resumed from step {start}")

    sw, tokens = Stopwatch().start(), 0
    for step in range(start, args.steps):
        metrics = run.step()
        tokens += args.batch * args.seq
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"tok/s={tokens / sw.stop().s:.0f}"
                  + (f" EP-moves={run.balancer.moves}" if run.balancer
                     else ""))
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            run.save(args.ckpt_dir, step)
    if args.ckpt_dir:
        run.save(args.ckpt_dir, args.steps)
        print(f"[train] final checkpoint at step {args.steps}")
    run.close()


if __name__ == "__main__":
    main()
