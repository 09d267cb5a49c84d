"""Fake-tensor stand-ins + shardings for every (arch × shape) cell.

The JAX package's ``launch/specs.py``.  :func:`build_cell` returns what
the dry run needs to trace one cell: the step function (positional args
only) and its arguments as DTensors on the mesh whose local shards are
fake tensors (``FakeTensorMode``: shapes, types and devices, no
storage), each placed by the cell's layout.  The shards are built with
``DTensor.from_local`` from their local shapes, not by
``distribute_tensor`` (which copies a whole tensor, and cannot on a
fake CUDA tensor in a build without CUDA).  :func:`trace_cell`, the twin
of ``lower_cell``, runs the step once under that fake mode with
:class:`TraceCounters`: XLA's compile has no twin here, so what the
step does is counted op by op on rank 0's shards.

Argument types are the port's: serving cells (prefill, decode) hold the
weights as ``init_params`` gives them (the compute type, float32 router,
norms and recurrence constants), training cells float32 masters, as in
the reference.  A decode cell's cache has its offset at ``seq − 1``:
the new token attends over a seq-long cache.  A prefill cell's cache is
allocated before the step and filled by it (the port's ``prefill``
takes it), so it counts with the arguments.
"""
from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import configs
from .. import tree as T
from ..distributed import sharding as SH
from ..models import abstract_cache, abstract_params
from ..models import layers as L
from ..models import model as MODEL
from ..models.model import keeps_float32
from ..serve.engine import cache_shardings
from ..train import AdamWConfig, make_train_step, opt_state_shardings


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str                  # train | prefill | decode
    fn: object                 # step function (positional args)
    args: tuple                # DTensor arguments over fake shards
    mode: object               # the FakeTensorMode the shards live in
    tokens_per_step: int
    arg_bytes: dict = field(default_factory=dict)   # per device, by group


def _fake_dtensor(shape, dtype, sharding, mode):
    """A DTensor of global ``shape`` with ``sharding`` whose local shard
    is a fake tensor of the shape ``sharding`` gives this rank."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    local = SH.local_shard(torch.empty(shape, device="meta"), sharding)
    with mode:
        fake = torch.empty(local.shape, dtype=dtype,
                           device=mesh.device_type)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(fake, mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _place(tree, shardings, mode):
    """Fake DTensors for a tree of meta tensors, each leaf placed by its
    sharding."""
    def one(t, sh):
        if not isinstance(t, torch.Tensor):
            return t
        return _fake_dtensor(t.shape, t.dtype, sh, mode)
    return SH.map_placed(one, tree, shardings)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every DTensor in ``tree``."""
    return sum(t.to_local().numel() * t.element_size()
               for t in T.leaves(tree) if isinstance(t, torch.Tensor))


def _serving_types(cfg):
    """``abstract_params`` with each leaf in the type ``init_params``
    stores it: the compute type, float32 where the model keeps it."""
    dt = L.compute_dtype(cfg)
    out = MODEL.empty_params(cfg)
    n_pos = len(MODEL.period_pattern(cfg))
    for path, lf in L.spec_items(MODEL.param_spec(cfg)):
        keep = torch.float32 if keeps_float32(path) else dt
        one = lf["shape"][1:] if path[0] == "blocks" else lf["shape"]
        for i in range(lf["shape"][0] if path[0] == "blocks" else 1):
            MODEL.place(out, path, torch.empty(one, dtype=keep,
                                               device="meta"), n_pos, i)
    return out


def _batch(cfg, batch: int, seq: int, mesh, mode, *, labels: bool):
    if cfg.frontend is not None:
        shapes = {"embeds": ((batch, seq, cfg.d_model), torch.bfloat16)}
    else:
        shapes = {"tokens": ((batch, seq), torch.int32)}
    if labels:
        shapes["labels"] = ((batch, seq), torch.int32)
    return {k: _fake_dtensor(s, dt, SH.batch_sharding(mesh, len(s)), mode)
            for k, (s, dt) in shapes.items()}


def _model_inputs(batch_dict):
    if "embeds" in batch_dict:
        return {"embeds": batch_dict["embeds"]}
    return {"token_ids": batch_dict["tokens"]}


def build_cell(arch: str, shape_name: str, mesh, *, remat: str = "nothing",
               zero1: bool = True, microbatches: int = 1,
               layout: str = "tp") -> Cell:
    """layout: "tp" (default TP+DP), "tp_zero3" (TP + fully-sharded fp32
    masters), "fsdp" (pure DP, weights gathered per use), "dp" (weights
    replicated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_config(arch)
    kind, seq, batch = configs.SHAPES[shape_name]
    ok, why = configs.shape_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"skip {arch}×{shape_name}: {why}")
    if layout == "fsdp":
        constraint = SH.make_constraint(mesh, SH.FSDP_RULES)
        p_sh = SH.param_shardings_fsdp(cfg, mesh)
    elif layout == "dp":
        constraint = SH.make_constraint(mesh, SH.DP_RULES)
        p_sh = SH.param_shardings_replicated(cfg, mesh)
    else:
        constraint = SH.make_constraint(mesh)
        p_sh = SH.param_shardings(cfg, mesh, zero3=(layout == "tp_zero3"))
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    if kind == "train":
        p_abs = abstract_params(cfg)
        o_sh = (p_sh if layout in ("fsdp", "tp_zero3")
                else opt_state_shardings(p_abs, p_sh, mesh, zero1=zero1)
                ["m"])
        params = _place(p_abs, p_sh, mode)
        opt = {"m": _place(p_abs, o_sh, mode),
               "v": _place(p_abs, o_sh, mode),
               "count": _fake_dtensor((), torch.int32, SH.replicated(mesh),
                                      mode)}
        b = _batch(cfg, batch, seq, mesh, mode, labels=True)
        step = make_train_step(cfg, AdamWConfig(), constraint=constraint,
                               remat=remat, microbatches=microbatches)
        return Cell(arch, shape_name, kind, step, (params, opt, b), mode,
                    batch * seq, {"params": _local_bytes(params),
                                  "opt": _local_bytes(opt),
                                  "batch": _local_bytes(b)})

    params = _place(_serving_types(cfg), p_sh, mode)
    if kind == "prefill":
        b = _batch(cfg, batch, seq, mesh, mode, labels=False)
        if cfg.encoder_only:
            def prefill_step(params, batch_dict):
                logits, _ = MODEL.forward(params, cfg, constraint=constraint,
                                          **_model_inputs(batch_dict))
                return logits
            return Cell(arch, shape_name, kind, prefill_step, (params, b),
                        mode, batch * seq, {"params": _local_bytes(params),
                                            "batch": _local_bytes(b)})
        cache = _place(abstract_cache(cfg, batch, seq),
                       cache_shardings(cfg, mesh, batch, seq), mode)

        def prefill_step(params, batch_dict, cache):
            logits, cache, _ = MODEL.prefill(params, cfg, max_seq=seq,
                                             constraint=constraint,
                                             cache=cache,
                                             **_model_inputs(batch_dict))
            return logits, cache
        return Cell(arch, shape_name, kind, prefill_step, (params, b, cache),
                    mode, batch * seq, {"params": _local_bytes(params),
                                        "batch": _local_bytes(b),
                                        "cache": _local_bytes(cache)})

    # decode: one new token against a seq-long cache
    cache = _place(abstract_cache(cfg, batch, seq),
                   cache_shardings(cfg, mesh, batch, seq), mode)
    cache["offset"] = seq - 1
    tok = _fake_dtensor((batch, 1), torch.int32,
                        SH.batch_sharding(mesh, 2) if batch > 1
                        else SH.replicated(mesh), mode)

    def serve_step(params, cache, token_ids):
        logits, new_cache, _ = MODEL.decode_step(params, cfg, cache,
                                                 token_ids,
                                                 constraint=constraint)
        return logits, new_cache

    return Cell(arch, shape_name, kind, serve_step, (params, cache, tok),
                mode, batch, {"params": _local_bytes(params),
                              "cache": _local_bytes(cache),
                              "batch": _local_bytes(tok)})


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

_FUNCOL = torch.ops._c10d_functional
# functional collective → (kind, the bytes a device moves: its output
# for an all-gather, what it receives; its input for the others)
COLLECTIVES = {
    _FUNCOL.all_gather_into_tensor: ("all-gather", "out"),
    _FUNCOL.all_reduce: ("all-reduce", "in"),
    _FUNCOL.reduce_scatter_tensor: ("reduce-scatter", "in"),
    _FUNCOL.all_to_all_single: ("all-to-all", "in"),
}
# the port's kernel ops, counted by call
KERNEL_OPS = {"flash_attention": "repro_torch::flash_attention",
              "moe_histogram": "repro_torch::moe_histogram"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class TraceCounters(TorchDispatchMode):
    """Counts what a traced step does on rank 0's shards: operations by
    ``torch.utils.flop_counter``'s formulas (the kernel ops' included),
    the bytes and calls of each kind of functional collective, the
    calls of the kernel ops, and the bytes of fake storage alive at
    once (each new storage held from its first tensor's creation to that
    tensor's release: an eager peak, not a compiler's schedule).  DTensor
    operations pass through to the local operations they run as.
    DTensor also runs each new (op, layout) once on whole-shape fake
    tensors to learn its output's shape, re-entering ``fake_mode``;
    those runs are not rank 0's work and are not counted."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.collective_bytes: Counter = Counter()
        self.collective_ops: Counter = Counter()
        self.kernel_calls: Counter = Counter()
        self.live = self.peak = 0
        self._storages: set = set()
        self._kernels = {getattr(torch.ops.repro_torch, name): name
                         for name in KERNEL_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if len(self.fake_mode.enter_stack) > 1:    # a shape propagation
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if packet in COLLECTIVES:
            kind, side = COLLECTIVES[packet]
            self.collective_bytes[kind] += _nbytes(
                out if side == "out" else args[0])
            self.collective_ops[kind] += 1
        if packet in self._kernels:
            self.kernel_calls[self._kernels[packet]] += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t._base is None:
                self._hold(t)
        return out

    def _hold(self, t):
        key = t.untyped_storage()._cdata
        if key in self._storages:
            return
        n = t.untyped_storage().nbytes()
        self._storages.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, key, n)

    def _release(self, key, n):
        self._storages.discard(key)
        self.live -= n


def trace_cell(cell: Cell) -> TraceCounters:
    """Run the cell's step once in its fake mode, under
    ``implicit_replication`` (plain tensors the model makes meet the
    DTensors as replicated ones), counted by :class:`TraceCounters`."""
    from torch.distributed.tensor.experimental import implicit_replication
    counters = TraceCounters(cell.mode)
    with cell.mode, implicit_replication(), counters:
        out = cell.fn(*cell.args)
        del out
    return counters
