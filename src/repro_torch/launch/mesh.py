"""Device placement for the sharded streaming data plane.

:func:`streaming_mesh` is the port's counterpart of the reference's
``streaming_mesh``: the devices of the ``("machines",)`` axis that
``streaming.sharded.ShardedTorchPlane`` spreads SWARM's machines over,
one ``torch.device`` per shard.  Where the reference forces host
devices (``force_host_device_count``) to run D shards on one CPU, this
module *colocates*: ``colocate=True`` places D shards round-robin over
the visible cards, each shard with buffers of its own, and the CPU is
always one device holding every shard.

The reference's LM-mesh half — ``force_host_device_count``,
``make_mesh``, ``make_production_mesh`` and ``data_parallel_size`` — is
about XLA device flags and the 16×16 TPU meshes of the sharded LM
specs; it waits for the port's sharding and dry-run slice (ROADMAP
Queue 1 item 9e)."""
from __future__ import annotations

import torch


def streaming_mesh(devices: int | None = None, device="cuda", *,
                   colocate: bool = False) -> tuple[torch.device, ...]:
    """The shard devices of the sharded streaming plane.

    ``device="cuda"`` returns the first ``devices`` visible cards (all
    of them by default); asking for more shards than cards raises
    ``ValueError`` unless ``colocate=True``, which places the shards
    round-robin over the cards.  No CUDA device at all raises
    ``RuntimeError`` — the plane never moves to the CPU by itself.
    ``device="cpu"`` is one device, so its shards are always colocated
    (one shard by default)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),) * _count(devices, 1)
    if kind != "cuda":
        raise ValueError(f"streaming_mesh: unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("the sharded data plane on device='cuda' needs "
                           "a CUDA device; pass device='cpu' to run its "
                           "shards on the host")
    visible = torch.cuda.device_count()
    d = _count(devices, visible)
    if d > visible and not colocate:
        raise ValueError(
            f"streaming_mesh: {d} shards requested but only {visible} CUDA "
            f"device(s) visible; pass colocate=True to place several "
            f"shards on one card")
    return tuple(torch.device("cuda", k % visible) for k in range(d))


def _count(devices: int | None, default: int) -> int:
    d = default if devices is None else int(devices)
    if d < 1:
        raise ValueError(f"streaming_mesh: {d} shards requested")
    return d
