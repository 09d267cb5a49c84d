"""Device meshes: the sharded streaming plane's shard devices and the
LM package's ``("data", "model")`` meshes.

:func:`streaming_mesh` is the port's counterpart of the reference's
``streaming_mesh``: the devices of the ``("machines",)`` axis that
``streaming.sharded.ShardedTorchPlane`` spreads SWARM's machines over,
one ``torch.device`` per shard.  Where the reference forces host
devices (``force_host_device_count``) to run D shards on one CPU, this
module *colocates*: ``colocate=True`` places D shards round-robin over
the visible cards, each shard with buffers of its own, and the CPU is
always one device holding every shard.

The LM half — :func:`make_mesh`, :func:`make_production_mesh`,
:func:`data_parallel_size` — builds ``torch.distributed``
``DeviceMesh``es over the default process group, one rank a process
(the caller starts the processes and the group).  The dry run traces
the 16×16 and 2×16×16 production meshes in one process on a ``"fake"``
group of as many ranks (:func:`fake_world`), the port's stand-in for
the reference's ``force_host_device_count``.  Code that reads a mesh's
axis sizes by name (``mesh.shape["model"]`` in the reference) reads
:func:`mesh_shape`, which takes a ``DeviceMesh`` or any object with a
``shape`` dict and ``axis_names`` (``jax.sharding.AbstractMesh``)."""
from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# LM meshes
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """Start a ``"fake"`` process group of ``n`` ranks in this process
    (rank 0), for tracing a mesh of ``n`` devices without them: its
    collectives return at once and move nothing.  The port's stand-in
    for the reference's ``force_host_device_count``.  A default group
    of ``n`` ranks already there is kept; one of another size raises —
    a process has one default group, so fake worlds of different sizes
    run in separate processes."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"fake_world({n}): a default process group of "
                f"{dist.get_world_size()} ranks exists; run each world "
                f"size in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, whose size must be the product of
    ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh{shape}: no process group; start one "
                           f"of {math.prod(shape)} ranks (or fake_world "
                           f"to trace)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: 16×16 = 256 devices ("data", "model").
    Multi-pod: 2×16×16 = 512 devices ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def parse_mesh_shape(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"2x4"`` → ((2, 4), ("data", "model")); three sizes name the axes
    ("pod", "data", "model"), as the reference's launchers read
    ``--mesh-shape``."""
    dims = tuple(int(x) for x in text.lower().split("x"))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh-shape {text!r}: two or three sizes, "
                         f"e.g. 2x4 or 2x2x2")
    return dims, (("data", "model") if len(dims) == 2
                  else ("pod", "data", "model"))


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """Axis name → size, for a ``DeviceMesh`` or a stand-in with a
    ``shape`` dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def data_parallel_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return shape.get("pod", 1) * shape.get("data", 1)
