"""Multi-device dry run: trace every (arch × shape × mesh) cell on fake
tensors over a fake process group.

The JAX package's ``launch/dryrun.py``.  For each cell: the production
mesh (16×16 = 256 or 2×16×16 = 512 devices, or ``--mesh-shape``) over a
``"fake"`` process group of as many ranks in this one process
(``mesh.fake_world``), the cell's arguments as DTensors of fake shards
(``specs.build_cell``; CUDA ones where PyTorch is built with CUDA, no
card needed — :func:`fake_device`), and its step run once
(``specs.trace_cell``) — the twin of the reference's
``jit(step).lower(...).compile()``.  The record, one JSON file a cell
(``{arch}__{shape}__{mesh}.json``), holds per device the arguments'
shard bytes and an eager peak, the analytic and the traced FLOPs, the
collective bytes by kind, the roofline terms against one H100
(``launch.roofline``) and the K5/K6 op calls; the reference's fields
that come from XLA's compile are named under ``no_twin``, not faked.

A process has one default process group, so all the cells of one run
share one mesh size: ``--both-meshes`` traces the multi-pod mesh in a
child process.  ``--layout tp_unroll`` is ``tp``: the port's decode
already runs its layers as a Python loop, which is what the reference's
unroll gives.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma_7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts]
  python -m repro_torch.launch.dryrun --arch internlm2_1_8b \\
      --shape train_4k --mesh-shape 2x4
"""
import argparse
import json
import math
import os
import subprocess
import sys
import traceback

from .. import configs
from ..telemetry.timers import Stopwatch
from . import roofline as RL
from .mesh import fake_world, make_mesh, parse_mesh_shape


def run_one(arch: str, shape: str, *, multi_pod: bool, out_dir: str,
            mesh_dims=None, remat: str = "nothing", zero1: bool = True,
            microbatches: int = 2, layout: str = "tp", tag: str = "") -> dict:
    from .analytic import analytic_cost
    from .specs import build_cell, trace_cell
    sw = Stopwatch().start()
    if mesh_dims is None:
        mesh_dims = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                     else ((16, 16), ("data", "model")))
    dims, axes = mesh_dims
    chips = math.prod(dims)
    mesh_name = "x".join(str(s) for s in dims)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
           "multi_pod": multi_pod, "remat": remat, "zero1": zero1, "tag": tag}
    try:
        ok, why = configs.shape_supported(configs.get_config(arch), shape)
        if not ok:
            rec.update(status="skip", reason=why)
            return _emit(rec, out_dir)
        cfg = configs.get_config(arch)
        kind, seq, batch = configs.SHAPES[shape]
        mb = microbatches if kind == "train" else 1
        fake_world(chips)
        rec["fake_device"] = fake_device()
        mesh = make_mesh(dims, axes, device=rec["fake_device"])
        cell = build_cell(arch, shape, mesh, remat=remat, zero1=zero1,
                          microbatches=mb, layout=layout)
        rec["microbatches"] = mb
        rec["layout"] = layout
        rec["build_s"] = round(sw.stop().s, 1)
        sw_t = Stopwatch().start()
        counters = trace_cell(cell)
        rec["trace_s"] = round(sw_t.stop().s, 1)
        rec["memory"] = RL.memory_stats(cell, counters)
        ana = analytic_cost(cfg, cell.kind, batch, seq, remat=remat)
        rec["analytic"] = ana
        rec["roofline"] = RL.roofline_terms(counters, chips, analytic=ana)
        rec["model"] = RL.model_flops(cfg, cell.kind, cell.tokens_per_step)
        rec["model"]["useful_fraction"] = (
            rec["model"]["model_flops"] / ana["flops"]
            if ana["flops"] else 0.0)
        rec["kernel_calls"] = dict(counters.kernel_calls)
        rec["tokens_per_step"] = cell.tokens_per_step
        rec["kind"] = cell.kind
        rec["status"] = "ok"
        print(f"[dryrun] {arch} × {shape} × {mesh_name}: OK "
              f"(build {rec['build_s']}s, trace {rec['trace_s']}s, "
              f"args {rec['memory']['argument_bytes']/2**30:.2f} GiB/dev, "
              f"eager peak "
              f"{rec['memory']['eager_peak_bytes']/2**30:.2f} GiB/dev, "
              f"dominant={rec['roofline']['dominant']})")
    except Exception as e:  # noqa: BLE001 — a failing cell is a finding
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} × {shape} × {mesh_name}: FAIL {e}")
    return _emit(rec, out_dir)


def fake_device() -> str:
    """The device type of the fake shards: CUDA where PyTorch is built
    with it (no card is needed), else the CPU — a build without CUDA
    cannot index a fake CUDA tensor.  A CPU mesh redistributes an
    all-to-all as an all-gather and a chunk, which the record's
    collectives then show."""
    import torch
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _emit(rec: dict, out_dir: str) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"_{rec['tag']}" if rec.get("tag") else ""
        path = os.path.join(
            out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--remat", default="nothing", choices=["none", "dots",
                                                        "dots_no_batch",
                                                        "nothing"])
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--layout", default="tp",
                    choices=["tp", "tp_zero3", "fsdp", "dp", "tp_unroll"])
    ap.add_argument("--mesh-shape", default=None,
                    help="debug mesh, e.g. 2x4 (axes data,model) or 2x2x2")
    args = ap.parse_args()

    mesh_dims = parse_mesh_shape(args.mesh_shape) if args.mesh_shape else None
    archs = configs.ARCH_IDS if args.arch in (None, "all") else [args.arch]
    shapes = list(configs.SHAPES) if args.shape in (None, "all") else [args.shape]
    cells = ([(a, s) for a in configs.ARCH_IDS for s in configs.SHAPES]
             if args.all else [(a, s) for a in archs for s in shapes])
    layout = "tp" if args.layout == "tp_unroll" else args.layout
    n_ok = n_fail = n_skip = 0
    for arch, shape in cells:
        rec = run_one(arch, shape, multi_pod=args.multi_pod and
                      not args.both_meshes, out_dir=args.out,
                      mesh_dims=mesh_dims, remat=args.remat,
                      zero1=not args.no_zero1, tag=args.tag,
                      microbatches=args.microbatches, layout=layout)
        n_ok += rec["status"] == "ok"
        n_fail += rec["status"] == "fail"
        n_skip += rec["status"] == "skip"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    child = 0
    if args.both_meshes:
        argv = [a for a in sys.argv[1:] if a != "--both-meshes"]
        child = subprocess.run([sys.executable, "-m",
                                "repro_torch.launch.dryrun", *argv,
                                "--multi-pod"]).returncode
    if n_fail or child:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
