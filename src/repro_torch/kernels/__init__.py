"""Hand-written CUDA kernels for Hopper, one package per kernel.

Each ships as ``<name>/{<name>.cu (the kernel and its plain-C
launcher), ops.py (build, bind, launch, launch count), ref.py (the
plain PyTorch version)}``.  ``ops`` launches the kernel for CUDA tensors
and runs ``ref`` for CPU tensors; the kernels are compiled with nvcc at
first use (``_build``).
"""
from concurrent.futures import ThreadPoolExecutor


def build_all() -> None:
    """Build every kernel, one nvcc per source, all started together."""
    from .stats_update import ops as stats_update
    builds = [stats_update.build]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
