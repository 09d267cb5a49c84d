"""Hand-written CUDA kernels for Hopper, one package per kernel.

Each ships as ``<name>/{<name>.cu (the kernel and its plain-C
launcher), ops.py (build, bind, launch, launch count), ref.py (the
plain PyTorch version)}``.  ``ops`` launches the kernel for CUDA tensors
and runs ``ref`` for CPU tensors; the kernels are compiled with nvcc at
first use (``_build``).

- ``stats_update`` (K1): the Algorithm-2 round close.
- ``spatial_match`` (K2): inclusive point-in-rectangle join counts.
- ``keyword_match`` (K3): K2 AND a keyword conjunction over bucket masks.
- ``knn_match`` (K4): the k smallest squared distances per focus.
- ``moe_histogram`` (K5): per-expert assignment counts and gated load.
- ``flash_attention`` (K6): blocked forward attention, online softmax.
"""
from concurrent.futures import ThreadPoolExecutor


def build_all() -> None:
    """Build every kernel, one nvcc per source, all started together."""
    from .flash_attention import ops as flash_attention
    from .keyword_match import ops as keyword_match
    from .knn_match import ops as knn_match
    from .moe_histogram import ops as moe_histogram
    from .spatial_match import ops as spatial_match
    from .stats_update import ops as stats_update
    builds = [flash_attention.build, stats_update.build, spatial_match.build,
              keyword_match.build, knn_match.build, moe_histogram.build]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
