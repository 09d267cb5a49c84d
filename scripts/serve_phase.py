"""Phase ``serve`` of ``chip_smoke.py`` alone, from a given checkout.

    python3 scripts/serve_phase.py CHECKOUT

Runs the ``chip_smoke.py`` and ``src/repro_torch`` of CHECKOUT (the
repository root, or a commit unpacked with ``git archive`` under the
gitignored ``_checkout/``) on one CUDA card: builds kernels K5 and K6,
then serves qwen2-moe-a2.7b at full width and depth as phase ``serve``
does, and prints its JSON line.  Run it for two commits in turns in one
call (parent, change, change, parent) to compare them on one card.
"""
import os
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import keyword_match as KM
    from repro_torch.kernels import knn_match as KN
    from repro_torch.kernels import moe_histogram as MH
    from repro_torch.kernels import spatial_match as SM
    from repro_torch.kernels import stats_update as SU
    from repro_torch.launch import serve as LS
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    if not torch.cuda.is_available():
        sys.exit("serve_phase: needs a CUDA card")
    print("checkout", root, flush=True)
    FA.ops.build()
    MH.ops.build()
    kern = {"stats_update": SU, "spatial_match": SM, "keyword_match": KM,
            "knn_match": KN, "moe_histogram": MH, "flash_attention": FA}
    C.phase_serve(torch, kern, LS, L, MOE, torch.device("cuda"))


if __name__ == "__main__":
    main()
