"""On the card: a short run of each cell through the command the
benchmark names, with its result line.  Skips without a card."""
import json
import os
import subprocess
import sys

import pytest

from _bench_tiny import CELLS, ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", (0, 1))
def test_short_run_on_the_card(name, traced):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with -m cuda")
    out = subprocess.run(
        [sys.executable, os.path.join("bench", "run.py"), "--workload", name,
         "--seed", str(2**31 + 3), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    if traced:
        assert res["device"]["busy_s"] > 0
