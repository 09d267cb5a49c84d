"""The port's ``analysis`` twin against the JAX package's, on the CPU.

The lint engine and the SWM001–SWM006 rules are byte copies
(``tests/test_torch_isolation.py``): on ``tests/test_analysis.py``'s
fire and clean snippets the port's ``lint_paths`` gives the JAX
package's findings.  SWM006's PyTorch form (``torch_precision_rules``)
fires on count matmuls in torch code and on TF32 turned on under
``src/``, and stays quiet on the exact idioms.  The port's source tree
lints clean and its CLI exits 0.  The kernel signature checker traces
the 19 entry/ref pairs under ``FakeTensorMode`` (the entries on fake
CUDA tensors) with no mismatch, catches a seeded mismatch, and each
entry's signature equals the JAX checker's at the same grid point."""
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import kernels as RK
from repro.analysis.engine import lint_paths as ref_lint_paths
from repro_torch.analysis import kernels as PK
from repro_torch.analysis import lint_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# tests/test_analysis.py's snippets: (name, file, code, rule, fires)
SNIPPETS = [
    ("swm001_jit_in_loop", "snippet.py", """\
import jax
def run(fns, xs):
    for f in fns:
        g = jax.jit(f)
        g(xs)
""", "SWM001", True),
    ("swm001_inline_jit_call", "snippet.py", """\
import jax
def f(x):
    return jax.jit(lambda y: y + 1)(x)
""", "SWM001", True),
    ("swm001_cached_jit", "snippet.py", """\
import jax
class Plane:
    def __init__(self):
        self._jit_tuple = jax.jit(self._tuple_fn)
    def _tuple_fn(self, x):
        return x * 2
    def run(self, xs):
        for x in xs:               # calling a cached jit in a loop is fine
            self._jit_tuple(x)
""", "SWM001", False),
    ("swm002_clock_in_jitted_body", "snippet.py", """\
import time
import jax
@jax.jit
def step(x):
    t = time.time()
    return x + t
""", "SWM002", True),
    ("swm002_rng_in_scan_body", "snippet.py", """\
import numpy as np
from jax import lax
def window(xs):
    def body(carry, x):
        noise = np.random.rand()
        return carry + x + noise, x
    return lax.scan(body, 0.0, xs)
""", "SWM002", True),
    ("swm002_print_in_shard_map_ref", "snippet.py", """\
from jax.experimental.shard_map import shard_map
def build(mesh, specs):
    def inner(x):
        print("tracing", x.shape)
        return x * 2
    return shard_map(inner, mesh=mesh, in_specs=specs, out_specs=specs)
""", "SWM002", True),
    ("swm002_effects_outside_traced_body", "snippet.py", """\
import jax
@jax.jit
def step(x):
    return x * 2
def wrapper(x):
    out = step(x)
    print("done", out.shape)       # host side: fine
    return out
""", "SWM002", False),
    ("swm003_global_rng", "snippet.py", """\
import numpy as np
xs = np.random.rand(100)
np.random.seed(0)
""", "SWM003", True),
    ("swm003_threaded_generator", "snippet.py", """\
import numpy as np
rng = np.random.default_rng(42)
xs = rng.random(100)
""", "SWM003", False),
    ("swm004_event_assignment", "snippet.py", """\
from repro.streaming.api import TupleBatch
def resend(xy):
    b = TupleBatch(xy)
    b.tick = 1                     # frozen!
    return b
""", "SWM004", True),
    ("swm004_setattr_bypass_and_annotation", "snippet.py", """\
from repro.streaming.api import MachineFailure
def patch(ev: MachineFailure):
    ev.machine = 3
    object.__setattr__(ev, "machine", 7)
""", "SWM004", True),
    ("swm004_replace", "snippet.py", """\
from dataclasses import replace
from repro.streaming.api import TupleBatch
def rebase(b: TupleBatch, t):
    other = {"tick": t}
    other["tick"] = t + 1          # plain dict/subscript writes stay legal
    return replace(b, xy=b.xy)
""", "SWM004", False),
    ("swm004_local_frozen_dataclass", "snippet.py", """\
from dataclasses import dataclass
@dataclass(frozen=True)
class Snapshot:
    tick: int
def bump():
    s = Snapshot(0)
    s.tick = 1
""", "SWM004", True),
    ("swm005_raw_clock", "snippet.py", """\
import time
t0 = time.time()
t1 = time.perf_counter()
""", "SWM005", True),
    ("swm005_suppression_pragma", "snippet.py", """\
import time
t0 = time.time()  # swarmlint: disable=SWM005
""", "SWM005", False),
    ("swm006_bare_matmul_on_counts", "kernels/histo/ops.py", """\
import jax.numpy as jnp
def contract(hist, onehot):
    return hist @ onehot.T
""", "SWM006", True),
    ("swm006_highest_precision", "kernels/histo/ops.py", """\
import jax
import jax.numpy as jnp
def contract(hist, onehot):
    return jnp.matmul(hist, onehot.T,
                      precision=jax.lax.Precision.HIGHEST)
""", "SWM006", False),
    ("swm006_ignores_noncount_operands", "kernels/attn/ops.py", """\
import jax.numpy as jnp
def attn(q, k):
    return q @ k.T                 # weights/activations: bf16 is fine
""", "SWM006", False),
    ("swm006_host_numpy_outside_kernels", "snippet.py", """\
import numpy as np
def host_side(hist, onehot):
    return hist @ onehot.T         # host numpy: exact, exempt
""", "SWM006", False),
]


def _write(tmp_path, name, code):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    return str(p)


def _rules(violations):
    return [(v.rule, v.line, v.col) for v in violations]


@pytest.mark.parametrize("name,file,code,rule,fires", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_lint_equals_the_jax_package_on_its_fixtures(tmp_path, name, file,
                                                     code, rule, fires):
    path = _write(tmp_path, file, code)
    got = _rules(lint_paths([path]))
    assert got == _rules(ref_lint_paths([path]))
    assert (rule in [r for r, _, _ in got]) == fires


TORCH_SNIPPETS = [
    ("matmul_on_counts", "src/pkg/plane.py", """\
import torch
def contract(hist, onehot):
    return hist @ onehot.T
""", 1),
    ("einsum_and_bmm_on_masks", "src/pkg/plane.py", """\
import torch
def join(masks, counts, x):
    a = torch.einsum("nt,qt->nq", masks, x)
    return torch.bmm(counts, x), a
""", 2),
    ("allow_tf32_on", "src/pkg/setup.py", """\
import torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
""", 2),
    ("matmul_precision_high", "src/pkg/setup.py", """\
import torch
torch.set_float32_matmul_precision("high")
torch.set_float32_matmul_precision("medium")
torch.backends.cuda.matmul.fp32_precision = "tf32"
""", 3),
    ("weights_and_tf32_off", "src/pkg/plane.py", """\
import torch
def attn(q, k):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return q @ k.T
""", 0),
    ("exact_site_with_pragma", "src/pkg/plane.py", """\
import torch
def miss(inv, masks):
    # 0/1 operands, float32 accumulate: exact in TF32
    return inv @ masks.T  # swarmlint: disable=SWM006
""", 0),
    ("numpy_module_without_torch", "src/pkg/host.py", """\
import numpy as np
def host_side(hist, onehot):
    return hist @ onehot.T
""", 0),
    ("tf32_outside_src", "scripts/bench.py", """\
import torch
torch.backends.cuda.matmul.allow_tf32 = True
""", 0),
]


@pytest.mark.parametrize("name,file,code,n", TORCH_SNIPPETS,
                         ids=[s[0] for s in TORCH_SNIPPETS])
def test_torch_swm006_fires_and_stays_clean(tmp_path, name, file, code, n):
    got = [v.rule for v in lint_paths([_write(tmp_path, file, code)])]
    assert got == ["SWM006"] * n


def test_the_port_lints_clean():
    assert lint_paths([os.path.join(SRC, "repro_torch")]) == []


def test_cli_exits_clean_with_19_signature_checks():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         os.path.join("src", "repro_torch")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[swarmlint] 0 violation(s)" in proc.stderr
    assert ("[swarmlint] kernel signatures: 19 checked, 0 mismatch(es)"
            in proc.stderr)


def test_cli_flags_violations(tmp_path):
    bad = _write(tmp_path, "src/bad.py",
                 "import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", bad, "--no-kernels",
         "--format=github"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 1
    assert "::error" in proc.stdout and "SWM006" in proc.stdout


def test_kernel_signatures_match():
    report = PK.check_kernel_signatures()
    assert report.checked == 19
    assert report.ok, "\n".join(m.text() for m in report.mismatches)


def test_kernel_checker_catches_seeded_mismatch():
    def entry(x):
        return torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)

    def ref_transposed(x):                 # wrong shape
        return torch.zeros(x.shape[1], dtype=torch.int32)

    def ref_dtype(x):                      # wrong dtype
        return torch.zeros(x.shape[0], dtype=torch.float32)

    def entry_on_host(x):                  # leaves the card
        return torch.zeros(x.shape[0], dtype=torch.int32, device="cpu")

    spec = [(PK.Spec((8, 3), torch.float32),)]
    report = PK.check_kernel_signatures([
        PK.KernelCase("seeded.shape", entry, ref_transposed, spec),
        PK.KernelCase("seeded.dtype", entry, ref_dtype, spec),
        PK.KernelCase("seeded.device", entry_on_host, entry, spec),
    ])
    assert len(report.mismatches) == 3
    assert {m.case for m in report.mismatches} == {
        "seeded.shape", "seeded.dtype", "seeded.device"}


_DTYPES = {"float32": torch.float32, "int32": torch.int32,
           "bfloat16": torch.bfloat16}


def test_each_entry_signature_equals_the_jax_checkers():
    """Case for case and grid point for grid point, the port's entry
    gives the JAX entry's output shapes and types."""
    ref_cases = RK.default_cases()
    port_cases = PK.default_cases()
    assert [c.name for c in port_cases] == [c.name for c in ref_cases]
    n = 0
    for pc, rc in zip(port_cases, ref_cases):
        assert len(pc.arg_grids) == len(rc.arg_grids), pc.name
        for pargs, rargs in zip(pc.arg_grids, rc.arg_grids):
            assert [(tuple(a.shape), a.dtype) for a in pargs] == \
                [(tuple(a.shape), _DTYPES[str(a.dtype)]) for a in rargs]
            _, psig, _ = PK._signature(pc.entry, pargs, PK.ENTRY_DEVICE)
            _, rsig = RK._signature(rc.entry, rargs)
            assert [(s, d.replace("torch.", "")) for s, d in psig] == rsig, \
                pc.name
            n += 1
    assert n == 19
