"""Isolation of the PyTorch port (``src/repro_torch``) from the JAX
package: no module of the port, nor ``chip_smoke.py``, imports ``jax``
or anything of ``repro``; importing the port's streaming package loads
neither; and every host module the port copies is textually identical
to its counterpart under ``src/repro`` — only the named rewritten files
may differ, so a parity failure can only come from them."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
REF = os.path.join(SRC, "repro")

# the host modules the port carries as file-for-file copies
COPIED = [
    "analysis/sanitizer.py",
    "core/__init__.py", "core/cost_model.py", "core/global_index.py",
    "core/integrity.py", "core/planner.py", "core/protocol.py",
    "core/statistics.py",
    "ft/__init__.py", "ft/chaos.py", "ft/coordinator.py", "ft/links.py",
    "ft/straggler.py",
    "queries/__init__.py", "queries/keywords.py", "queries/models.py",
    "queries/store.py",
    "streaming/api.py", "streaming/baselines.py", "streaming/fused.py",
    "streaming/sources.py",
    "telemetry/__init__.py", "telemetry/export.py", "telemetry/records.py",
    "telemetry/perfetto_schema.json", "telemetry/timers.py",
    "telemetry/tracer.py",
]
# files with a counterpart under src/repro that the port rewrites: the
# modules that reached JAX, the package façades, and the kernel packages
REWRITTEN = [
    "analysis/__init__.py", "core/balancer.py", "core/geometry.py",
    "streaming/__init__.py", "streaming/engine.py",
    "streaming/experiments.py", "streaming/planes.py",
    "kernels/__init__.py", "kernels/stats_update/__init__.py",
    "kernels/stats_update/ops.py", "kernels/stats_update/ref.py",
]


def _port_files(suffix=".py"):
    out = []
    for d, _, files in os.walk(PORT):
        out += [os.path.relpath(os.path.join(d, f), PORT)
                for f in files if f.endswith(suffix)]
    return sorted(out)


def _forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:                      # relative: inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return bad


@pytest.mark.parametrize("rel", _port_files() + ["../../chip_smoke.py"])
def test_no_jax_or_repro_imports(rel):
    path = os.path.normpath(os.path.join(PORT, rel))
    assert os.path.exists(path), path
    assert _forbidden_imports(path) == []


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.streaming, repro_torch.kernels, "
            "repro_torch.analysis; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_are_identical(rel):
    with open(os.path.join(PORT, rel), "rb") as a, \
            open(os.path.join(REF, rel), "rb") as b:
        assert a.read() == b.read(), f"{rel} diverged from src/repro/{rel}"


def test_every_counterpart_is_either_copied_or_named_as_rewritten():
    """A port module with a counterpart under src/repro is on exactly one
    of the two lists, so no copy can drift unnoticed."""
    shared = [r for r in _port_files() + _port_files(".json")
              if os.path.exists(os.path.join(REF, r))]
    assert sorted(shared) == sorted(COPIED + REWRITTEN)
    assert not set(COPIED) & set(REWRITTEN)
