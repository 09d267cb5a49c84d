"""Isolation of the PyTorch port (``src/repro_torch``) from the JAX
package: no module of the port, nor ``chip_smoke.py``, imports ``jax``
or anything of ``repro``; importing the port's streaming package loads
neither; and every host module the port copies is textually identical
to its counterpart under ``src/repro`` — only the named rewritten files,
and the named definitions of the partly rewritten copies, may differ,
so a parity failure can only come from them."""
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
    "analysis/engine.py", "analysis/rules/jit_rules.py",
    "analysis/rules/precision_rules.py", "analysis/rules/purity_rules.py",
    "analysis/sanitizer.py",
    "checkpoint/__init__.py", "checkpoint/stream.py",
    "configs/__init__.py", "configs/deepseek_moe_16b.py",
    "configs/gemma_7b.py", "configs/h2o_danube_1_8b.py",
    "configs/hubert_xlarge.py", "configs/internlm2_1_8b.py",
    "configs/jamba_v0_1_52b.py", "configs/pixtral_12b.py",
    "configs/qwen2_moe_a2_7b.py", "configs/starcoder2_7b.py",
    "configs/xlstm_1_3b.py",
    "core/__init__.py", "core/cost_model.py", "core/global_index.py",
    "core/integrity.py", "core/planner.py", "core/protocol.py",
    "core/statistics.py",
    "data/__init__.py", "data/pipeline.py",
    "distributed/moe_placement.py",
    "ft/__init__.py", "ft/chaos.py", "ft/coordinator.py", "ft/links.py",
    "ft/straggler.py",
    "launch/analytic.py",
    "queries/__init__.py", "queries/keywords.py", "queries/models.py",
    "queries/store.py",
    "serve/router.py",
    "streaming/api.py", "streaming/baselines.py", "streaming/fused.py",
    "streaming/sources.py",
    "telemetry/__init__.py", "telemetry/export.py", "telemetry/records.py",
    "telemetry/perfetto_schema.json", "telemetry/timers.py",
    "telemetry/tracer.py",
]
# copies in which the port rewrites named definitions (its tracing inside
# the round, the router's query index kept between rounds, the deposits
# of every window, throttled or not: "docstring" and "import" name the
# module's own): outside them each stays identical to its counterpart
PARTLY_REWRITTEN = {
    "analysis/sanitizer.py": ("SanitizingPlane.run_window",),
    "streaming/baselines.py": ("import", "_GridRouter.__init__",
                               "_GridRouter._ensure_qres",
                               "_GridRouter._kept",
                               "_GridRouter.register_queries",
                               "_GridRouter._index_queries",
                               "_GridRouter.reindex_all_queries"),
    "telemetry/tracer.py": ("docstring", "TelemetryConfig",
                            "Tracer.__init__", "Tracer.counter",
                            "Tracer.gauge", "_NoopTracer.gauge"),
}
# files with a counterpart under src/repro that the port rewrites: the
# modules that reached JAX, the package façades, and the kernel packages
# (models/convert.py, tree.py and launch/__init__.py have no counterpart)
REWRITTEN = [
    "analysis/__init__.py", "analysis/__main__.py", "analysis/kernels.py",
    "analysis/rules/__init__.py", "core/balancer.py", "core/geometry.py",
    "streaming/__init__.py", "streaming/engine.py",
    "streaming/experiments.py", "streaming/planes.py",
    "kernels/__init__.py", "kernels/stats_update/__init__.py",
    "kernels/stats_update/ops.py", "kernels/stats_update/ref.py",
    "kernels/spatial_match/__init__.py", "kernels/spatial_match/ops.py",
    "kernels/spatial_match/ref.py",
    "kernels/keyword_match/__init__.py", "kernels/keyword_match/ops.py",
    "kernels/keyword_match/ref.py",
    "kernels/knn_match/__init__.py", "kernels/knn_match/ops.py",
    "kernels/knn_match/ref.py",
    "kernels/moe_histogram/__init__.py", "kernels/moe_histogram/ops.py",
    "kernels/moe_histogram/ref.py",
    "kernels/flash_attention/__init__.py", "kernels/flash_attention/ops.py",
    "kernels/flash_attention/ref.py",
    "models/__init__.py", "models/config.py", "models/layers.py",
    "models/model.py", "models/moe.py", "models/mamba.py",
    "models/xlstm.py",
    "serve/__init__.py", "serve/engine.py",
    "distributed/__init__.py",
    "launch/serve.py",
    "checkpoint/checkpoint.py",
    "train/__init__.py", "train/optimizer.py", "train/train_step.py",
    "launch/train.py",
    "launch/mesh.py", "streaming/sharded.py",
    "distributed/sharding.py", "launch/specs.py", "launch/roofline.py",
    "launch/dryrun.py",
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
            "repro_torch.analysis, repro_torch.models, repro_torch.serve, "
            "repro_torch.distributed, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.launch.analytic, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.train; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _without(text, names):
    """``text``'s non-blank lines less those of the named definitions
    (``Class.member`` or a top-level name; "docstring", "import")."""
    tree = ast.parse(text)
    drop = set()

    def cut(node):
        start = min([node.lineno] + [d.lineno for d in
                                     getattr(node, "decorator_list", [])])
        drop.update(range(start, node.end_lineno + 1))

    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if "import" in names:
                cut(node)
        elif node is tree.body[0] and isinstance(node, ast.Expr) \
                and isinstance(node.value, ast.Constant):
            if "docstring" in names:
                cut(node)
        elif getattr(node, "name", None) in names:
            cut(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if f"{node.name}.{getattr(sub, 'name', '')}" in names:
                    cut(sub)
    return [line for i, line in enumerate(text.splitlines(), 1)
            if i not in drop and line.strip()]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_are_identical(rel):
    with open(os.path.join(PORT, rel), "rb") as a, \
            open(os.path.join(REF, rel), "rb") as b:
        port, ref = a.read(), b.read()
    if rel in PARTLY_REWRITTEN:
        names = PARTLY_REWRITTEN[rel]
        port, ref = (_without(t.decode(), names) for t in (port, ref))
    assert port == ref, f"{rel} diverged from src/repro/{rel}"


@pytest.mark.parametrize("rel", sorted(PARTLY_REWRITTEN))
def test_partly_rewritten_copies_differ_only_where_named(rel):
    """Each named definition is there to differ: the port's or the
    reference's text of it is not the other's."""
    with open(os.path.join(PORT, rel)) as a, open(os.path.join(REF, rel)) as b:
        port, ref = a.read(), b.read()
    assert port != ref
    for name in PARTLY_REWRITTEN[rel]:
        rest = tuple(n for n in PARTLY_REWRITTEN[rel] if n != name)
        assert _without(port, rest) != _without(ref, rest), name


def test_every_counterpart_is_either_copied_or_named_as_rewritten():
    """A port module with a counterpart under src/repro is on exactly one
    of the two lists, so no copy can drift unnoticed."""
    shared = [r for r in _port_files() + _port_files(".json")
              if os.path.exists(os.path.join(REF, r))]
    assert sorted(shared) == sorted(COPIED + REWRITTEN)
    assert not set(COPIED) & set(REWRITTEN)
