"""A run loads neither JAX nor the JAX package (top-level module names
compared whole: ``repro_torch`` is not ``repro``), and the plain
reference loads nothing of the program."""
import os
import subprocess
import sys

from _bench_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _run(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [BENCH, os.path.join(BENCH, "tests"), os.path.join(ROOT, "src")]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    return set(out.stdout.split())


def test_run_loads_no_jax():
    mods = _run("from _bench_tiny import tiny_cell\n"
                "from harness import run_cell\n"
                "assert run_cell(tiny_cell('range-hotspot'), 1, 0.2, True,"
                " 'cpu')['correct']\n")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _run("import check\nfrom reference import swarm_ref\n"
                "from traffic import stream\nimport readings, peaks\n")
    assert "repro_torch" not in mods
    assert not mods & FORBIDDEN
