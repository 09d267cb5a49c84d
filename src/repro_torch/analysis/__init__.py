"""swarmlint — repo-native static analysis + runtime protocol sanitizer,
the port's twin of the JAX package's ``analysis``.

* :mod:`repro_torch.analysis.engine` + :mod:`repro_torch.analysis.rules`
  — the AST lint pass with the SWARM rules SWM001–SWM006 (copies of the
  JAX package's) and SWM006's PyTorch form: no count matmul in torch
  code that TF32 could round, and TF32 never turned on under ``src/``.
* :mod:`repro_torch.analysis.kernels` — the kernel signature checker:
  every kernel entry point and its ``ref.py`` twin run under
  ``FakeTensorMode`` across a shape/dtype grid (the entries on fake CUDA
  tensors, through their ops' fake implementations), their output
  structures, shapes and types diffed (no device, no data).
* :mod:`repro_torch.analysis.sanitizer` — a wrapping ``DataPlane`` plus
  engine hooks (``EngineConfig(sanitize=True)`` / ``REPRO_SANITIZE=1``)
  asserting the paper's §5 conservation laws every round, ASAN-style.

CLI: ``python -m repro_torch.analysis [paths...] [--format=github]``.
"""
from .engine import LintEngine, Violation, lint_paths
from .sanitizer import ProtocolSanitizer, SanitizerError, SanitizingPlane

__all__ = ["LintEngine", "Violation", "lint_paths",
           "ProtocolSanitizer", "SanitizerError", "SanitizingPlane"]
