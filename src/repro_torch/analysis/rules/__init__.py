"""swarmlint rule registry (DESIGN.md §13 catalogs each invariant): the
JAX package's six rules, copied, and SWM006's PyTorch form
(``torch_precision_rules``), which checks the modules that import
``torch``."""
from .jit_rules import JitRecompileHazard, TracedSideEffects
from .precision_rules import LowPrecisionCountMatmul
from .purity_rules import (FrozenEventAssignment, GlobalStateRNG,
                           WallClockOutsideTimers)
from .torch_precision_rules import TorchCountMatmul


def default_rules():
    return [JitRecompileHazard(), TracedSideEffects(), GlobalStateRNG(),
            FrozenEventAssignment(), WallClockOutsideTimers(),
            LowPrecisionCountMatmul(), TorchCountMatmul()]


__all__ = ["default_rules", "JitRecompileHazard", "TracedSideEffects",
           "GlobalStateRNG", "FrozenEventAssignment",
           "WallClockOutsideTimers", "LowPrecisionCountMatmul",
           "TorchCountMatmul"]
