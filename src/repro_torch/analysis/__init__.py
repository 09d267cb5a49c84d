"""Runtime protocol sanitizer (the port's copy of the JAX package's
``analysis.sanitizer``): a wrapping ``DataPlane`` plus engine hooks
(``EngineConfig(sanitize=True)`` / ``REPRO_SANITIZE=1``) asserting the
paper's §5 conservation laws every round, ASAN-style.  The static lint
rules and the Pallas signature checker of the JAX package are not part
of the port."""
from .sanitizer import ProtocolSanitizer, SanitizerError, SanitizingPlane

__all__ = ["ProtocolSanitizer", "SanitizerError", "SanitizingPlane"]
