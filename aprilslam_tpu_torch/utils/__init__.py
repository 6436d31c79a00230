"""Runtime helpers. The JAX package's ``configure_runtime`` maps to
:func:`resolve_device`: the CUDA device unless the caller asks for the CPU,
and an error, never a fallback, without one. The role of its compilation
cache is played by the CCL kernel's build cache under ``build/``."""

from ..device import resolve_device
from .checkpoint import CheckpointManager
from .profiling import SpanRecorder, span, trace

__all__ = [
    "CheckpointManager",
    "SpanRecorder",
    "span",
    "trace",
    "resolve_device",
]
