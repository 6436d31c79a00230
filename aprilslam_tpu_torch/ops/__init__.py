"""Hand-written CUDA kernels of the detection hot path, with their plain versions."""

from .ccl import build_ccl, connected_components, connected_components_plain

__all__ = ["build_ccl", "connected_components", "connected_components_plain"]
