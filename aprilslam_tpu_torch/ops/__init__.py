"""Hand-written CUDA kernels of the port and their wrappers: the detector's
connected-component labelling (with its plain version) and the chaining
graph's per-chunk scan (whose plain version is ``slam/graph.py``'s loop)."""

from .ccl import build_ccl, connected_components, connected_components_plain

__all__ = ["build_ccl", "connected_components", "connected_components_plain"]
