"""Connected-component labelling, detector stage 2
(port of ``aprilslam_tpu/detect/segment.py``).

A CUDA tensor goes to the hand-written kernel (``csrc/ccl.cu``), a CPU tensor
to the plain version; both give the converged labels — the minimum linear
index of each 4-connected same-colour component, sentinel ``H*W`` for
unknown pixels. The reference's fixed relaxation schedules (``scan_iters``,
``rounds``) have no counterpart: the labelling always converges.
"""

from ..ops.ccl import connected_components, connected_components_plain

__all__ = ["connected_components", "connected_components_plain"]
