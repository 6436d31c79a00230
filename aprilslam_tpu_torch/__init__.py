"""aprilslam_tpu_torch — the PyTorch/CUDA port of aprilslam_tpu.

The port mirrors the JAX package's module layout and public names
(``detect/threshold.py``, ``detect/segment.py``, ... ``slam/pipeline.py``) so
each module's counterpart is easy to find. Plain tensor code is PyTorch; the
connected-components labelling, the one hand-written accelerator kernel of
the detector, is CUDA C++ for Hopper (``csrc/ccl.cu``, bound in ``ops/ccl.py``).

Entry points (``TagDetector``, ``build_slam_step``, ``SlamSystem``,
``render_frames``) run on the CUDA device unless the caller passes
``device="cpu"``; plain tensor functions follow their inputs' device.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry correctness requirement, the counterpart of the JAX package's
# "highest" matmul precision: every 3x3/4x4 transform chain (rendering
# homographies, PnP, BA normal equations) needs full float32. TF32 keeps ~3
# decimal digits, which moves whole-quad corners by fractions of a pixel.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
