"""TagDetector: the end-to-end batched detection pipeline
(port of ``aprilslam_tpu/detect/detector.py``).

threshold -> connected components (the CUDA kernel on the card) -> boundary
clustering -> quad fit -> decode -> full-resolution edge refinement, batched
over frames.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device
from ..families import TagFamily, get_family
from ..utils.profiling import span
from .decode import Detections, FamilyTensors, decode_quads
from .quads import quad_candidates
from .refine import refine_corners
from .segment import connected_components
from .threshold import adaptive_threshold_with_levels, decimate, to_grayscale


@dataclass(frozen=True)
class DetectorParams:
    """Static pipeline configuration.

    ``scan_iters``/``jump_iters`` are kept so parameter sets carry over from
    the JAX package; the port's labelling always converges and ignores them.
    """

    quad_decimate: int = 2
    tile: int = 4
    min_contrast: float = 0.08
    scan_iters: int = 4
    jump_iters: int = 2
    max_clusters: int = 128
    max_quads: int = 32
    pts_per_quad: int = 128
    min_cluster_pts: int = 20
    min_side: float = 3.0
    refine_iters: int = 2
    max_fit_err: float = 0.8
    max_hamming: int = 3
    min_level_contrast: float = 0.06
    max_detections: int = 32
    max_boundary: int = 16384
    refine_edges: bool = True
    refine_samples: int = 12
    refine_range: float = 2.0


def detect_fn(family: str | TagFamily = "tagStandard41h12",
              params: DetectorParams | None = None,
              device: str | torch.device | None = None):
    """Build ``f(frames) -> Detections``; the family tensors live on ``device``
    (``None``: the CUDA device) and the frames must too."""
    device = resolve_device(device)
    fam = get_family(family) if isinstance(family, str) else family
    ft = FamilyTensors(fam, device=device)
    p = params or DetectorParams()

    def run(frames: torch.Tensor) -> Detections:
        # One span per stage, as the JAX detector's named scopes; the
        # profilers group device time by them.
        with span("stage_threshold"):
            gray = to_grayscale(frames)
            dec = decimate(gray, p.quad_decimate)
            trinary, level = adaptive_threshold_with_levels(dec, tile=p.tile, min_contrast=p.min_contrast)
        with span("stage_ccl"):
            labels = connected_components(trinary.contiguous())
        with span("stage_quads"):
            quads = quad_candidates(
                trinary, labels, dec, p.quad_decimate, level,
                max_clusters=p.max_clusters,
                max_quads=p.max_quads,
                pts_per_quad=p.pts_per_quad,
                min_cluster_pts=p.min_cluster_pts,
                min_side=p.min_side,
                refine_iters=p.refine_iters,
                max_fit_err=p.max_fit_err,
                max_boundary=p.max_boundary,
            )
        with span("stage_decode"):
            det = decode_quads(
                gray, quads, ft,
                max_hamming=p.max_hamming,
                min_level_contrast=p.min_level_contrast,
                max_detections=p.max_detections,
            )
        if p.refine_edges and p.quad_decimate > 1:
            with span("stage_refine"):
                refined = refine_corners(gray, det.corners, det.valid,
                                         ns=p.refine_samples, half_range=p.refine_range)
            det = replace(det, corners=refined)
        return det

    return run


class TagDetector:
    """Batched AprilTag detector for a single family.

    Usage::

        det = TagDetector("tagStandard41h12")       # on the CUDA device
        detections = det.detect(frames)   # frames (B, H, W) or (B, H, W, 3)
    """

    def __init__(self, family: str | TagFamily = "tagStandard41h12",
                 params: DetectorParams | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.family = get_family(family) if isinstance(family, str) else family
        self.params = params or DetectorParams()
        self._fn = detect_fn(self.family, self.params, device=self.device)

    def detect(self, frames) -> Detections:
        """(B, H, W[, 3]) frames -> Detections sorted by id per frame."""
        return self._fn(torch.as_tensor(frames, device=self.device))
