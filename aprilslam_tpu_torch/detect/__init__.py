from .threshold import to_grayscale, decimate, adaptive_threshold, adaptive_threshold_with_levels
from .segment import connected_components, connected_components_plain
from .quads import quad_candidates, QuadCandidates
from .decode import (
    Detections,
    FamilyTensors,
    homography_from_corners,
    apply_homography,
    bilinear_sample,
    decode_quads,
)
from .refine import refine_corners
from .detector import TagDetector, DetectorParams, detect_fn

__all__ = [
    "to_grayscale",
    "decimate",
    "adaptive_threshold",
    "adaptive_threshold_with_levels",
    "connected_components",
    "connected_components_plain",
    "quad_candidates",
    "QuadCandidates",
    "Detections",
    "FamilyTensors",
    "homography_from_corners",
    "apply_homography",
    "bilinear_sample",
    "decode_quads",
    "refine_corners",
    "TagDetector",
    "DetectorParams",
    "detect_fn",
]
