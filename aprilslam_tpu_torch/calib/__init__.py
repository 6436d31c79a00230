from .zhang import (
    board_points,
    homography_dlt,
    intrinsics_from_homographies,
    extrinsics_from_homography,
    calibrate_camera,
    find_checkerboard_corners,
    CalibrationResult,
)

__all__ = [
    "board_points",
    "homography_dlt",
    "intrinsics_from_homographies",
    "extrinsics_from_homography",
    "calibrate_camera",
    "find_checkerboard_corners",
    "CalibrationResult",
]
