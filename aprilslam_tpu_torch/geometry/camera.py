"""Pinhole camera model and OpenGL<->CV conventions
(port of ``aprilslam_tpu/geometry/camera.py``; the lens-distortion helpers
are not ported yet).

* Intrinsics derive from the renderer's vertical FOV: ``fx = fy =
  0.5 * height / tan(0.5 * fov_y)``, principal point at the image centre.
* The simulator works in an OpenGL camera frame (x right, y up, looking down
  -z); detection/PnP work in the CV camera frame (x right, y down, looking
  down +z). The flip between them is ``diag(1, -1, -1)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GL_TO_CV_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


@dataclass(frozen=True)
class PinholeCamera:
    """Static pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @staticmethod
    def from_fov(width: int, height: int, fov_y_deg: float) -> "PinholeCamera":
        f = 0.5 * height / float(np.tan(np.radians(0.5 * fov_y_deg)))
        return PinholeCamera(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0, width=width, height=height)

    @property
    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def inv_matrix(self) -> np.ndarray:
        return np.array(
            [
                [1.0 / self.fx, 0.0, -self.cx / self.fx],
                [0.0, 1.0 / self.fy, -self.cy / self.fy],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )


def project(points_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project CV-frame camera points (..., 3) to pixels (..., 2)."""
    z = points_cam[..., 2:3]
    xy = points_cam[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * xy[..., 0] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def unproject(pixels: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized image-plane rays (..., 3) with z=1."""
    x = K_inv[0, 0] * pixels[..., 0] + K_inv[0, 2]
    y = K_inv[1, 1] * pixels[..., 1] + K_inv[1, 2]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def gl_point_to_cv(p_gl: torch.Tensor) -> torch.Tensor:
    """Flip a GL-camera-frame point into the CV camera frame (negate y, z)."""
    return p_gl * torch.tensor([1.0, -1.0, -1.0], dtype=p_gl.dtype, device=p_gl.device)


def gl_rotation_to_cv(R_gl: torch.Tensor) -> torch.Tensor:
    """Left-multiply the GL->CV flip onto a rotation."""
    return torch.as_tensor(GL_TO_CV_FLIP, dtype=R_gl.dtype, device=R_gl.device) @ R_gl


def tag_object_corners(tag_size: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """The 4 tag-frame corner points in 'lb-rb-rt-lt' order (z = 0 plane)."""
    h = tag_size / 2.0
    return torch.tensor(
        [[-h, -h, 0.0], [h, -h, 0.0], [h, h, 0.0], [-h, h, 0.0]], dtype=dtype, device=device
    )
