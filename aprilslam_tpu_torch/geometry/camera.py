"""Pinhole camera model and OpenGL<->CV conventions
(port of ``aprilslam_tpu/geometry/camera.py``).

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


def _brown_conrady(dist, like: torch.Tensor):
    """(k1, k2, p1, p2, k3) of an OpenCV coefficient vector, zero-padded to 5."""
    d = torch.as_tensor(dist, dtype=like.dtype).to(like.device).reshape(-1)[:5]
    d = torch.nn.functional.pad(d, (0, 5 - d.shape[0]))
    return d[0], d[1], d[2], d[3], d[4]


def distort_normalized(xn: torch.Tensor, dist) -> torch.Tensor:
    """Apply Brown-Conrady distortion (OpenCV layout k1, k2, p1, p2[, k3]) to
    normalized image coords (..., 2): radial terms up to r^6 plus tangential."""
    k1, k2, p1, p2, k3 = _brown_conrady(dist, xn)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + xt, y * radial + yt], dim=-1)


def undistort_normalized(xd: torch.Tensor, dist, iters: int = 10) -> torch.Tensor:
    """Invert Brown-Conrady distortion by a fixed count of fixed-point steps
    (..., 2), the compensation loop of cv2.undistortPoints: divide out the
    radial factor and subtract the tangential shift at the current estimate."""
    k1, k2, p1, p2, k3 = _brown_conrady(dist, xd)
    x0, y0 = xd[..., 0], xd[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        inv = 1.0 / torch.where(torch.abs(radial) < 1e-6, 1e-6, radial)
        xt = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yt = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - xt) * inv, (y0 - yt) * inv
    return torch.stack([x, y], dim=-1)


def _pixel_map(fn, px: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Apply ``fn`` to pixels in normalized coordinates. The result is the
    input plus the shift ``fn`` makes, scaled back to pixels, so that zero
    coefficients return the pixels bit for bit (px -> normalized -> px
    would not)."""
    x = (px[..., 0] - K[0, 2]) / K[0, 0]
    y = (px[..., 1] - K[1, 2]) / K[1, 1]
    xn = torch.stack([x, y], dim=-1)
    shift = fn(xn) - xn
    return torch.stack([px[..., 0] + K[0, 0] * shift[..., 0], px[..., 1] + K[1, 1] * shift[..., 1]], dim=-1)


def distort_pixels(px: torch.Tensor, K: torch.Tensor, dist) -> torch.Tensor:
    """Ideal pinhole pixels (..., 2) -> observed (distorted) pixels."""
    return _pixel_map(lambda xn: distort_normalized(xn, dist), px, K)


def undistort_pixels(px: torch.Tensor, K: torch.Tensor, dist, iters: int = 10) -> torch.Tensor:
    """Observed (distorted) pixels (..., 2) -> ideal pinhole pixels, the
    cv2.undistortPoints(..., P=K) equivalent."""
    return _pixel_map(lambda xn: undistort_normalized(xn, dist, iters=iters), px, K)


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
