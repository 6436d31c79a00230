"""Camera calibration: Zhang's method with a batched LM refinement
(port of ``aprilslam_tpu/calib/zhang.py``).

1. Per-view DLT homographies board->image (SVD).
2. Closed-form intrinsics from the homography constraints (Zhang 2000).
3. Per-view extrinsics from K^-1 H.
4. Joint Levenberg-Marquardt over intrinsics (fx, fy, cx, cy), radial
   distortion (k1, k2), and all view poses — batched residuals over every
   corner of every view, with a ``torch.func.jacfwd`` Jacobian. The
   accept/reject decision of each step stays on the device.

The SVD's null vector comes back with either sign depending on the solver;
every formula here (``H / H[2, 2]``, the B-matrix ratios) is invariant to
it, so no sign is fixed.

Corner *detection* on real images goes through OpenCV
(:func:`find_checkerboard_corners`, cv2 imported when called); the rest is
pure geometry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import se3_exp, se3_log


def board_points(cols: int, rows: int, square_mm: float) -> np.ndarray:
    """Inner-corner grid (cols*rows, 3) in board frame, z=0 (a 10x7 board
    with 25 mm squares is the calibration app's default)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = np.stack([xs.ravel(), ys.ravel(), np.zeros(cols * rows)], axis=-1)
    return (pts * square_mm).astype(np.float32)


def homography_dlt(obj_xy: torch.Tensor, img_uv: torch.Tensor) -> torch.Tensor:
    """N-point DLT homography (N >= 4): board plane (x, y) -> pixels.

    Normalized for conditioning; returns (3, 3) with H[2,2] ~ 1.
    """

    def normalize(p):
        mu = p.mean(dim=0)
        sd = torch.linalg.norm(p - mu, dim=-1).mean() + 1e-12
        s = (2.0 ** 0.5) / sd
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([torch.stack([s, zero, -s * mu[0]]),
                         torch.stack([zero, s, -s * mu[1]]),
                         torch.stack([zero, zero, one])])
        ph = torch.cat([p, torch.ones_like(p[:, :1])], dim=-1) @ T.T
        return ph[:, :2], T

    x, Tx = normalize(obj_xy)
    u, Tu = normalize(img_uv)
    zeros = torch.zeros_like(x[:, 0])
    ones = torch.ones_like(x[:, 0])
    r1 = torch.stack([x[:, 0], x[:, 1], ones, zeros, zeros, zeros,
                      -u[:, 0] * x[:, 0], -u[:, 0] * x[:, 1], -u[:, 0]], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, x[:, 0], x[:, 1], ones,
                      -u[:, 1] * x[:, 0], -u[:, 1] * x[:, 1], -u[:, 1]], dim=-1)
    A = torch.cat([r1, r2], dim=0)  # (2n, 9)
    Vt = torch.linalg.svd(A).Vh
    Hn = Vt[-1].reshape(3, 3)
    H = torch.linalg.inv(Tu) @ Hn @ Tx
    return H / H[2, 2]


def intrinsics_from_homographies(Hs: torch.Tensor) -> torch.Tensor:
    """Closed-form K init from >= 3 homographies (Zhang's B-matrix method).

    Assumes zero skew. Returns (fx, fy, cx, cy).
    """

    def v_ij(H, i, j):
        return torch.stack([
            H[:, 0, i] * H[:, 0, j],
            H[:, 0, i] * H[:, 1, j] + H[:, 1, i] * H[:, 0, j],
            H[:, 1, i] * H[:, 1, j],
            H[:, 2, i] * H[:, 0, j] + H[:, 0, i] * H[:, 2, j],
            H[:, 2, i] * H[:, 1, j] + H[:, 1, i] * H[:, 2, j],
            H[:, 2, i] * H[:, 2, j],
        ], dim=-1)

    # Rows interleaved per view, as the reference stacks them.
    V = torch.stack([v_ij(Hs, 0, 1), v_ij(Hs, 0, 0) - v_ij(Hs, 1, 1)], dim=1).reshape(-1, 6)
    b = torch.linalg.svd(V).Vh[-1]  # B11 B12 B22 B13 B23 B33 (zero skew -> B12 ~ 0)
    B11, B12, B22, B13, B23, B33 = b
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12**2)
    lam = B33 - (B13**2 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = torch.sqrt(torch.abs(lam / B11))
    fy = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12**2)))
    cx = -B13 * fx**2 / lam
    return torch.stack([fx, fy, cx, cy])


def extrinsics_from_homography(H: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Per-view board pose T (4, 4) from H = K [r0 r1 t]."""
    M = torch.linalg.inv(K) @ H
    lam = 2.0 / (torch.linalg.norm(M[:, 0]) + torch.linalg.norm(M[:, 1]) + 1e-12)
    lam = lam * torch.where(M[2, 2] * lam > 0, 1.0, -1.0)
    r0 = M[:, 0] * lam
    r1 = M[:, 1] * lam
    r2 = torch.linalg.cross(r0, r1)
    R = torch.stack([r0, r1, r2], dim=-1)
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    R = U @ D @ Vt
    t = M[:, 2] * lam
    T = torch.eye(4, dtype=H.dtype, device=H.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _project_dist(params, poses_xi, obj, view_idx):
    """Project all corners with intrinsics + radial distortion.

    params = [fx, fy, cx, cy, k1, k2]; poses_xi (V, 6); obj (V*N, 3);
    view_idx (V*N,) mapping each corner row to its view.
    """
    fx, fy, cx, cy, k1, k2 = params
    Tsel = se3_exp(poses_xi)[view_idx]  # (VN, 4, 4)
    p = torch.einsum("nij,nj->ni", Tsel[:, :3, :3], obj) + Tsel[:, :3, 3]
    z = torch.where(torch.abs(p[:, 2:3]) < 1e-9, 1e-9, p[:, 2:3])
    xy = p[:, :2] / z
    r2 = torch.sum(xy**2, dim=-1, keepdim=True)
    xyd = xy * (1.0 + k1 * r2 + k2 * r2**2)
    return torch.stack([fx * xyd[:, 0] + cx, fy * xyd[:, 1] + cy], dim=-1)


@dataclass
class CalibrationResult:
    camera_matrix: np.ndarray  # (3, 3)
    dist_coeffs: np.ndarray  # (5,) [k1, k2, 0, 0, 0] OpenCV layout
    mean_reprojection_error: float
    per_view_errors: np.ndarray
    quality: str

    @staticmethod
    def rate(err_px: float) -> str:
        """Quality gates on the mean reprojection error in pixels."""
        if err_px < 0.5:
            return "Excellent"
        if err_px < 1.0:
            return "Good"
        if err_px < 2.0:
            return "Acceptable"
        return "Poor"

    def save_npz(self, path: str):
        """The JAX package's artifact layout: ``dist_coeffs`` as (1, 5)."""
        np.savez(path, camera_matrix=self.camera_matrix, dist_coeffs=self.dist_coeffs[None, :])


def calibrate_camera(
    object_points: np.ndarray,  # (N, 3) shared board model
    image_points: list[np.ndarray],  # V arrays of (N, 2)
    iters: int = 30,
    device: str | torch.device | None = None,
) -> CalibrationResult:
    """Zhang init + joint LM refinement, on the CUDA device unless ``device``
    says otherwise. Returns OpenCV-comparable results."""
    dev = resolve_device(device)
    obj = torch.as_tensor(np.asarray(object_points, np.float32), device=dev)
    V = len(image_points)
    uv = torch.as_tensor(np.stack(image_points).astype(np.float32), device=dev)  # (V, N, 2)

    Hs = torch.stack([homography_dlt(obj[:, :2], uv[v]) for v in range(V)])
    k4 = intrinsics_from_homographies(Hs)
    zero, one = torch.zeros_like(k4[0]), torch.ones_like(k4[0])
    K0 = torch.stack([torch.stack([k4[0], zero, k4[2]]),
                      torch.stack([zero, k4[1], k4[3]]),
                      torch.stack([zero, zero, one])])
    Ts = torch.stack([extrinsics_from_homography(Hs[v], K0) for v in range(V)])
    xi0 = se3_log(Ts)  # pose tangents with exp(xi) = T
    params0 = torch.cat([k4, torch.zeros(2, dtype=k4.dtype, device=dev)])

    N = obj.shape[0]
    view_idx = torch.arange(V, device=dev).repeat_interleave(N)
    obj_rep = obj.repeat(V, 1)
    uv_flat = uv.reshape(V * N, 2)

    def residual(flat):
        proj = _project_dist(flat[:6], flat[6:].reshape(V, 6), obj_rep, view_idx)
        return (proj - uv_flat).reshape(-1)

    jac = torch.func.jacfwd(residual)
    flat = torch.cat([params0, xi0.reshape(-1)])
    lam = torch.tensor(1e-3, dtype=flat.dtype, device=dev)
    eye = torch.eye(flat.shape[0], dtype=flat.dtype, device=dev)
    for _ in range(iters):
        r = residual(flat)
        J = jac(flat)
        step = -torch.linalg.solve_ex(J.T @ J + lam * eye, J.T @ r).result
        new = flat + step
        better = torch.sum(residual(new) ** 2) < torch.sum(r**2)
        flat = torch.where(better, new, flat)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e3)

    proj = _project_dist(flat[:6], flat[6:].reshape(V, 6), obj_rep, view_idx)
    err = torch.linalg.norm(proj - uv_flat, dim=-1).reshape(V, N).cpu().numpy()
    params = flat[:6].cpu().numpy()
    mean_err = float(err.mean())
    K = np.array(
        [[params[0], 0, params[2]], [0, params[1], params[3]], [0, 0, 1]], dtype=np.float64
    )
    dist = np.array([params[4], params[5], 0.0, 0.0, 0.0], dtype=np.float64)
    return CalibrationResult(
        camera_matrix=K,
        dist_coeffs=dist,
        mean_reprojection_error=mean_err,
        per_view_errors=err.mean(axis=1),
        quality=CalibrationResult.rate(mean_err),
    )


def find_checkerboard_corners(images, cols: int = 10, rows: int = 7):
    """Corner frontend over grayscale or BGR images via OpenCV
    (findChessboardCorners + cornerSubPix). Returns (image_points list, ok
    flags)."""
    import cv2

    pts, oks = [], []
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001)
    for img in images:
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ok, corners = cv2.findChessboardCorners(img, (cols, rows), None)
        if ok:
            corners = cv2.cornerSubPix(img, corners, (11, 11), (-1, -1), criteria)
            pts.append(corners.reshape(-1, 2))  # (N, 1, 2) before OpenCV 5, (N, 2) since
        oks.append(bool(ok))
    return pts, oks
