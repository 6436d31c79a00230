"""Batched planar PnP: tag pose from 4 corners + intrinsics
(port of ``aprilslam_tpu/pose/pnp.py``).

1. **IPPE closed-form init**: both candidate rotations of the planar
   two-fold ambiguity come from the homography's first-order behaviour at
   the tag centre; the translation for each from a 3x3 linear solve.
2. **Levenberg-Marquardt refinement** of BOTH candidates over the 8-residual
   corner reprojection (6-dof se(3) tangent, fixed iteration count,
   forward-mode Jacobian), then the lower-error branch wins.

T is camera->tag (the tag pose in the CV camera frame).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from ..detect.decode import Detections, homography_from_corners
from ..geometry import make_se3, se3_exp, so3_log, tag_object_corners, undistort_pixels


def _ippe_rotations(H_obj: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) object-plane->pixel homography -> (..., 2, 3, 3) rotations."""
    Hn = torch.einsum("ij,...jk->...ik", K_inv, H_obj)
    sgn = torch.where(Hn[..., 2, 2] >= 0, 1.0, -1.0)
    h = Hn * sgn[..., None, None]
    h9 = h[..., 2, 2]
    inv_h9 = 1.0 / torch.where(torch.abs(h9) < 1e-12, 1e-12, h9)

    v0 = h[..., 0, 2] * inv_h9
    v1 = h[..., 1, 2] * inv_h9
    J00 = (h[..., 0, 0] - h[..., 2, 0] * v0) * inv_h9
    J01 = (h[..., 0, 1] - h[..., 2, 1] * v0) * inv_h9
    J10 = (h[..., 1, 0] - h[..., 2, 0] * v1) * inv_h9
    J11 = (h[..., 1, 1] - h[..., 2, 1] * v1) * inv_h9

    # R_v: rotation aligning e_z with the centre ray d = (v0, v1, 1)/|.|.
    dn = torch.sqrt(v0 * v0 + v1 * v1 + 1.0)
    dx, dy, dz = v0 / dn, v1 / dn, 1.0 / dn
    c = 1.0 / (1.0 + dz)
    Rv = torch.stack(
        [
            torch.stack([1.0 - dx * dx * c, -dx * dy * c, dx], dim=-1),
            torch.stack([-dx * dy * c, 1.0 - dy * dy * c, dy], dim=-1),
            torch.stack([-dx, -dy, torch.zeros_like(dx) + dz], dim=-1),
        ],
        dim=-2,
    )

    B00 = Rv[..., 0, 0] - v0 * Rv[..., 2, 0]
    B01 = Rv[..., 0, 1] - v0 * Rv[..., 2, 1]
    B10 = Rv[..., 1, 0] - v1 * Rv[..., 2, 0]
    B11 = Rv[..., 1, 1] - v1 * Rv[..., 2, 1]
    detB = B00 * B11 - B01 * B10
    inv_det = 1.0 / torch.where(torch.abs(detB) < 1e-12, 1e-12, detB)
    A00 = (B11 * J00 - B01 * J10) * inv_det
    A01 = (B11 * J01 - B01 * J11) * inv_det
    A10 = (-B10 * J00 + B00 * J10) * inv_det
    A11 = (-B10 * J01 + B00 * J11) * inv_det

    m00 = A00 * A00 + A10 * A10
    m11 = A01 * A01 + A11 * A11
    m01 = A00 * A01 + A10 * A11
    disc = torch.sqrt(torch.clamp((m00 - m11) ** 2 + 4.0 * m01 * m01, min=0.0))
    s1sq = 0.5 * (m00 + m11 + disc)
    gamma = 1.0 / torch.sqrt(torch.clamp(s1sq, min=1e-12))

    p00, p01, p10, p11 = gamma * A00, gamma * A01, gamma * A10, gamma * A11
    c0 = torch.sqrt(torch.clamp(1.0 - (p00 * p00 + p10 * p10), min=0.0))
    c1m = torch.sqrt(torch.clamp(1.0 - (p01 * p01 + p11 * p11), min=0.0))
    dot01 = p00 * p01 + p10 * p11
    c1 = torch.where(dot01 > 0, -1.0, 1.0) * c1m

    def build(c0s, c1s):
        q1 = torch.stack([p00, p10, c0s], dim=-1)
        q2 = torch.stack([p01, p11, c1s], dim=-1)
        q3 = torch.linalg.cross(q1, q2)
        Rt = torch.stack([q1, q2, q3], dim=-1)  # columns
        return torch.einsum("...ij,...jk->...ik", Rv, Rt)

    return torch.stack([build(c0, c1), build(-c0, -c1)], dim=-3)


def _dot(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``a * b`` over ``dim``, accumulated in index order.

    The normal equations below contract this way, not with batched matrix
    products: on the card cuBLAS picks its batched kernels by the batch
    count, and they round differently, so a tag's pose would depend on how
    many frames share the call (config 3 runs every sequence's frames in
    one call). Elementwise products and sums give every tag the same bits
    whatever the batch, and on the CPU the same bits as its batched matmul
    at these sizes, which also accumulates in order."""
    p = a * b
    acc = p.select(dim, 0)
    for k in range(1, p.shape[dim]):
        acc = acc + p.select(dim, k)
    return acc


def _translation_for_rotation(R, obj, corners, K_inv):
    """Least-squares translation given rotation (..., 3, 3) -> (..., 3),
    via the 3x3 normal equations of the 8 linear corner equations."""
    ones = torch.ones_like(corners[..., :1])
    m = torch.einsum("ij,...cj->...ci", K_inv, torch.cat([corners, ones], dim=-1))
    u = m[..., :2] / m[..., 2:3]
    RX = torch.einsum("...ij,cj->...ci", R, obj)
    zeros = torch.zeros_like(u[..., 0])
    mones = -torch.ones_like(u[..., 0])
    r1 = torch.stack([mones, zeros, u[..., 0]], dim=-1)
    r2 = torch.stack([zeros, mones, u[..., 1]], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 8, 3)
    b = torch.cat([RX[..., 0] - u[..., 0] * RX[..., 2], RX[..., 1] - u[..., 1] * RX[..., 2]], dim=-1)
    AtA = _dot(A[..., :, None], A[..., None, :], -3) + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    Atb = _dot(A, b[..., None], -2)
    return torch.linalg.solve_ex(AtA, Atb[..., None]).result[..., 0]


def _project_corners(T: torch.Tensor, obj: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """T (4,4), obj (4,3), K (3,3) -> (4,2) pixels."""
    p = obj @ T[:3, :3].T + T[:3, 3]
    z = torch.where(torch.abs(p[:, 2:3]) < 1e-9, 1e-9, p[:, 2:3])
    xy = p[:, :2] / z
    return torch.stack([K[0, 0] * xy[:, 0] + K[0, 2], K[1, 1] * xy[:, 1] + K[1, 2]], dim=-1)


def _refine(T0, corners, obj, K, iters: int, lm_lambda: float):
    """LM refinement of N poses at once. T0 (N,4,4), corners (N,4,2).
    Returns (T (N,4,4), rms_px (N,))."""

    def residual(xi, T, uv):
        return (_project_corners(se3_exp(xi) @ T, obj, K) - uv).reshape(-1)

    res_b = vmap(residual)
    jac_b = vmap(jacrev(residual))
    N = T0.shape[0]
    z6 = torch.zeros((N, 6), dtype=T0.dtype, device=T0.device)
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    for _ in range(iters):
        r = res_b(z6, T, corners)
        J = jac_b(z6, T, corners)  # (N, 8, 6)
        A = _dot(J[..., :, None], J[..., None, :], -3)
        A = A + lm_lambda * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-9 * eye6
        g = _dot(J, r[..., None], -2)
        xi = -torch.linalg.solve_ex(A, g[..., None]).result[..., 0]
        T_new = se3_exp(xi) @ T
        r_new = res_b(z6, T_new, corners)
        better = (r_new**2).sum(-1) < (r**2).sum(-1)
        T = torch.where(better[:, None, None], T_new, T)
    rms = torch.sqrt((res_b(z6, T, corners) ** 2).mean(-1))
    return T, rms


class PnPDual(NamedTuple):
    """Both branches of the planar-PnP ambiguity, best first."""

    T: torch.Tensor  # (..., 4, 4) best camera->tag
    rms: torch.Tensor  # (...,) reprojection rms of the best branch (px)
    T_alt: torch.Tensor  # (..., 4, 4) the other branch
    rms_alt: torch.Tensor  # (...,)
    ambiguity: torch.Tensor  # (...,) rms / rms_alt in [0, 1]; near 1 = ambiguous


def solve_planar_pnp_dual(
    corners: torch.Tensor,  # (..., 4, 2) pixel corners in lb-rb-rt-lt order
    K: torch.Tensor,  # (3, 3)
    tag_size: float,
    iters: int = 8,
    lm_lambda: float = 1e-4,
) -> PnPDual:
    """Batched dual-hypothesis planar PnP (IPPE init, LM-refined branches)."""
    dev = corners.device
    corners = corners.to(torch.float32)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    obj = tag_object_corners(tag_size, device=dev)
    # Quad frame [-1,1]^2 (y down) -> object plane: H_obj = H_quad @ S.
    Hq = homography_from_corners(corners)
    s = torch.tensor(float(tag_size), dtype=torch.float32)
    S = torch.tensor([[2.0, 0.0, 0.0], [0.0, -2.0, 0.0], [0.0, 0.0, 1.0]]) * torch.stack(
        [1.0 / s, 1.0 / s, torch.tensor(1.0)])[:, None]
    H_obj = Hq @ S.to(dev)
    K_inv = torch.linalg.inv(K)

    R2 = _ippe_rotations(H_obj, K_inv)  # (..., 2, 3, 3)
    c2 = corners[..., None, :, :].expand(R2.shape[:-2] + (4, 2))
    T0 = make_se3(R2, _translation_for_rotation(R2, obj, c2, K_inv))

    batch_shape = corners.shape[:-2]
    T, rms = _refine(T0.reshape(-1, 4, 4), c2.reshape(-1, 4, 2), obj, K, iters, lm_lambda)
    T = T.reshape(batch_shape + (2, 4, 4))
    rms = rms.reshape(batch_shape + (2,))

    best = torch.argmin(rms, dim=-1)
    pick = (best == 0)[..., None, None]
    T_best = torch.where(pick, T[..., 0, :, :], T[..., 1, :, :])
    T_alt = torch.where(pick, T[..., 1, :, :], T[..., 0, :, :])
    rms_best = torch.where(best == 0, rms[..., 0], rms[..., 1])
    rms_alt = torch.where(best == 0, rms[..., 1], rms[..., 0])
    ambiguity = rms_best / torch.clamp(rms_alt, min=1e-9)
    return PnPDual(T_best, rms_best, T_alt, rms_alt, ambiguity)


def solve_planar_pnp(corners, K, tag_size: float, iters: int = 8, lm_lambda: float = 1e-4):
    """Batched planar PnP (best IPPE branch): (T, rvec, tvec, reproj_rms)."""
    res = solve_planar_pnp_dual(corners, K, tag_size, iters=iters, lm_lambda=lm_lambda)
    return res.T, so3_log(res.T[..., :3, :3]), res.T[..., :3, 3], res.rms


def poses_from_detections(
    det: Detections,
    K,
    tag_size: float,
    iters: int = 8,
    max_reproj_px: float = 2.0,
    ambiguity_max: float = 0.55,
    branch_sep_ok: float = 0.35,
    dist_coeffs=None,
):
    """Estimate T_cam_tag for every detection.

    Returns (T (B, D, 4, 4), ok (B, D), reproj_rms (B, D), seed_ok (B, D),
    T_alt (B, D, 4, 4)). ``ok`` combines detection validity, cheirality and
    reprojection quality; ``seed_ok`` additionally requires the pose to be
    branch-reliable (gates map seeding). With ``dist_coeffs`` (OpenCV k1,
    k2, p1, p2[, k3]) the corners are undistorted first, so the pinhole PnP
    is exact."""
    corners = det.corners
    if dist_coeffs is not None:
        corners = undistort_pixels(corners, torch.as_tensor(K, device=corners.device), dist_coeffs)
    res = solve_planar_pnp_dual(corners, K, tag_size, iters=iters)
    ok = det.valid & (res.T[..., 2, 3] > 0) & (res.rms < max_reproj_px)
    sep = torch.linalg.norm(res.T[..., :3, :3] - res.T_alt[..., :3, :3], dim=(-2, -1))
    seed_ok = ok & ((res.ambiguity < ambiguity_max) | (sep < branch_sep_ok))
    return res.T, ok, res.rms, seed_ok, res.T_alt
