"""Plain planar pose solvers: one tag's pose from its four corners, and a
camera's pose from every tag it sees on a known map.

Both minimise the sum of squared corner reprojection errors in pixels by
Levenberg-Marquardt with an analytic Jacobian, in whatever dtype their
inputs carry (float64 for the reference, bfloat16 for the control). The
tag's first guess comes from the homography of its four corners (Zhang's
decomposition), worked out here, not from anything the program made.
"""

from __future__ import annotations

import torch

from perfbench.reference.geometry import left_update, make_se3, project, se3_inverse, solve_spd, tag_corners


def _jacobian(X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """d pixels / d (rotation, translation) of a left update, at camera points X (..., P, 3) -> (..., P, 2, 6)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    fx, fy = K[0, 0], K[1, 1]
    zero = torch.zeros_like(x)
    dproj = torch.stack([
        torch.stack([fx / zs, zero, -fx * x / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * y / (zs * zs)], -1)], -2)  # (..., P, 2, 3)
    # d X / d omega = -[X]x ; d X / d v = I
    negXx = torch.stack([
        torch.stack([zero, z, -y], -1),
        torch.stack([-z, zero, x], -1),
        torch.stack([y, -x, zero], -1)], -2)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(negXx.shape)
    return dproj @ torch.cat([negXx, eye], -1)


def reprojection(T: torch.Tensor, pts: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, K) -> torch.Tensor:
    """RMS pixel error of pose T (..., 4, 4) on points (..., P, 3) against
    pixels (..., P, 2), over the points weighted 1 by ``w`` (..., P)."""
    px, _ = project(T, pts, torch.as_tensor(K, dtype=uv.dtype))
    return _rms(px - uv, w)


def _rms(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(w.sum(-1), min=1.0)
    return torch.sqrt((d * d).sum(-1).mul(w).sum(-1) / n)


def refine(T: torch.Tensor, pts: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, K, iters: int,
           lam: float = 1e-4) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt from T (..., 4, 4) in the dtype of ``uv``, the
    damping raised tenfold after a step that does not lower the cost and
    lowered tenfold after one that does: returns (T, rms px)."""
    K = torch.as_tensor(K, dtype=uv.dtype)
    damp = torch.full(T.shape[:-2], lam, dtype=uv.dtype)
    eye6 = torch.eye(6, dtype=uv.dtype)
    for _ in range(iters):
        X = torch.einsum("...ij,...pj->...pi", T[..., :3, :3], pts) + T[..., None, :3, 3]
        px, _ = project(T, pts, K)
        r = ((px - uv) * w[..., None]).reshape(px.shape[:-2] + (-1,))
        J = (_jacobian(X, K) * w[..., None, None]).reshape(px.shape[:-2] + (-1, 6))
        A = J.transpose(-1, -2) @ J
        A = A + damp[..., None, None] * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-12 * eye6
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        T_new = left_update(-solve_spd(A, g), T)
        px_new, _ = project(T_new, pts, K)
        better = (((px_new - uv) * w[..., None]) ** 2).sum((-1, -2)) < (r * r).sum(-1)
        T = torch.where(better[..., None, None], T_new, T)
        damp = torch.where(better, damp * 0.1, damp * 10.0).clamp(1e-9, 1e9)
    px, _ = project(T, pts, K)
    return T, _rms(px - uv, w)


def homography_pose(corners: torch.Tensor, tag_size: float, K) -> torch.Tensor:
    """A first guess of T_cam_tag (..., 4, 4) from four pixel corners
    (..., 4, 2): the plane-to-image homography, decomposed."""
    dt = corners.dtype
    K = torch.as_tensor(K, dtype=dt)
    obj = tag_corners(tag_size, dtype=dt)[:, :2] / tag_size  # the tag plane, scaled to unit size
    xn = torch.stack([(corners[..., 0] - K[0, 2]) / K[0, 0], (corners[..., 1] - K[1, 2]) / K[1, 1]], -1)
    X, Y = obj[:, 0].expand(xn.shape[:-1]), obj[:, 1].expand(xn.shape[:-1])
    u, v = xn[..., 0], xn[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    # h33 = 1: two equations per correspondence in the other eight entries.
    ru = torch.stack([X, Y, one, zero, zero, zero, -u * X, -u * Y], -1)
    rv = torch.stack([zero, zero, zero, X, Y, one, -v * X, -v * Y], -1)
    A = torch.cat([ru, rv], -2)  # (..., 8, 8)
    b = torch.cat([u, v], -1)
    At = A.transpose(-1, -2)
    h = solve_spd(At @ A, (At @ b[..., None])[..., 0])
    H = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(h.shape[:-1] + (3, 3))
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 2.0 / (h1.norm(dim=-1) + h2.norm(dim=-1))
    sgn = torch.where(h3[..., 2] < 0, -torch.ones_like(lam), torch.ones_like(lam))
    lam = lam * sgn
    r1 = h1 * lam[..., None]
    r2 = h2 * lam[..., None]
    t = h3 * lam[..., None]
    r1 = r1 / r1.norm(dim=-1, keepdim=True)
    r2 = r2 - (r1 * r2).sum(-1, keepdim=True) * r1
    r2 = r2 / r2.norm(dim=-1, keepdim=True)
    r3 = torch.stack([r1[..., 1] * r2[..., 2] - r1[..., 2] * r2[..., 1],
                      r1[..., 2] * r2[..., 0] - r1[..., 0] * r2[..., 2],
                      r1[..., 0] * r2[..., 1] - r1[..., 1] * r2[..., 0]], -1)
    R = torch.stack([r1, r2, r3], -1)
    return make_se3(R, t * tag_size)


def tag_pose(corners: torch.Tensor, tag_size: float, K, iters: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """A tag's pose from its corners (..., 4, 2), computed in their dtype: (T, rms px)."""
    obj = tag_corners(tag_size, dtype=corners.dtype).expand(corners.shape[:-1] + (3,))
    w = torch.ones(corners.shape[:-1], dtype=corners.dtype)
    return refine(homography_pose(corners, tag_size, K), obj, corners, w, K, iters)


def tag_pose_gap(T: torch.Tensor, corners: torch.Tensor, tag_size: float, K, iters: int = 20) -> torch.Tensor:
    """How far (px) the reprojection error of the answer T (..., 4, 4) on its
    own corners lies above the best the reference reaches, from the answer
    and from its own first guess, in float64."""
    T = T.to(torch.float64)
    corners = corners.to(torch.float64)
    obj = tag_corners(tag_size).expand(corners.shape[:-1] + (3,))
    w = torch.ones(corners.shape[:-1], dtype=torch.float64)
    rms = reprojection(T, obj, corners, w, K)
    _, rms_a = refine(T, obj, corners, w, K, iters)
    _, rms_b = tag_pose(corners, tag_size, K, iters)
    return rms - torch.minimum(torch.minimum(rms_a, rms_b), rms)


def world_corners(lm_pose: torch.Tensor, tag_size: float) -> torch.Tensor:
    """(..., M, 4, 4) tag->world -> (..., M*4, 3) corner points in the world."""
    obj = tag_corners(tag_size, dtype=lm_pose.dtype)
    X = torch.einsum("...mij,cj->...mci", lm_pose[..., :3, :3], obj) + lm_pose[..., :, None, :3, 3]
    return X.reshape(X.shape[:-3] + (-1, 3))


def camera_gap(T_cw: torch.Tensor, lm_pose: torch.Tensor, use: torch.Tensor, corners: torch.Tensor,
               tag_size: float, K, iters: int = 20) -> torch.Tensor:
    """How far (px) the reprojection error of a camera pose T_cw (N, 4, 4)
    (world -> camera) on the used tags (N, M) of the map (N, M, 4, 4) lies
    above the best the reference reaches, from the answer and from its own
    solve (:func:`camera_pose`), in float64."""
    T_cw = T_cw.to(torch.float64)
    lm_pose = lm_pose.to(torch.float64)
    corners = corners.to(torch.float64)
    pts = world_corners(lm_pose, tag_size)
    uv = corners.reshape(corners.shape[0], -1, 2)
    w = use.to(torch.float64).repeat_interleave(4, dim=-1)
    rms = reprojection(T_cw, pts, uv, w, K)
    _, rms_opt = refine(T_cw, pts, uv, w, K, iters, lam=1e-5)
    rms_own = reprojection(camera_pose(lm_pose, use, corners, tag_size, K, iters), pts, uv, w, K)
    return rms - torch.minimum(torch.minimum(rms_opt, rms_own), rms)


def camera_pose(lm_pose: torch.Tensor, use: torch.Tensor, corners: torch.Tensor, tag_size: float, K,
                iters: int = 20) -> torch.Tensor:
    """A camera's pose T_cw (N, 4, 4) on the map from every used tag,
    computed in the inputs' dtype: first from the lowest used tag's own pose,
    then refined over all of them. Frames with no used tag get the identity."""
    dt = corners.dtype
    N, M = use.shape
    first = torch.argmax(use.to(torch.int64), dim=-1)
    idx = torch.arange(N)
    T_ct, _ = tag_pose(corners[idx, first], tag_size, K, iters)
    T_cw0 = T_ct @ se3_inverse(lm_pose[idx, first])
    pts = world_corners(lm_pose, tag_size)
    uv = corners.reshape(N, -1, 2)
    w = use.to(dt).repeat_interleave(4, dim=-1)
    T_cw, _ = refine(T_cw0, pts, uv, w, K, iters, lam=1e-5)
    return torch.where(use.any(-1)[:, None, None], T_cw, torch.eye(4, dtype=dt).expand(N, 4, 4))
