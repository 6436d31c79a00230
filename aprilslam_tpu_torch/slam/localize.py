"""Joint multi-tag camera localization (port of ``aprilslam_tpu/slam/localize.py``).

Given the landmark map, the camera pose minimizing the reprojection error
of ALL used tags' corners jointly: a 6-dof Levenberg-Marquardt problem with
8 residuals per tag, fixed iteration count, batched over leading axes.
"""

from __future__ import annotations

import torch
from torch.func import jacrev, vmap

from ..geometry import se3_exp, se3_inverse, tag_object_corners


def _world_corners(world: torch.Tensor, tag_size: float) -> torch.Tensor:
    """(..., M, 4, 4) tag->world -> (..., M, 4, 3) world-frame corner points."""
    obj = tag_object_corners(tag_size, dtype=world.dtype, device=world.device)
    return torch.einsum("...mij,cj->...mci", world[..., :3, :3], obj) + world[..., :, None, :3, 3]


def _pixels(T_cw: torch.Tensor, Xw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Single-sample projection: T_cw (4,4), Xw (M,4,3) -> (M,4,2)."""
    Xc = torch.einsum("ij,mcj->mci", T_cw[:3, :3], Xw) + T_cw[:3, 3]
    z = torch.where(torch.abs(Xc[..., 2:3]) < 1e-6, 1e-6, Xc[..., 2:3])
    xy = Xc[..., :2] / z
    return torch.stack([K[0, 0] * xy[..., 0] + K[0, 2], K[1, 1] * xy[..., 1] + K[1, 2]], dim=-1)


def _residual(xi, T_cw, Xw, uv_obs, wmask, K):
    return ((_pixels(se3_exp(xi) @ T_cw, Xw, K) - uv_obs) * wmask[:, None, None]).reshape(-1)


def joint_camera_pose(
    world: torch.Tensor,  # (..., M, 4, 4) tag->world transforms
    use: torch.Tensor,  # (..., M) bool: landmarks to use
    corners: torch.Tensor,  # (..., M, 4, 2) pixel corners per tag slot
    K: torch.Tensor,  # (3, 3)
    tag_size: float,
    T_wc_init: torch.Tensor,  # (..., 4, 4) initial camera pose in world frame
    iters: int = 6,
    lm_lambda: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (T_wc refined (..., 4, 4), reprojection rms over used tags (...))."""
    batch = T_wc_init.shape[:-2]
    M = use.shape[-1]
    Xw = _world_corners(world, tag_size).expand(batch + (M, 4, 3)).reshape(-1, M, 4, 3)
    uv_obs = corners.expand(batch + (M, 4, 2)).reshape(-1, M, 4, 2)
    wmask = use.expand(batch + (M,)).reshape(-1, M).to(torch.float32)
    T_cw = se3_inverse(T_wc_init).reshape(-1, 4, 4)
    N = T_cw.shape[0]
    z6 = torch.zeros((N, 6), dtype=T_cw.dtype, device=T_cw.device)
    eye6 = torch.eye(6, dtype=T_cw.dtype, device=T_cw.device)
    in_dims = (0, 0, 0, 0, 0, None)
    res_b = vmap(_residual, in_dims=in_dims)
    jac_b = vmap(jacrev(_residual), in_dims=in_dims)

    for _ in range(iters):
        r = res_b(z6, T_cw, Xw, uv_obs, wmask, K)
        J = jac_b(z6, T_cw, Xw, uv_obs, wmask, K)  # (N, 8M, 6)
        A = J.transpose(-1, -2) @ J + lm_lambda * eye6
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        xi = -torch.linalg.solve_ex(A, g[..., None]).result[..., 0]
        T_new = se3_exp(xi) @ T_cw
        better = (res_b(z6, T_new, Xw, uv_obs, wmask, K) ** 2).sum(-1) < (r**2).sum(-1)
        T_cw = torch.where(better[:, None, None], T_new, T_cw)

    n = torch.clamp(wmask.sum(-1) * 8.0, min=1.0)
    rms = torch.sqrt((res_b(z6, T_cw, Xw, uv_obs, wmask, K) ** 2).sum(-1) / n)
    return se3_inverse(T_cw).reshape(batch + (4, 4)), rms.reshape(batch)


def pose_observability(
    world: torch.Tensor,  # (..., M, 4, 4) tag->world transforms
    use: torch.Tensor,  # (..., M) bool: landmarks used in localization
    K: torch.Tensor,  # (3, 3)
    tag_size: float,
    T_wc: torch.Tensor,  # (..., 4, 4) camera pose in world frame
) -> torch.Tensor:
    """Smallest singular value of the 6-dof reprojection Jacobian at T_wc:
    pixels of corner motion per unit tangent step in the least-observable
    camera-pose direction. 0 when no landmark is used."""
    batch = T_wc.shape[:-2]
    M = use.shape[-1]
    Xw = _world_corners(world, tag_size).expand(batch + (M, 4, 3)).reshape(-1, M, 4, 3)
    wmask = use.expand(batch + (M,)).reshape(-1, M).to(torch.float32)
    T_cw = se3_inverse(T_wc).reshape(-1, 4, 4)

    def uv_at(xi, T, X, wm):
        return (_pixels(se3_exp(xi) @ T, X, K) * wm[:, None, None]).reshape(-1)

    z6 = torch.zeros((T_cw.shape[0], 6), dtype=T_cw.dtype, device=T_cw.device)
    J = vmap(jacrev(uv_at))(z6, T_cw, Xw, wmask)
    JtJ = J.transpose(-1, -2) @ J
    # eigvalsh can fail to converge on non-finite input; such frames give NaN.
    finite = torch.isfinite(JtJ).all(dim=-1).all(dim=-1)
    eye6 = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    lam = torch.linalg.eigvalsh(torch.where(finite[:, None, None], JtJ, eye6))
    s = torch.sqrt(torch.clamp(lam[:, 0], min=0.0))
    return torch.where(finite, s, float("nan")).reshape(batch)
