"""Analytic ground-truth oracle, batched over tags and camera poses
(port of ``aprilslam_tpu/sim/ground_truth.py``)."""

from __future__ import annotations

import torch

from ..geometry import camera_euler_to_matrix, euler_zyx_to_matrix, make_se3, se3_inverse
from ..geometry.camera import GL_TO_CV_FLIP


def tag_world_rotations(tag_rot_deg: torch.Tensor) -> torch.Tensor:
    """Tag GL-world rotations from config Euler [rx, ry, rz] degrees (Rz@Ry@Rx)."""
    return euler_zyx_to_matrix(tag_rot_deg)


def camera_world_rotation(cam_rot_deg: torch.Tensor) -> torch.Tensor:
    """Camera GL-world rotation from [pitch, yaw, roll] degrees (Ry@Rx@Rz)."""
    return camera_euler_to_matrix(cam_rot_deg)


def camera_to_tag_transforms(
    tag_pos: torch.Tensor,  # (T, 3) GL world
    tag_rot_deg: torch.Tensor,  # (T, 3)
    cam_pos: torch.Tensor,  # (..., 3) GL world
    cam_rot_deg: torch.Tensor | None = None,  # (..., 3) [pitch, yaw, roll]
) -> torch.Tensor:
    """T_cam_tag in the CV camera frame: (..., T, 4, 4)."""
    flip = torch.as_tensor(GL_TO_CV_FLIP, dtype=tag_pos.dtype, device=tag_pos.device)
    R_tag = tag_world_rotations(tag_rot_deg)  # (T, 3, 3)
    rel_gl = tag_pos - cam_pos[..., None, :]  # (..., T, 3)
    if cam_rot_deg is not None:
        R_cam = camera_world_rotation(cam_rot_deg)  # (..., 3, 3)
        rel_gl = torch.einsum("...ji,...tj->...ti", R_cam, rel_gl)
        R_tag_eye = torch.einsum("...ji,tjk->...tik", R_cam, R_tag)
    else:
        R_tag_eye = R_tag.expand(cam_pos.shape[:-1] + R_tag.shape)
    rel_cv = torch.einsum("ij,...tj->...ti", flip, rel_gl)
    R_cv = torch.einsum("ij,...tjk->...tik", flip, R_tag_eye)
    return make_se3(R_cv, rel_cv)


def camera_in_tag_frames(
    tag_pos: torch.Tensor,
    tag_rot_deg: torch.Tensor,
    cam_pos: torch.Tensor,
    cam_rot_deg: torch.Tensor | None = None,
) -> torch.Tensor:
    """Camera pose in each tag's frame (..., T, 4, 4): the SLAM ground truth."""
    return se3_inverse(camera_to_tag_transforms(tag_pos, tag_rot_deg, cam_pos, cam_rot_deg))


def tag_distances_from_camera(tag_pos: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """(..., T) Euclidean distances."""
    return torch.linalg.norm(tag_pos - cam_pos[..., None, :], dim=-1)


def tag_to_tag_distance(tag_pos: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """World distance between two tags."""
    return torch.linalg.norm(tag_pos[i] - tag_pos[j], dim=-1)


def closest_tag(tag_pos: torch.Tensor, cam_pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, distance) of the nearest tag, each (...,)."""
    d = tag_distances_from_camera(tag_pos, cam_pos)
    idx = torch.argmin(d, dim=-1)
    return idx, torch.gather(d, -1, idx[..., None])[..., 0]


def visibility_by_distance(
    tag_pos: torch.Tensor, cam_pos: torch.Tensor, max_distance: float = 10.0
) -> torch.Tensor:
    """(..., T) bool visibility gate."""
    return tag_distances_from_camera(tag_pos, cam_pos) <= max_distance


def tags_unoccluded(
    tag_pos: torch.Tensor,  # (T, 3) GL world
    tag_rot_deg: torch.Tensor,  # (T, 3)
    cam_pos: torch.Tensor,  # (B, 3)
    inner_size: float,
    outer_half: float,
    eps: float = 1e-3,
) -> torch.Tensor:
    """(B, T) bool: no OTHER tag's rendered quad blocks the camera's view of
    any of this tag's 5 sample points (inner-border corners + centre).

    Segment-vs-quad intersection against every other tag's OUTER quad,
    batched as one (B, T, 5, S, 3) tensor on the inputs' device."""
    T = tag_pos.shape[0]
    R_w_tag = tag_world_rotations(tag_rot_deg)  # (T, 3, 3)
    half = inner_size / 2.0
    local = torch.tensor(
        [[-half, -half, 0.0], [half, -half, 0.0], [half, half, 0.0], [-half, half, 0.0], [0.0, 0.0, 0.0]],
        dtype=tag_pos.dtype, device=tag_pos.device,
    )  # (5, 3)
    # Sample points on each tag, world frame: (T, 5, 3)
    P = torch.einsum("tij,pj->tpi", R_w_tag, local) + tag_pos[:, None, :]
    n = R_w_tag[:, :, 2]  # (S, 3) occluder plane normals
    C = cam_pos  # (B, 3)
    d = P[None, :, :, :] - C[:, None, None, :]  # (B, T, 5, 3)
    num = torch.einsum("si,si->s", n, tag_pos)[None, :] - torch.einsum("si,bi->bs", n, C)  # (B, S)
    den = torch.einsum("si,btpi->btps", n, d)  # (B, T, 5, S)
    tau = num[:, None, None, :] / torch.where(torch.abs(den) < 1e-9, 1e-9, den)
    hit = C[:, None, None, None, :] + tau[..., None] * d[:, :, :, None, :]  # (B, T, 5, S, 3)
    # World -> occluder-local coordinates: R^T through the "sji" index order.
    q = torch.einsum("sji,btpsj->btpsi", R_w_tag, hit - tag_pos[None, None, None, :, :])
    inside = (torch.abs(q[..., 0]) <= outer_half) & (torch.abs(q[..., 1]) <= outer_half)
    blocking = inside & (tau > eps) & (tau < 1.0 - eps) & (torch.abs(den) >= 1e-9)
    # A tag never occludes itself.
    not_self = ~torch.eye(T, dtype=torch.bool, device=tag_pos.device)[None, :, None, :]
    blocked = torch.any((blocking & not_self).flatten(-2), dim=-1)  # (B, T)
    return ~blocked
