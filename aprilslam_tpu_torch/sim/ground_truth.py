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
