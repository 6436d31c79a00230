"""Batched tag rasterizer (port of ``aprilslam_tpu/sim/rasterizer.py``).

Each tag is a textured plane; for every pixel ray the plane-induced inverse
homography ``G = [r0 r1 t]^-1 K^-1`` maps pixel homogeneous coordinates to
tag-local coordinates, the cell grid is point-sampled (supersampled for
antialiasing), and a z-buffer test across tags resolves occlusion. All math
is in the CV camera frame; frames are produced directly on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..families import TagFamily, get_family
from .config import SceneConfig
from .ground_truth import camera_to_tag_transforms


@dataclass(frozen=True)
class SceneTensors:
    """Device-ready scene tensors (T = number of tags)."""

    textures: torch.Tensor  # (T, C, C) float32 cell grids in [0, 1]
    tag_pos: torch.Tensor  # (T, 3) GL world
    tag_rot: torch.Tensor  # (T, 3) degrees
    tag_ids: torch.Tensor  # (T,) int32 family ids
    outer_half: float  # rendered quad half-size (sim units)
    inner_size: float  # detected border square size (PnP tag_size)
    background: float
    near_clip: float
    far_clip: float

    @property
    def num_tags(self) -> int:
        return int(self.textures.shape[0])

    @property
    def cells(self) -> int:
        return int(self.textures.shape[1])

    def to(self, device: torch.device) -> "SceneTensors":
        return SceneTensors(
            self.textures.to(device), self.tag_pos.to(device), self.tag_rot.to(device),
            self.tag_ids.to(device), self.outer_half, self.inner_size, self.background,
            self.near_clip, self.far_clip,
        )


def scene_tensors(config: SceneConfig, family: TagFamily | None = None,
                  device: str | torch.device | None = None) -> SceneTensors:
    dev = resolve_device(device)
    family = family or get_family(config.family)
    ids = config.tag_ids()
    return SceneTensors(
        textures=torch.as_tensor(family.grids[ids].astype("float32"), device=dev),
        tag_pos=torch.as_tensor(config.tag_positions(), device=dev),
        tag_rot=torch.as_tensor(config.tag_rotations(), device=dev),
        tag_ids=torch.as_tensor(ids, device=dev),
        outer_half=config.tag_size_outer / 2.0,
        inner_size=config.tag_size_inner,
        background=config.background,
        near_clip=config.near_clip,
        far_clip=config.far_clip,
    )


def render_frames(
    scene: SceneTensors,
    cam_pos,  # (B, 3) GL world
    cam_rot,  # (B, 3) [pitch, yaw, roll] deg
    K_inv,  # (3, 3)
    height: int,
    width: int,
    supersample: int = 2,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Render (B, height, width) float32 grayscale frames in [0, 1]."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    f32 = torch.float32
    cam_pos = torch.as_tensor(cam_pos, dtype=f32, device=dev)
    cam_rot = torch.as_tensor(cam_rot, dtype=f32, device=dev)
    K_inv = torch.as_tensor(K_inv, dtype=f32, device=dev)
    B = cam_pos.shape[0]
    T = scene.num_tags
    C = scene.cells
    h = scene.outer_half

    T_cam_tag = camera_to_tag_transforms(scene.tag_pos, scene.tag_rot, cam_pos, cam_rot)
    R = T_cam_tag[..., :3, :3]  # (B, T, 3, 3)
    t = T_cam_tag[..., :3, 3]  # (B, T, 3)
    Hmat = torch.stack([R[..., :, 0], R[..., :, 1], t], dim=-1)  # (B, T, 3, 3)
    G = torch.linalg.inv_ex(Hmat).inverse @ K_inv  # pixel -> tag local
    flat_tex = scene.textures.reshape(T, C * C)

    row_v = torch.arange(height, dtype=f32, device=dev)[:, None].expand(height, width)
    col_u = torch.arange(width, dtype=f32, device=dev)[None, :].expand(height, width)

    def sample_offset(du: float, dv: float) -> torch.Tensor:
        u = col_u + du
        v = row_v + dv
        best_val = torch.full((B, height, width), scene.background, dtype=f32, device=dev)
        best_depth = torch.full((B, height, width), float("inf"), dtype=f32, device=dev)
        for ti in range(T):
            Gt = G[:, ti, :, :, None, None]  # (B, 3, 3, 1, 1)
            q0 = Gt[:, 0, 0] * u + Gt[:, 0, 1] * v + Gt[:, 0, 2]
            q1 = Gt[:, 1, 0] * u + Gt[:, 1, 1] * v + Gt[:, 1, 2]
            q2 = Gt[:, 2, 0] * u + Gt[:, 2, 1] * v + Gt[:, 2, 2]
            inv_q2 = torch.where(torch.abs(q2) < 1e-12, 0.0, 1.0 / q2)
            a = q0 * inv_q2
            b = q1 * inv_q2
            Rt = R[:, ti, :, :, None, None]
            tt = t[:, ti, :, None, None]
            depth = a * Rt[:, 2, 0] + b * Rt[:, 2, 1] + tt[:, 2]
            inside = (torch.abs(a) <= h) & (torch.abs(b) <= h)
            valid = inside & (depth > scene.near_clip) & (depth < scene.far_clip) & (q2 != 0.0)
            # Tag-local -> cell index. Local +b (tag-frame y up) is grid row 0.
            colf = torch.clamp(torch.floor((a + h) / (2 * h) * C), 0, C - 1)
            rowf = torch.clamp(torch.floor((h - b) / (2 * h) * C), 0, C - 1)
            idx = (rowf * C + colf).to(torch.int64)
            val = flat_tex[ti][idx]
            closer = valid & (depth < best_depth)
            best_val = torch.where(closer, val, best_val)
            best_depth = torch.where(closer, depth, best_depth)
        return best_val

    ss = supersample
    acc = torch.zeros((B, height, width), dtype=f32, device=dev)
    for i in range(ss):
        for j in range(ss):
            acc = acc + sample_offset((j + 0.5) / ss, (i + 0.5) / ss)
    return acc / (ss * ss)
