"""A frozen copy of the simulator's tag rasterizer, on the card.

Each tag is a textured plane; for every pixel ray the plane's inverse
homography ``[r0 r1 t]^-1 K^-1`` maps the pixel to tag-local coordinates,
the cell grid is point-sampled (2x2 supersampled), and a depth test across
tags resolves occlusion. Frames come out as uint8 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.inputs.scene import Scene, family_grids
from perfbench.reference.geometry import camera_to_tag


def render_u8(scene: Scene, cam_pos: np.ndarray, cam_rot: np.ndarray, K: np.ndarray, height: int,
              width: int, device: torch.device, batch: int = 32, supersample: int = 2) -> torch.Tensor:
    """(N, height, width) uint8 frames of the camera poses, rendered on ``device``."""
    f32 = torch.float32
    tex = torch.as_tensor(family_grids(scene.tag_ids()), device=device)
    T, C = tex.shape[0], tex.shape[1]
    flat_tex = tex.reshape(T, C * C)
    tag_pos = torch.as_tensor(scene.tag_positions(), device=device)
    tag_rot = torch.as_tensor(scene.tag_rotations(), device=device)
    K_inv = torch.as_tensor(np.linalg.inv(K), dtype=f32, device=device)
    h = scene.tag_size_outer / 2.0
    row_v = torch.arange(height, dtype=f32, device=device)[:, None].expand(height, width)
    col_u = torch.arange(width, dtype=f32, device=device)[None, :].expand(height, width)
    out = torch.empty((len(cam_pos), height, width), dtype=torch.uint8, device=device)
    for s in range(0, len(cam_pos), batch):
        cp = torch.as_tensor(cam_pos[s:s + batch], dtype=f32, device=device)
        cr = torch.as_tensor(cam_rot[s:s + batch], dtype=f32, device=device)
        B = cp.shape[0]
        T_ct = camera_to_tag(tag_pos, tag_rot, cp, cr)
        R, t = T_ct[..., :3, :3], T_ct[..., :3, 3]
        G = torch.linalg.inv(torch.stack([R[..., :, 0], R[..., :, 1], t], dim=-1)) @ K_inv  # (B, T, 3, 3)
        acc = torch.zeros((B, height, width), dtype=f32, device=device)
        for i in range(supersample):
            for j in range(supersample):
                u = col_u + (j + 0.5) / supersample
                v = row_v + (i + 0.5) / supersample
                best_val = torch.full((B, height, width), scene.background, dtype=f32, device=device)
                best_depth = torch.full((B, height, width), float("inf"), dtype=f32, device=device)
                for ti in range(T):
                    g = G[:, ti, :, :, None, None]
                    q0 = g[:, 0, 0] * u + g[:, 0, 1] * v + g[:, 0, 2]
                    q1 = g[:, 1, 0] * u + g[:, 1, 1] * v + g[:, 1, 2]
                    q2 = g[:, 2, 0] * u + g[:, 2, 1] * v + g[:, 2, 2]
                    inv_q2 = torch.where(torch.abs(q2) < 1e-12, 0.0, 1.0 / q2)
                    a = q0 * inv_q2
                    b = q1 * inv_q2
                    Rt = R[:, ti, :, :, None, None]
                    depth = a * Rt[:, 2, 0] + b * Rt[:, 2, 1] + t[:, ti, 2, None, None]
                    inside = (torch.abs(a) <= h) & (torch.abs(b) <= h)
                    valid = inside & (depth > scene.near_clip) & (depth < scene.far_clip) & (q2 != 0.0)
                    colf = torch.clamp(torch.floor((a + h) / (2 * h) * C), 0, C - 1)
                    rowf = torch.clamp(torch.floor((h - b) / (2 * h) * C), 0, C - 1)
                    val = flat_tex[ti][(rowf * C + colf).to(torch.int64)]
                    closer = valid & (depth < best_depth)
                    best_val = torch.where(closer, val, best_val)
                    best_depth = torch.where(closer, depth, best_depth)
                acc = acc + best_val
        out[s:s + B] = torch.clamp(acc / (supersample * supersample) * 255.0, 0, 255).to(torch.uint8)
    return out
