"""Preprocessing + adaptive thresholding, detector stage 1
(port of ``aprilslam_tpu/detect/threshold.py``).

Output is a trinary int8 map: +1 white, 0 black, -1 unknown (insufficient
local contrast) — unknown pixels neither join components nor form
boundaries — plus the float32 local threshold level.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BGR_WEIGHTS = (0.114, 0.587, 0.299)  # cv2 BGR2GRAY convention


def to_grayscale(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, 3]) uint8/float -> (B, H, W) float32 in [0, 1].

    uint8 is scaled by the float32 reciprocal of 255, which is what the
    reference's compiled graph computes for its division (bit-equal)."""
    if frames.dtype == torch.uint8:
        frames = frames.to(torch.float32) * (1.0 / 255.0)
    frames = frames.to(torch.float32)
    if frames.dim() == 4:
        w = torch.tensor(BGR_WEIGHTS, dtype=torch.float32, device=frames.device)
        frames = torch.einsum("bhwc,c->bhw", frames, w)
    return frames


def decimate(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool by an integer factor (apriltag's quad_decimate).

    Two float32 matmuls with block-diagonal averaging matrices, rows first —
    the contraction order the reference's einsum takes, which makes the
    result bit-equal to it (the other order rounds differently).
    """
    if factor == 1:
        return frames
    B, H, W = frames.shape
    Hd, Wd = H // factor, W // factor
    dr = np.zeros((Hd, H), np.float32)
    dr[np.arange(Hd * factor) // factor, np.arange(Hd * factor)] = 1.0 / factor
    dc = np.zeros((W, Wd), np.float32)
    dc[np.arange(Wd * factor), np.arange(Wd * factor) // factor] = 1.0 / factor
    x = frames.to(torch.float32)
    rows = torch.matmul(torch.as_tensor(dr, device=x.device), x)
    return torch.matmul(rows, torch.as_tensor(dc, device=x.device))


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    return F.pad(x[:, None], (left, right, top, bottom), mode="replicate")[:, 0]


def _tile_minmax(frames: torch.Tensor, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile min/max, then min/max over the 3x3 tile neighbourhood."""
    B, H, W = frames.shape
    Ht, Wt = H // tile, W // tile
    x = frames[:, : Ht * tile, : Wt * tile].reshape(B, Ht, tile, Wt, tile)
    tmin = x.amin(dim=(2, 4))
    tmax = x.amax(dim=(2, 4))

    def neigh(t, op):
        pads = _pad_edge(t, 1, 1, 1, 1)
        out = t
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                out = op(out, pads[:, 1 + dy : 1 + dy + Ht, 1 + dx : 1 + dx + Wt])
        return out

    return neigh(tmin, torch.minimum), neigh(tmax, torch.maximum)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """Separable 3x3 box mean with edge padding."""
    xp = _pad_edge(x, 1, 1, 0, 0)
    x = (xp[:, :-2] + xp[:, 1:-1] + xp[:, 2:]) * (1.0 / 3.0)
    xp = _pad_edge(x, 0, 0, 1, 1)
    return (xp[:, :, :-2] + xp[:, :, 1:-1] + xp[:, :, 2:]) * (1.0 / 3.0)


def estimate_noise_sigma(frames: torch.Tensor) -> torch.Tensor:
    """Robust per-frame noise sigma from horizontal first differences of a
    4x-subsampled frame. Returns (B,). The median of an even count is the
    mean of the two middle values, as ``jnp.median`` takes it
    (``torch.median`` would return the lower one)."""
    B = frames.shape[0]
    sub = frames[:, ::4, ::4]
    d = torch.abs(sub[:, :, 1:] - sub[:, :, :-1]).reshape(B, -1)
    s, _ = torch.sort(d, dim=-1)
    n = s.shape[-1]
    if n % 2:
        med = s[:, n // 2]
    else:
        med = 0.5 * s[:, n // 2 - 1] + 0.5 * s[:, n // 2]
    return med / 0.954


def adaptive_threshold_with_levels(
    frames: torch.Tensor,
    tile: int = 4,
    min_contrast: float = 0.1,
    smooth: bool = True,
    noise_adapt: bool = True,
    noise_mult: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) float32 -> (trinary int8, local threshold level float32).

    Neighbourhood tile min/max thresholding at (min+max)/2 on a 3x3
    box-smoothed copy, with low-contrast tiles marked unknown; the contrast
    floor rises to ``noise_mult`` x the frame's estimated noise sigma.
    """
    B, H, W = frames.shape
    stats_src = _box3(frames) if smooth else frames
    nmin, nmax = _tile_minmax(stats_src, tile)
    up_min = nmin.repeat_interleave(tile, dim=1).repeat_interleave(tile, dim=2)
    up_max = nmax.repeat_interleave(tile, dim=1).repeat_interleave(tile, dim=2)
    if up_min.shape[1] < H or up_min.shape[2] < W:
        dh, dw = H - up_min.shape[1], W - up_min.shape[2]
        up_min = _pad_edge(up_min, 0, dh, 0, dw)
        up_max = _pad_edge(up_max, 0, dh, 0, dw)
    mid = 0.5 * (up_min + up_max)
    white = stats_src > mid
    if noise_adapt:
        floor = torch.clamp(noise_mult * estimate_noise_sigma(frames), min=min_contrast)
        known = (up_max - up_min) >= floor[:, None, None]
    else:
        known = (up_max - up_min) >= min_contrast
    trinary = torch.where(known, white.to(torch.int8), torch.full_like(white, -1, dtype=torch.int8))
    return trinary, mid


def adaptive_threshold(frames: torch.Tensor, tile: int = 4, min_contrast: float = 0.1) -> torch.Tensor:
    """Trinary threshold map only (see adaptive_threshold_with_levels)."""
    return adaptive_threshold_with_levels(frames, tile, min_contrast)[0]
