"""Homography estimation + tag decoding, detector stages 4-5
(port of ``aprilslam_tpu/detect/decode.py``).

Each quad's sampled cell intensities become a +-1 vector multiplied against
the family's (4 rotations x N codes) template matrix; the argmax is the
(id, rotation) decision and the max score encodes the Hamming distance
(score = D - 2 * hamming). The product stays in float32, where sums of +-1
are exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..families import TagFamily
from .quads import QuadCandidates

# Canonical quad-frame corners in lb, rb, rt, lt order (y DOWN).
CANON = np.array([[-1.0, 1.0], [1.0, 1.0], [1.0, -1.0], [-1.0, -1.0]], dtype=np.float32)


@dataclass(frozen=True)
class Detections:
    """Padded per-frame detections, sorted by tag id."""

    ids: torch.Tensor  # (B, D) int32, -1 where invalid
    corners: torch.Tensor  # (B, D, 4, 2) pixel coords in lb-rb-rt-lt order
    valid: torch.Tensor  # (B, D) bool
    hamming: torch.Tensor  # (B, D) int32 decode bit errors
    margin: torch.Tensor  # (B, D) float32 best-vs-second decode margin (bits*2)
    homography: torch.Tensor  # (B, D, 3, 3) quad frame [-1,1]^2 -> pixels

    @property
    def max_detections(self) -> int:
        return int(self.ids.shape[1])

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


def homography_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """DLT for the 4-point homography quad frame -> pixels.

    corners (..., 4, 2) in cyclic order aligned with CANON -> (..., 3, 3)
    with H[2,2] = 1. Degenerate corner sets (padding) give non-finite
    entries, as in the reference, instead of raising."""
    mean = corners.mean(dim=-2, keepdim=True)
    scale = torch.abs(corners - mean).mean(dim=(-2, -1), keepdim=True) + 1e-6
    cn = (corners - mean) / scale
    a = torch.as_tensor(CANON[:, 0], device=corners.device)
    b = torch.as_tensor(CANON[:, 1], device=corners.device)
    u = cn[..., 0]
    v = cn[..., 1]
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    r1 = torch.stack([a * ones, b * ones, ones, zeros, zeros, zeros, -u * a, -u * b], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, a * ones, b * ones, ones, -v * a, -v * b], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 8, 8)
    rhs = torch.cat([u, v], dim=-1)[..., None]  # (..., 8, 1)
    h = torch.linalg.solve_ex(A, rhs).result[..., 0]
    H = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(h.shape[:-1] + (3, 3))
    s = scale[..., 0, 0]
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    row0 = s[..., None] * H[..., 0, :] + mx[..., None] * H[..., 2, :]
    row1 = s[..., None] * H[..., 1, :] + my[..., None] * H[..., 2, :]
    return torch.stack([row0, row1, H[..., 2, :]], dim=-2)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., P, 2) -> (..., P, 2)."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = torch.einsum("...ij,...pj->...pi", H, p)
    return q[..., :2] / (q[..., 2:3] + 1e-12)


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W) images at continuous pixel coords (pixel centre at
    +0.5), clamped at the borders. uv (B, ..., 2) -> (B, ...)."""
    B, H, W = image.shape
    x = uv[..., 0] - 0.5
    y = uv[..., 1] - 0.5
    # Non-finite coordinates (degenerate padding quads) sample a NaN-weighted
    # border pixel instead of indexing out of bounds.
    x0 = torch.clamp(torch.nan_to_num(torch.floor(x), nan=0.0), 0, W - 2)
    y0 = torch.clamp(torch.nan_to_num(torch.floor(y), nan=0.0), 0, H - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    flat = image.reshape(B, -1)
    i00 = (y0 * W + x0).reshape(B, -1)
    i10 = ((y0 + 1) * W + x0).reshape(B, -1)

    def at(idx):
        return torch.gather(flat, 1, idx).reshape(x.shape)

    top0, top1 = at(i00), at(i00 + 1)
    bot0, bot1 = at(i10), at(i10 + 1)
    return (top0 * (1 - fy) + bot0 * fy) * (1 - fx) + (top1 * (1 - fy) + bot1 * fy) * fx


class FamilyTensors:
    """Device-side constants derived from a TagFamily (built once)."""

    def __init__(self, family: TagFamily, device: str | torch.device = "cpu"):
        self.family = family
        tmpl, meta = family.codebook()
        self.templates = torch.as_tensor(tmpl, device=device)  # (4N, D)
        self.meta = torch.as_tensor(meta, device=device)  # (4N, 2) (id, rot)
        centers = family.cell_centers_quad_frame()  # (C, C, 2)
        mask = family.sample_mask()
        black, white = family.border_rings()
        self.sample_pts = torch.as_tensor(centers.reshape(-1, 2), device=device)
        self.mask_flat = torch.as_tensor(mask.reshape(-1).astype(np.float32), device=device)
        self.black_flat = torch.as_tensor(black.reshape(-1).astype(np.float32), device=device)
        self.white_flat = torch.as_tensor(white.reshape(-1).astype(np.float32), device=device)
        self.mask_idx = torch.as_tensor(np.nonzero(mask.reshape(-1))[0].astype(np.int64), device=device)
        self.n_codes = family.n_codes
        self.d_bits = int(mask.sum())


def decode_quads(
    gray: torch.Tensor,  # (B, H, W) full-res grayscale
    quads: QuadCandidates,
    fam: FamilyTensors,
    max_hamming: int = 3,
    min_level_contrast: float = 0.06,
    max_detections: int = 32,
) -> Detections:
    B, Q = quads.valid.shape
    dev = gray.device
    H = homography_from_corners(quads.corners)  # (B, Q, 3, 3)
    uv = apply_homography(H, fam.sample_pts.expand((B, Q) + fam.sample_pts.shape))
    samples = bilinear_sample(gray, uv)  # (B, Q, C*C)

    black = (samples * fam.black_flat).sum(-1) / fam.black_flat.sum()
    white = (samples * fam.white_flat).sum(-1) / fam.white_flat.sum()
    mid = 0.5 * (black + white)
    contrast_ok = (white - black) >= min_level_contrast

    bits_all = torch.where(samples > mid[..., None], 1.0, -1.0)
    bits = bits_all[..., fam.mask_idx]  # (B, Q, D)
    scores = torch.einsum("bqd,nd->bqn", bits, fam.templates)  # (B, Q, 4N)
    # Top-2 as lax.top_k gives it: the best is the first maximum; the
    # second is the maximum of the rest (equal to the best on a tie).
    best_val, best = torch.max(scores, dim=-1)
    second = scores.scatter(-1, best[..., None], -float("inf")).amax(dim=-1)
    margin = best_val - second
    ids = fam.meta[best, 0]
    rots = fam.meta[best, 1]
    hamming = ((fam.d_bits - best_val) * 0.5).to(torch.int32)

    ok = quads.valid & contrast_ok & (hamming <= max_hamming)

    # Rotate corner order so entry j is the decoded tag's canonical corner j.
    j = torch.arange(4, device=dev)[None, None, :]
    perm = (j + rots[..., None].to(torch.int64)) % 4
    corners = torch.gather(quads.corners, 2, perm[..., None].expand(perm.shape + (2,)))

    # Dedup: among same-id detections in a frame keep the best margin.
    q = torch.arange(Q, device=dev)
    same = (ids[:, :, None] == ids[:, None, :]) & ok[:, :, None] & ok[:, None, :]
    better = (margin[:, None, :] > margin[:, :, None]) | (
        (margin[:, None, :] == margin[:, :, None]) & (q[None, None, :] < q[None, :, None])
    )
    ok = ok & ~torch.any(same & better, dim=-1)

    # Sort by id ascending (invalid last, stable) and truncate.
    key = torch.where(ok, ids, 2**30)
    order = torch.argsort(key, dim=-1, stable=True)[:, :max_detections]

    def take(a):
        idx = order.reshape(order.shape + (1,) * (a.dim() - 2)).expand(order.shape + a.shape[2:])
        return torch.gather(a, 1, idx)

    ok_o = take(ok)
    return Detections(
        ids=torch.where(ok_o, take(ids), -1).to(torch.int32),
        corners=take(corners),
        valid=ok_o,
        hamming=take(hamming),
        margin=take(margin),
        homography=take(H),
    )
