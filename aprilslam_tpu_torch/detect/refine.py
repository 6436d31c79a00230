"""Full-resolution edge refinement of detected tag corners
(port of ``aprilslam_tpu/detect/refine.py``).

Quad corners are fit on the decimated image; this re-localizes each edge on
the full-resolution frame: ``ns`` points per edge probe the gray image
along the edge normal (a coarse then a fine tap comb), the |gradient|-
weighted mean offset is the subpixel edge crossing, a weighted TLS line is
fit per edge and adjacent lines are intersected. A corner whose refinement
jumped too far or lacked gradient mass keeps its input position.
"""

from __future__ import annotations

import torch

from .decode import bilinear_sample
from .quads import _line_fit_corners


def refine_corners(
    gray: torch.Tensor,  # (B, H, W) full-resolution grayscale
    corners: torch.Tensor,  # (B, D, 4, 2) cyclic quad corners, full-res px
    valid: torch.Tensor,  # (B, D) bool
    ns: int = 12,
    half_range: float = 2.0,
    taps: int = 9,
    max_shift: float = 3.0,
) -> torch.Tensor:
    """Refine quad corners on the full-res image. Returns (B, D, 4, 2)."""
    dev, dt = gray.device, gray.dtype
    u = torch.linspace(0.12, 0.88, ns, dtype=dt, device=dev)

    def edge_probe(pts, nrm, hr, ntaps):
        """|grad|-weighted subpixel edge offset along nrm at each point."""
        t = torch.linspace(-hr, hr, ntaps, dtype=dt, device=dev)
        samp = pts[..., None, :] + nrm[..., None, None, :] * t[:, None]  # (B, D, 4, ns, taps, 2)
        vals = bilinear_sample(gray, samp)
        gw = torch.abs(vals[..., 2:] - vals[..., :-2])  # central differences
        wsum = gw.sum(-1)
        toff = (gw * t[1:-1]).sum(-1) / (wsum + 1e-9)
        return toff, wsum

    p0 = corners
    e = torch.roll(corners, -1, dims=-2) - p0
    elen = torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-9
    nrm = torch.stack([-e[..., 1], e[..., 0]], dim=-1) / elen  # (B, D, 4, 2)
    pts = p0[..., None, :] + e[..., None, :] * u[:, None]  # (B, D, 4, ns, 2)
    toff, _ = edge_probe(pts, nrm, half_range, taps)
    pts1 = pts + nrm[..., None, :] * toff[..., None]
    toff2, wsum = edge_probe(pts1, nrm, 0.75, 7)
    newpts = pts1 + nrm[..., None, :] * toff2[..., None]

    _, _, new_c = _line_fit_corners(newpts, wsum)
    swsum = wsum.sum(-1) + 1e-9  # (B, D, 4)
    edge_okay = (swsum > 1e-3) & (torch.roll(swsum, 1, dims=-1) > 1e-3)
    shift = torch.linalg.norm(new_c - corners, dim=-1)
    keep = edge_okay & (shift <= max_shift) & torch.all(torch.isfinite(new_c), dim=-1)
    out = torch.where(keep[..., None], new_c, corners)
    return torch.where(valid[..., None, None], out, corners)
