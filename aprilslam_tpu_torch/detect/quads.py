"""Quad extraction: boundary clustering + corner fitting, detector stage 3
(port of ``aprilslam_tpu/detect/quads.py``).

* **Clustering = sort.** Every black/white neighbouring pixel pair emits a
  boundary point keyed by its (black label, white label) pair; a stable sort
  by (key, position) groups each physical quad's points contiguously, and
  segment reductions give per-cluster statistics.
* **Corner finding = extremal geometry**, then two rounds of
  assign-points-to-sides + weighted total-least-squares line fits + line
  intersections for subpixel corners.

The port matches the reference's outputs, not its TPU formulation: the
compaction is a cumsum + scatter and the segment statistics are
``scatter_reduce``s. The reference's unstable sort leaves the order of the
points inside a cluster open; the port puts them in a fixed scrambled order
(see ``_cluster``), the same on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

BIG = 2**30


@dataclass(frozen=True)
class QuadCandidates:
    corners: torch.Tensor  # (B, Q, 4, 2) full-res pixel coords, cyclic order
    valid: torch.Tensor  # (B, Q) bool
    fit_err: torch.Tensor  # (B, Q) rms line-fit residual (decimated px)
    cluster_size: torch.Tensor  # (B, Q) boundary point count


def _topk_stable(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` along the last axis, ties broken toward the lower index
    (``lax.top_k``'s order; ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _emit_boundaries(trinary, labels, gray, level):
    """Boundary points between black and white components, per frame.

    Edge positions are subpixel: the point sits where the intensity crosses
    the local threshold ``level`` between the two pixel centres.
    Returns (key_black, key_white, x, y, w), each (B, 2*H*W); entries that
    are no boundary carry the key BIG."""
    B, H, W = trinary.shape
    dev = trinary.device

    def pairs(axis, x0, y0, dx, dy, lvl_pair, edge_ok):
        c0, l0, g0 = trinary, labels, gray
        c1 = torch.roll(c0, -1, dims=axis)
        l1 = torch.roll(l0, -1, dims=axis)
        g1 = torch.roll(g0, -1, dims=axis)
        boundary = edge_ok & (c0 >= 0) & (c1 >= 0) & (c0 != c1)
        black = torch.where(c0 == 0, l0, l1)
        white = torch.where(c0 == 0, l1, l0)
        ka = torch.where(boundary, black, BIG)
        kb = torch.where(boundary, white, BIG)
        w = torch.where(boundary, torch.abs(g0 - g1), 0.0)
        denom = g1 - g0
        flat = torch.abs(denom) < 1e-6
        t = torch.where(flat, 0.5, (lvl_pair - g0) / torch.where(flat, 1.0, denom))
        t = torch.clamp(t, 0.0, 1.0)
        return ka, kb, x0 + t * dx, y0 + t * dy, w

    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, None, :].expand(B, H, W)
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[None, :, None].expand(B, H, W)
    col = torch.arange(W, device=dev)[None, None, :]
    row = torch.arange(H, device=dev)[None, :, None]

    lvl_r = 0.5 * (level + torch.roll(level, -1, dims=2))
    right = pairs(2, xs, ys, 1.0, 0.0, lvl_r, col < W - 1)
    lvl_d = 0.5 * (level + torch.roll(level, -1, dims=1))
    down = pairs(1, xs, ys, 0.0, 1.0, lvl_d, row < H - 1)
    return tuple(torch.cat([a.reshape(B, -1), b.reshape(B, -1)], dim=1) for a, b in zip(right, down))


def _compact(ka, kb, x, y, w, max_boundary: int):
    """Move the first ``max_boundary`` boundary entries of each frame, in
    order, to a fixed-size prefix (B, max_boundary). Slots past the count
    carry key BIG and weight 0."""
    B, N = ka.shape
    valid = ka < BIG
    pos = torch.cumsum(valid, dim=1) - 1
    dest = torch.where(valid & (pos < max_boundary), pos, max_boundary)

    def place(v, fill):
        out = torch.full((B, max_boundary + 1), fill, dtype=v.dtype, device=v.device)
        return out.scatter_(1, dest, v)[:, :max_boundary]

    # Non-boundary entries all land in the dropped overflow slot.
    return place(ka, BIG), place(kb, BIG), place(x, 0.0), place(y, 0.0), place(w, 0.0)


def _mix32(i: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (xor-shift-multiply) of int64 ``i``."""
    for _ in range(2):
        i = ((i >> 16) ^ i) * 0x45D9F3B & 0xFFFFFFFF
    return (i >> 16) ^ i


def _cluster(ka, kb, x, y, w, max_clusters: int, min_pts: int = 1):
    """Sort each frame's points by (black, white) key pair and compute
    per-cluster stats. Inputs (B, n). Returns the sorted (x, y, w) and a dict
    of (B, max_clusters) count/start/bbox, clusters ranked by size (largest
    first, ties to the earlier run) so noise specks are evicted first.

    Inside a cluster the points follow a fixed hash of their slot, not the
    emission order: emission interleaves the two sides of a quad row by row
    (left, right, left, ...), and the stride subsample in
    :func:`quad_candidates` would then take every point of one side and none
    of the other (an axis-aligned tag of 2 * ``pts_per_quad`` points loses a
    whole side and its fit diverges)."""
    B, n = ka.shape
    scramble = torch.argsort(_mix32(torch.arange(n, device=ka.device)), stable=True)
    key = (ka.to(torch.int64) * (2**31) + kb.to(torch.int64))[:, scramble]
    key_s, perm = torch.sort(key, dim=1, stable=True)
    perm = scramble[perm]
    x_s = torch.gather(x, 1, perm)
    y_s = torch.gather(y, 1, perm)
    w_s = torch.gather(w, 1, perm)
    valid = torch.gather(ka, 1, perm) < BIG
    new_seg = torch.ones_like(valid)
    new_seg[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    seg = torch.cumsum(new_seg, dim=1) - 1  # run number of each element

    size = torch.zeros((B, n), dtype=torch.int64, device=ka.device).scatter_add_(
        1, seg, torch.ones_like(seg))
    size_elt = torch.gather(size, 1, seg)

    def seg_reduce(v, op, init):
        out = torch.full((B, n), init, dtype=v.dtype, device=v.device)
        return out.scatter_reduce_(1, seg, v, reduce=op, include_self=False)

    xmin, xmax = seg_reduce(x_s, "amin", math.inf), seg_reduce(x_s, "amax", -math.inf)
    ymin, ymax = seg_reduce(y_s, "amin", math.inf), seg_reduce(y_s, "amax", -math.inf)

    # Only a run's first element scores, so the top-k yields run starts.
    score = torch.where(new_seg & valid & (size_elt >= min_pts), size_elt.to(torch.float32), -1.0)
    top_sz, top_pos = _topk_stable(score, max_clusters)
    sel = top_sz > 0
    top_seg = torch.gather(seg, 1, top_pos)
    inf = torch.full_like(top_sz, math.inf)

    def at_top(v, fill):
        return torch.where(sel, torch.gather(v, 1, top_seg), fill)

    return (x_s, y_s, w_s), dict(
        count=torch.where(sel, top_sz, 0.0),
        start=torch.where(sel, top_pos, n),
        xmin=at_top(xmin, inf),
        xmax=at_top(xmax, -inf),
        ymin=at_top(ymin, inf),
        ymax=at_top(ymax, -inf),
    )


def _take(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts (..., P, 2), idx (...) -> (..., 2)."""
    return torch.gather(pts, -2, idx[..., None, None].expand(idx.shape + (1, 2)))[..., 0, :]


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floor modulo with the sign of the divisor, as ``jnp.mod`` computes it."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _sort_by_angle(corners: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Order (..., 4, 2) corners by descending angle around c (..., 2)."""
    ang = torch.atan2(corners[..., 1] - c[..., None, 1], corners[..., 0] - c[..., None, 0])
    order = torch.argsort(-ang, dim=-1, stable=True)
    return torch.gather(corners, -2, order[..., None].expand(order.shape + (2,)))


def _line_fit_corners(pts: torch.Tensor, sw: torch.Tensor):
    """Weighted TLS line per side and the corner intersections.

    pts (..., S, P, 2) side points, sw (..., S, P) weights with S = 4 sides.
    Returns (normals (..., 4, 2), offsets (..., 4), corners (..., 4, 2)) with
    corner k the intersection of side k-1 and side k."""
    swsum = sw.sum(-1, keepdim=True) + 1e-9
    mu = (pts * sw[..., None]).sum(-2) / swsum
    return _lines_from_moments(pts, sw, mu)


def _lines_from_moments(pts, sw, mu):
    d = pts - mu[..., None, :]
    a = (sw * d[..., 0] ** 2).sum(-1)
    b = (sw * d[..., 0] * d[..., 1]).sum(-1)
    cc = (sw * d[..., 1] ** 2).sum(-1)
    half = 0.5 * torch.atan2(2 * b, a - cc)
    dirs = torch.stack([torch.cos(half), torch.sin(half)], dim=-1)
    normals = torch.stack([-dirs[..., 1], dirs[..., 0]], dim=-1)
    offs = (normals * mu).sum(-1)
    return normals, offs, _intersect(normals, offs)


def _intersect(normals: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    nk1 = torch.roll(normals, 1, dims=-2)
    ok1 = torch.roll(offs, 1, dims=-1)
    det = nk1[..., 0] * normals[..., 1] - nk1[..., 1] * normals[..., 0]
    det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    cx = (ok1 * normals[..., 1] - nk1[..., 1] * offs) / det
    cy = (nk1[..., 0] * offs - ok1 * normals[..., 0]) / det
    return torch.stack([cx, cy], dim=-1)


def _fit_quad(pts: torch.Tensor, w: torch.Tensor, refine_iters: int):
    """Fit 4 corners to each cluster's boundary points.

    pts (..., P, 2), w (..., P) weights (0 for padding). Returns (corners
    (..., 4, 2) in descending-angle cyclic order, rms residual (...))."""
    wsum = w.sum(-1) + 1e-9
    c = (pts * w[..., None]).sum(-2) / wsum[..., None]
    live = w > 0
    d2 = torch.where(live, ((pts - c[..., None, :]) ** 2).sum(-1), -1.0)
    p1 = _take(pts, torch.argmax(d2, dim=-1))
    d2b = torch.where(live, ((pts - p1[..., None, :]) ** 2).sum(-1), -1.0)
    p2 = _take(pts, torch.argmax(d2b, dim=-1))
    diag = p2 - p1
    nrm = torch.stack([-diag[..., 1], diag[..., 0]], dim=-1)
    nrm = nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + 1e-9)
    s = ((pts - p1[..., None, :]) * nrm[..., None, :]).sum(-1)
    p3 = _take(pts, torch.argmax(torch.where(live, s, -math.inf), dim=-1))
    p4 = _take(pts, torch.argmax(torch.where(live, -s, -math.inf), dim=-1))
    corners = _sort_by_angle(torch.stack([p1, p2, p3, p4], dim=-2), c)

    theta = torch.atan2(pts[..., 1] - c[..., None, 1], pts[..., 0] - c[..., None, 0])
    sides = torch.arange(4, device=pts.device)
    rms = torch.full(w.shape[:-1], math.inf, dtype=pts.dtype, device=pts.device)
    for _ in range(refine_iters):
        phi = torch.atan2(corners[..., 1] - c[..., None, 1], corners[..., 0] - c[..., None, 0])
        beta = _mod(phi[..., :1] - phi, 2 * math.pi)  # ascending, beta[0] = 0
        alpha = _mod(phi[..., :1] - theta, 2 * math.pi)
        side = (alpha[..., :, None] >= beta[..., None, :]).sum(-1) - 1  # (..., P) in 0..3
        onehot = (side[..., None] == sides).to(pts.dtype) * w[..., None]  # (..., P, 4)
        sw = onehot.sum(-2) + 1e-9
        mu = (onehot.transpose(-1, -2) @ pts) / sw[..., None]  # (..., 4, 2)
        normals, offs, corners = _lines_from_moments(
            pts[..., None, :, :], onehot.transpose(-1, -2), mu)
        n_side = torch.gather(normals, -2, side[..., None].expand(side.shape + (2,)))
        o_side = torch.gather(offs, -1, side)
        resid = (n_side * pts).sum(-1) - o_side
        rms = torch.sqrt((w * resid**2).sum(-1) / wsum)
    return _sort_by_angle(corners, c), rms


def quad_candidates(
    trinary: torch.Tensor,  # (B, H, W) int8 (decimated resolution)
    labels: torch.Tensor,  # (B, H, W) int32
    gray: torch.Tensor,  # (B, H, W) float32 (decimated resolution)
    decimate_factor: int,
    level: torch.Tensor | None = None,  # (B, H, W) local threshold level
    max_clusters: int = 256,
    max_quads: int = 48,
    pts_per_quad: int = 256,
    min_cluster_pts: int = 24,
    min_side: float = 4.0,
    refine_iters: int = 2,
    max_fit_err: float = 0.8,
    max_boundary: int = 32768,
) -> QuadCandidates:
    B, H, W = trinary.shape
    if level is None:
        level = torch.full_like(gray, 0.5)
    ka, kb, x, y, w = _emit_boundaries(trinary, labels, gray, level)
    ka, kb, x, y, w = _compact(ka, kb, x, y, w, max_boundary)
    (x_s, y_s, w_s), st = _cluster(ka, kb, x, y, w, max_clusters, min_cluster_pts)
    count, start = st["count"], st["start"]
    bw = st["xmax"] - st["xmin"]
    bh = st["ymax"] - st["ymin"]
    ok = (
        (count >= min_cluster_pts)
        & (bw >= min_side)
        & (bh >= min_side)
        & (count <= 3.0 * (bw + bh) + 32.0)
    )
    top_score, top_idx = _topk_stable(torch.where(ok, count, -1.0), max_quads)
    q_valid = top_score > 0
    q_start = torch.gather(start, 1, top_idx)
    q_count = torch.gather(count, 1, top_idx).to(torch.int32)

    # Stride-subsample each quad's cluster to pts_per_quad points.
    n = x_s.shape[1]
    k = torch.arange(pts_per_quad, dtype=torch.int64, device=trinary.device)
    qidx = q_start[..., None] + (k * torch.clamp(q_count, min=1)[..., None].to(torch.int64)) // pts_per_quad
    qidx = torch.clamp(qidx, max=n - 1).reshape(B, -1)
    pts = torch.stack([torch.gather(x_s, 1, qidx), torch.gather(y_s, 1, qidx)], dim=-1)
    pts = pts.reshape(B, max_quads, pts_per_quad, 2)
    wq = torch.gather(w_s, 1, qidx).reshape(B, max_quads, pts_per_quad) * q_valid.to(torch.float32)[..., None]
    corners, rms = _fit_quad(pts, wq, refine_iters)

    # Geometry screens: convexity + area + containment.
    nxt = torch.roll(corners, -1, dims=2)
    e = nxt - corners
    e_next = torch.roll(e, -1, dims=2)
    cross = e[..., 0] * e_next[..., 1] - e[..., 1] * e_next[..., 0]
    convex = torch.all(cross > 0, dim=2) | torch.all(cross < 0, dim=2)
    area = 0.5 * torch.abs(
        (corners[..., 0] * nxt[..., 1] - corners[..., 1] * nxt[..., 0]).sum(2))
    inb = torch.all(
        (corners[..., 0] >= -4) & (corners[..., 0] <= W + 4)
        & (corners[..., 1] >= -4) & (corners[..., 1] <= H + 4),
        dim=2,
    )
    good = q_valid & convex & (area >= min_side * min_side) & inb & (rms <= max_fit_err)
    return QuadCandidates(corners=corners * decimate_factor, valid=good, fit_err=rms, cluster_size=q_count)
