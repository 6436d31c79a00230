"""The comparison that decides ``correct``: every answer the window produced,
held against what the scene and the camera poses say it should be.

Plain torch on the CPU, in float64. It imports nothing of the program and
takes nothing the program made except the answers it judges. The SLAM
step's map is one of those answers: it is held against the scene
(``map_rms_su``), and each re-localised camera pose is held against the
best pose on that map, from the answer and from the reference's own solve.

The numbers, each compared with its limit in ``limits.json`` or, where the
configuration states it, in the configuration's ``guarantees``:

- ``false_dets``: detections whose id is not in the scene or names a tag
  behind the camera; of those the program marks ok (its pose vouched for),
  those whose corners lie more than ``match_px`` (RMS over the four) from
  that tag's projection; of the rest, those whose centre lies outside that
  tag's projected printed square.
- ``missed_share``: the share of plainly visible tags (in front of the
  camera, the whole printed square ``margin`` px inside the frame, no other
  tag in the way) that no matching detection with a pose reports.
- ``corner_rms_px``: RMS corner error of the matching detections.
- ``pnp_gap_px``: the most a tag pose's corner reprojection error lies above
  the least the reference reaches on the same corners.
- ``reloc_gap_px``: the same for each re-localised camera pose on the
  step's map, refined from the answer and solved afresh by the reference.
- ``map_rms_su``: RMS position error of the step's landmarks in its
  anchor's frame, against the scene, over every call's map.
- ``ate_su``: RMS camera position error in the frame the pose is given in.
- ``invalid_share``: frames without a pose in a tag's frame.
- ``unrelocalised_share``: frames with a pose that the step did not
  re-localise on its map (a step whose state does not move never does).
- ``loop_edges_min``: the fewest loop edges a whole session closed.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pnp
from perfbench.reference.geometry import camera_to_tag, se3_inverse, tag_corners, project, tag_rotation

F64 = torch.float64


def ground_truth(scene, cam_pos: np.ndarray, cam_rot: np.ndarray, K: np.ndarray, dtype=F64) -> dict:
    """Each tag's pose in each camera, the pixels and depths of its
    inner-border corners (what the detector reports) and of its outer
    corners (the whole printed tag, whose data bits lie outside the border
    in this family), and whether another tag hides any of it: (N, T, ...)."""
    tp = torch.as_tensor(scene.tag_positions(), dtype=dtype)
    tr = torch.as_tensor(scene.tag_rotations(), dtype=dtype)
    cp = torch.as_tensor(cam_pos, dtype=dtype)
    cr = torch.as_tensor(cam_rot, dtype=dtype)
    T_ct = camera_to_tag(tp, tr, cp, cr)
    Kt = torch.as_tensor(K, dtype=dtype)
    shape = T_ct.shape[:-2] + (4, 3)
    uv, z = project(T_ct, tag_corners(scene.tag_size_inner, dtype=dtype).expand(shape), Kt)
    uv_out, z_out = project(T_ct, tag_corners(scene.tag_size_outer, dtype=dtype).expand(shape), Kt)
    return {"T_ct": T_ct, "uv": uv, "z": z, "uv_outer": uv_out, "z_outer": z_out,
            "unoccluded": unoccluded(scene, cp.to(F64))}


def unoccluded(scene, cam_pos: torch.Tensor) -> torch.Tensor:
    """(N, T) bool: the segment from the camera to each of a tag's four
    outer corners and its centre crosses no other tag's rendered square."""
    tp = torch.as_tensor(scene.tag_positions(), dtype=F64)
    R = tag_rotation(torch.as_tensor(scene.tag_rotations(), dtype=F64))  # (T, 3, 3)
    h = scene.tag_size_outer / 2.0
    local = torch.tensor([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0], [0, 0, 0]], dtype=F64)
    P = torch.einsum("tij,pj->tpi", R, local) + tp[:, None]  # (T, 5, 3) world points
    n = R[:, :, 2]  # (S, 3) each tag's plane normal
    d = P[None] - cam_pos[:, None, None]  # (N, T, 5, 3)
    num = (n * tp).sum(-1)[None] - cam_pos @ n.T  # (N, S)
    den = torch.einsum("si,ntpi->ntps", n, d)
    safe = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    tau = num[:, None, None, :] / safe  # (N, T, 5, S)
    hit = cam_pos[:, None, None, None] + tau[..., None] * d[:, :, :, None]  # (N, T, 5, S, 3)
    q = torch.einsum("sji,ntpsj->ntpsi", R, hit - tp[None, None, None])
    half = scene.tag_size_outer / 2.0
    blocks = (q[..., 0].abs() <= half) & (q[..., 1].abs() <= half) & (tau > 1e-6) & (tau < 1 - 1e-6)
    blocks = blocks & (den.abs() >= 1e-12)
    T = tp.shape[0]
    blocks = blocks & ~torch.eye(T, dtype=torch.bool)[None, :, None, :]
    return ~blocks.flatten(-2).any(-1)


def inside_quad(p: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """Whether points (..., 2) lie inside convex quads (..., 4, 2)."""
    a, b = quad, torch.roll(quad, -1, dims=-2)
    cross = (b[..., 0] - a[..., 0]) * (p[..., None, 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (
        p[..., None, 0] - a[..., 0])
    return (cross >= 0).all(-1) | (cross <= 0).all(-1)


def judge_detections(ids, corners, ok, gt: dict, scene, width: int, height: int, margin: float,
                     match_px: float) -> dict:
    """Detections (N, D) ids (-1 for none), (N, D, 4, 2) corners and (N, D)
    pose-ok flags against the ground truth of the same N frames."""
    ids = torch.as_tensor(ids).to(torch.int64)
    corners = torch.as_tensor(corners).to(F64)
    ok = torch.as_tensor(ok).to(torch.bool)
    scene_ids = torch.as_tensor(scene.tag_ids())
    # (N, D, T): detection d in frame n claims scene tag t
    claims = ids[..., None] == scene_ids[None, None, :]
    present = ids >= 0
    known = claims.any(-1)
    t_idx = torch.argmax(claims.to(torch.int64), -1)
    n_idx = torch.arange(ids.shape[0])[:, None].expand_as(ids)
    uv_gt = gt["uv"][n_idx, t_idx].to(F64)  # (N, D, 4, 2)
    in_front = (gt["z"][n_idx, t_idx] > scene.near_clip).all(-1)
    err = torch.sqrt(((corners - uv_gt) ** 2).sum(-1).mean(-1))
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))
    match = present & known & in_front & (err <= match_px)
    # A detection the program vouches for (ok) must sit on its tag, wherever
    # the tag lies; one it does not must at least name a tag whose printed
    # square holds its centre.
    on_tag = inside_quad(corners.mean(-2), gt["uv_outer"][n_idx, t_idx].to(F64))
    false = present & ~(known & in_front & torch.where(ok, err <= match_px, on_tag))
    uv = gt["uv_outer"].to(F64)
    inside = ((uv[..., 0] >= margin) & (uv[..., 0] <= width - margin)
              & (uv[..., 1] >= margin) & (uv[..., 1] <= height - margin)).all(-1)
    expected = inside & (gt["z_outer"] > scene.near_clip).all(-1) & gt["unoccluded"]  # (N, T)
    hit = (match & ok)[..., None] & claims  # (N, D, T)
    found = hit.any(1)
    n_exp = int(expected.sum())
    matched_err = err[match]
    return {
        "false_dets": int(false.sum()),
        "missed_share": float((expected & ~found).sum()) / max(n_exp, 1),
        "corner_rms_px": float(torch.sqrt((matched_err ** 2).mean())) if len(matched_err) else float("nan"),
        "expected_tags": n_exp,
        "detections": int(present.sum()),
    }


def judge_tag_poses(T_ct, corners, ok, tag_size: float, K) -> dict:
    """Each reported tag pose (ok) against the reference's solve on the same corners."""
    ok = torch.as_tensor(ok).to(torch.bool)
    T_ct = torch.as_tensor(T_ct)[ok]
    c = torch.as_tensor(corners)[ok]
    finite = torch.isfinite(T_ct).flatten(1).all(-1) & torch.isfinite(c).flatten(1).all(-1)
    gap = torch.full((T_ct.shape[0],), float("inf"), dtype=F64)
    if finite.any():
        gap[finite] = pnp.tag_pose_gap(T_ct[finite], c[finite], tag_size, K)
    return {"pnp_gap_px": float(gap.max()) if len(gap) else 0.0, "tag_poses": int(len(gap))}


def slot_corners(ids, ok, corners, M: int):
    """Per-frame detections -> (N, M, 4, 2) corners by tag slot and (N, M) seen."""
    ids = torch.as_tensor(ids).to(torch.int64)
    okm = torch.as_tensor(ok).to(torch.bool) & (ids >= 0) & (ids < M)
    onehot = torch.nn.functional.one_hot(torch.where(okm, ids, M), M + 1)[..., :M].to(F64)  # (N, D, M)
    c = torch.nan_to_num(torch.as_tensor(corners).to(F64))
    return torch.einsum("ndm,ndcx->nmcx", onehot, c), onehot.sum(1) > 0


def relocalised(coord, valid, lm_active, seen):
    """(N,) frames the step re-localised on the final map, and (N, M) the tags it used."""
    M = lm_active.shape[-1]
    coord = torch.as_tensor(coord).to(torch.int64)
    c = coord.clamp(0, M - 1)
    frame_ok = (coord >= 0) & (coord < M) & lm_active[torch.arange(len(c)), c]
    use = seen & lm_active
    return torch.as_tensor(valid).to(torch.bool) & frame_ok & use.any(-1), use


def judge_camera_poses(poses, valid, coord, det_ids, det_ok, det_corners, lm_pose, lm_active, gt: dict,
                       scene, tag_size: float, K) -> dict:
    """Each re-localised camera pose against the reference's solve on the
    same map and corners, and every pose against the ground truth."""
    poses = torch.as_tensor(poses).to(F64)
    lm_pose = torch.as_tensor(lm_pose).to(F64)
    lm_active = torch.as_tensor(lm_active).to(torch.bool)
    M = lm_active.shape[-1]
    corn, seen = slot_corners(det_ids, det_ok, det_corners, M)
    keep, use = relocalised(coord, valid, lm_active, seen)
    coord = torch.as_tensor(coord).to(torch.int64)
    n = torch.arange(len(coord))
    T_wa = lm_pose[n, coord.clamp(0, M - 1)]
    T_cw = se3_inverse(T_wa @ poses)
    gap = torch.zeros(0, dtype=F64)
    if keep.any():
        fin = torch.isfinite(T_cw[keep]).flatten(1).all(-1)
        gap = torch.full((int(keep.sum()),), float("inf"), dtype=F64)
        k = torch.nonzero(keep)[:, 0][fin]
        gap[fin] = pnp.camera_gap(T_cw[k], lm_pose[k], use[k], corn[k], tag_size, K)
    scene_ids = torch.as_tensor(scene.tag_ids())
    in_scene = coord[:, None] == scene_ids[None]
    posed = torch.as_tensor(valid).to(torch.bool) & in_scene.any(-1)
    t_idx = torch.argmax(in_scene.to(torch.int64), -1)
    cam_in_tag = se3_inverse(gt["T_ct"][n, t_idx].to(F64))
    err = (poses[:, :3, 3] - cam_in_tag[:, :3, 3]).norm(dim=-1)[posed]
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))
    return {
        "reloc_gap_px": float(gap.max()) if len(gap) else 0.0,
        "relocalised_frames": int(keep.sum()),
        "ate_su": float(torch.sqrt((err ** 2).mean())) if len(err) else float("inf"),
        "invalid_share": 1.0 - float(posed.sum()) / max(len(posed), 1),
        "unrelocalised_share": 1.0 - float((keep & posed).sum()) / max(int(posed.sum()), 1),
    }


def true_map(scene, dtype=F64) -> torch.Tensor:
    """(T, 4, 4) each scene tag's pose in one common frame, in the tag frame
    the detector reports (so ``inv(W[a]) @ W[i]`` is tag i in tag a's frame)."""
    zero = torch.zeros((1, 3), dtype=dtype)
    return camera_to_tag(torch.as_tensor(scene.tag_positions(), dtype=dtype),
                         torch.as_tensor(scene.tag_rotations(), dtype=dtype), zero, zero)[0]


def judge_map(lm_pose, lm_active, scene) -> dict:
    """The back end's landmark map after each call, (C, M, 4, 4) tag -> world
    by slot (= tag id) and (C, M) active, against the scene: each active
    landmark's position in the frame of the lowest active one, whose own
    pose fixes the map's gauge. ``map_rms_su`` is the RMS over every call and
    every other active landmark (a landmark no scene tag bears counts as
    infinitely far); with no such landmark in any call it is infinite."""
    lm_pose = torch.as_tensor(lm_pose).to(F64)
    lm_active = torch.as_tensor(lm_active).to(torch.bool)
    C, M = lm_active.shape
    W = torch.zeros((M, 4, 4), dtype=F64)
    in_scene = torch.zeros(M, dtype=torch.bool)
    ids = torch.as_tensor(scene.tag_ids()).to(torch.int64)
    keep = ids < M
    W[ids[keep]] = true_map(scene)[keep]
    in_scene[ids[keep]] = True
    has = lm_active.any(-1)
    a = torch.argmax(lm_active.to(torch.int64), -1)  # (C,) the lowest active slot
    c = torch.arange(C)
    rel = se3_inverse(lm_pose[c, a])[:, None] @ lm_pose  # (C, M, 4, 4)
    truth = se3_inverse(W[a])[:, None] @ W[None]
    err = (rel[..., :3, 3] - truth[..., :3, 3]).norm(dim=-1)
    err = torch.where(in_scene[None] & in_scene[a][:, None] & torch.isfinite(err), err,
                      torch.full_like(err, float("inf")))
    others = lm_active & has[:, None] & (torch.arange(M)[None] != a[:, None])
    e = err[others]
    return {"map_rms_su": float(torch.sqrt((e ** 2).mean())) if len(e) else float("inf"),
            "map_max_su": float(e.max()) if len(e) else float("inf"), "map_landmarks": int(len(e))}


def control_map(lm_active, gt: dict, scene, K, width: int, height: int, dtype) -> torch.Tensor:
    """The reference's map in the back end's place, computed in ``dtype``:
    after each call, tag i in the frame of the anchor a (the call's lowest
    active landmark) from the latest judged frame up to that call's last
    that sees both, as the pose of a in that camera inverted times the pose
    of i, each from the reference's PnP on the projected corners. In float64
    on exact corners this is the scene's own map; a pair no frame has seen
    together yet keeps the scene's pose. The judged frames are the calls'
    frames in order, the same number a call. Returns (C, M, 4, 4) tag ->
    anchor frame, in float64."""
    lm_active = torch.as_tensor(lm_active).to(torch.bool)
    C, M = lm_active.shape
    ids = torch.as_tensor(scene.tag_ids()).to(torch.int64)
    T = len(ids)
    uv = gt["uv"].to(dtype)
    N = uv.shape[0]
    vis = ((gt["z"] > scene.near_clip).all(-1) & (uv[..., 0] >= 0).all(-1) & (uv[..., 0] < width).all(-1)
           & (uv[..., 1] >= 0).all(-1) & (uv[..., 1] < height).all(-1))  # (N, T)
    T_ct = torch.eye(4, dtype=dtype).repeat(N, T, 1, 1)
    if vis.any():
        T_ct[vis], _ = pnp.tag_pose(uv[vis], scene.tag_size_inner, K)
    W = true_map(scene)
    truth = se3_inverse(W)[:, None] @ W[None]  # (T, T, 4, 4)
    rel = (se3_inverse(T_ct)[:, :, None] @ T_ct[:, None, :]).to(F64)  # (N, T, T, 4, 4) per frame
    both = vis[:, :, None] & vis[:, None, :]
    n_idx = torch.where(both, torch.arange(N)[:, None, None], torch.full_like(both, -1, dtype=torch.int64))
    latest = torch.cummax(n_idx, 0).values[(torch.arange(C) + 1) * (N // C) - 1]  # (C, T, T)
    pick = rel[latest.clamp(min=0), torch.arange(T)[None, :, None], torch.arange(T)[None, None, :]]
    per_call = torch.where((latest >= 0)[..., None, None], pick, truth[None])  # (C, T, T, 4, 4)
    slot = torch.full((M,), -1, dtype=torch.int64)
    slot[ids[ids < M]] = torch.arange(T)[ids < M]
    ta = slot[torch.argmax(lm_active.to(torch.int64), -1)]
    out = torch.eye(4, dtype=F64).repeat(C, M, 1, 1)
    for m in range(M):
        ok = (slot[m] >= 0) & (ta >= 0)
        out[ok, m] = per_call[torch.nonzero(ok)[:, 0], ta[ok], slot[m]]
    return out


def control_detections(gt: dict, scene, width: int, height: int, dtype, max_detections: int) -> dict:
    """The reference in the detector's place, computed in ``dtype``: every
    tag whose inner corners all project into the frame, in front of the
    camera, with its projected corners."""
    uv = gt["uv"].to(dtype)
    N, T = uv.shape[:2]
    vis = ((gt["z"] > scene.near_clip).all(-1) & (uv[..., 0] >= 0).all(-1) & (uv[..., 0] < width).all(-1)
           & (uv[..., 1] >= 0).all(-1) & (uv[..., 1] < height).all(-1))
    ids = torch.full((N, max_detections), -1, dtype=torch.int64)
    corners = torch.zeros((N, max_detections, 4, 2), dtype=dtype)
    scene_ids = torch.as_tensor(scene.tag_ids())
    k = min(T, max_detections)
    ids[:, :k] = torch.where(vis[:, :k], scene_ids[None, :k], -1)
    corners[:, :k] = uv[:, :k]
    return {"ids": ids, "corners": corners, "ok": ids >= 0}


def control_tag_poses(corners, ok, tag_size: float, K, dtype) -> torch.Tensor:
    """The reference's tag poses computed in ``dtype`` in PnP's place."""
    T, _ = pnp.tag_pose(torch.as_tensor(corners).to(dtype), tag_size, K)
    eye = torch.eye(4, dtype=dtype).expand(T.shape)
    return torch.where(torch.as_tensor(ok)[..., None, None], T, eye)


def control_camera_poses(poses, coord, valid, det_ids, det_ok, det_corners, lm_pose, lm_active, tag_size: float,
                         K, dtype) -> torch.Tensor:
    """The reference's re-localisation computed in ``dtype`` in the step's
    place, on the step's map, expressed in the step's frame of reference;
    the frames the step does not re-localise keep its poses."""
    lm_active = torch.as_tensor(lm_active).to(torch.bool)
    M = lm_active.shape[-1]
    corn, seen = slot_corners(det_ids, det_ok, det_corners, M)
    keep, use = relocalised(coord, valid, lm_active, seen)
    lm = torch.as_tensor(lm_pose).to(dtype)
    T_cw = pnp.camera_pose(lm, use, corn.to(dtype), tag_size, K)
    coord = torch.as_tensor(coord).to(torch.int64).clamp(0, M - 1)
    T_wa = lm[torch.arange(len(coord)), coord]
    ctrl = (se3_inverse(T_wa) @ se3_inverse(T_cw)).to(F64)
    return torch.where(keep[:, None, None], ctrl, torch.as_tensor(poses).to(F64))
