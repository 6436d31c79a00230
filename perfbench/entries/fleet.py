"""A camera fleet: ``build_parallel_slam``'s ``parallel_step`` on each
call's frames, S streams of B frames, one SLAM state a stream carried from
call to call (``reset()`` starts a session of every stream). The call's
frames are the pool's, stream by stream (``pools/fleet_loop.py``). Its
answers are every per-frame field flattened back to the pool's order
(S*B frames): the detections, each frame's camera pose, validity and tag
frame; and each stream's landmark map after the call, (S, M, ...)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import judge

FRAME_FLAGS = ("valid",)
# Per stream, the worst of these is reported; the counts are summed.
WORST = ("ate_su", "invalid_share", "unrelocalised_share", "reloc_gap_px", "map_rms_su", "map_max_su")
SUMMED = ("relocalised_frames", "map_landmarks")


class Program:
    """The entry's own faults: ``frozen_state`` returns every state
    unchanged, ``stream0_only`` answers every stream with stream 0's back
    end (its poses, validity, tag frame and map)."""

    def __init__(self, cfg: dict, inputs, device: torch.device, fault: str | None):
        from aprilslam_tpu_torch.detect import DetectorParams
        from aprilslam_tpu_torch.geometry import PinholeCamera
        from aprilslam_tpu_torch.parallel import build_parallel_slam, make_mesh

        self.S = int(cfg["streams"])
        cam = PinholeCamera.from_fov(inputs.width, inputs.height, float(inputs.scene.raw["fov_y"]))
        self.step, self.init_states, _shard = build_parallel_slam(
            make_mesh(self.S, device=device), inputs.scene.family, cam, inputs.scene.tag_size_inner,
            detector_params=DetectorParams(**cfg["detector"]), **cfg["step"])
        self.states = self.init_states()
        self.fault = fault

    def reset(self) -> None:
        self.states = self.init_states()

    def run(self, frames: torch.Tensor) -> dict:
        F = frames.shape[0]
        if F % self.S:
            raise ValueError(f"a call of {F} frames does not hold {self.S} streams")
        before = self.states
        self.states, o = self.step(self.states, frames.reshape((self.S, F // self.S) + frames.shape[1:]))
        if self.fault == "frozen_state":
            self.states = before
        lm_pose = torch.stack([st[1].lm_pose for st in self.states])
        lm_active = torch.stack([st[1].lm_active for st in self.states])
        back = {"poses": o.poses, "valid": o.valid, "coord": o.coord_id, "lm_pose": lm_pose, "lm_active": lm_active}
        if self.fault == "stream0_only":
            back = {k: v[:1].expand_as(v) for k, v in back.items()}
        flat = lambda x: x.reshape((F,) + x.shape[2:])  # noqa: E731
        return {"poses": flat(back["poses"]), "valid": flat(back["valid"]), "coord": flat(back["coord"]),
                "det_ids": flat(o.det_ids), "det_corners": flat(o.det_corners), "det_ok": flat(o.det_ok),
                "lm_pose": back["lm_pose"], "lm_active": back["lm_active"]}


def alter(ans: dict, b: int, d: int) -> None:
    """Move the first frame's camera pose."""
    ans["poses"][0, 0, 3] += 1.0


def judge_answers(w) -> dict:
    """Each stream on its own, as the single-camera entry judges its one
    camera: its re-localised poses against the reference's solve on its own
    map, its map against the scene, its poses against the ground truth. The
    worst stream's number is reported, so one stream's fault is not averaged
    away by the others'."""
    inputs, K, dt = w.inputs, w.inputs.K, w.control
    lm_pose = np.stack([a["lm_pose"] for a in w.answers])  # (C, S, M, 4, 4)
    lm_active = np.stack([a["lm_active"] for a in w.answers])
    C, S = lm_active.shape[:2]
    B = w.F // S

    def stream(a, s):
        """Stream s's frames, in call order, of (C*F, ...) answers or truth."""
        return a.reshape((C, S, B) + tuple(a.shape[1:]))[:, s].reshape((C * B,) + tuple(a.shape[1:]))

    poses, valid, coord = w.stack("poses"), w.stack("valid"), w.stack("coord")
    per = []
    for s in range(S):
        gt = {k: stream(v, s) for k, v in w.gt.items()}
        ids, ok, corners = stream(w.ids, s), stream(w.ok, s), stream(w.corners, s)
        p, v, c = stream(poses, s), stream(valid, s), stream(coord, s)
        lmp, lma = np.repeat(lm_pose[:, s], B, axis=0), np.repeat(lm_active[:, s], B, axis=0)
        the_map = lm_pose[:, s]
        if dt:
            p = judge.control_camera_poses(p, c, v, ids, ok, corners, lmp, lma, w.tag_size, K, dt).numpy()
            the_map = judge.control_map(lm_active[:, s], gt, inputs.scene, K, inputs.width, inputs.height, dt)
        nums = judge.judge_camera_poses(p, v, c, ids, ok, corners, lmp, lma, gt, inputs.scene, w.tag_size, K)
        nums.update(judge.judge_map(the_map, lm_active[:, s], inputs.scene))
        per.append(nums)
    out = {k: float(np.max([n[k] for n in per])) for k in WORST}
    out.update({k: int(sum(n[k] for n in per)) for k in SUMMED})
    out["streams"] = S
    return out
