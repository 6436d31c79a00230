"""The whole step: ``SlamSystem.process`` on each call's frames, the state
carried from call to call (``reset()`` starts a session). Its answers are
the detections, each frame's camera pose, validity and tag frame, the
cumulative loop edges, and the back end's landmark map after the call."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import judge

FRAME_FLAGS = ("valid",)


class Program:
    def __init__(self, cfg: dict, inputs, device: torch.device, fault: str | None):
        from aprilslam_tpu_torch.detect import DetectorParams
        from aprilslam_tpu_torch.geometry import PinholeCamera
        from aprilslam_tpu_torch.slam import SlamSystem

        cam = PinholeCamera.from_fov(inputs.width, inputs.height, float(inputs.scene.raw["fov_y"]))
        self.system = SlamSystem(cam, inputs.scene.family, inputs.scene.tag_size_inner,
                                 detector_params=DetectorParams(**cfg["detector"]), device=device, **cfg["step"])
        self.frozen = fault == "frozen_state"

    def reset(self) -> None:
        self.system.reset()

    def run(self, frames: torch.Tensor) -> dict:
        before = self.system.state
        o = self.system.process(frames)
        if self.frozen:
            self.system.state = before
        ba = self.system.ba_state
        return {"poses": o.poses, "valid": o.valid, "coord": o.coord_id, "loops": o.loop_closures,
                "det_ids": o.det_ids, "det_corners": o.det_corners, "det_ok": o.det_ok,
                "lm_pose": ba.lm_pose, "lm_active": ba.lm_active}


def alter(ans: dict, b: int, d: int) -> None:
    """Move the first frame's camera pose."""
    ans["poses"][0, 0, 3] += 1.0


def judge_answers(w) -> dict:
    """Each re-localised camera pose against the reference's solve on the
    step's map; the map against the scene; every pose against the ground
    truth; and, for session traffic, the loop edges each session closed."""
    inputs, K, dt = w.inputs, w.inputs.K, w.control
    per_call = lambda key: np.stack([a[key] for a in w.answers])  # noqa: E731
    lm_pose, lm_active = per_call("lm_pose"), per_call("lm_active")
    rep = lambda a: np.repeat(a, w.F, axis=0)  # noqa: E731
    poses, valid, coord = w.stack("poses"), w.stack("valid"), w.stack("coord")
    the_map = lm_pose
    if dt:
        poses = judge.control_camera_poses(poses, coord, valid, w.ids, w.ok, w.corners, rep(lm_pose),
                                           rep(lm_active), w.tag_size, K, dt).numpy()
        the_map = judge.control_map(lm_active, w.gt, inputs.scene, K, inputs.width, inputs.height, dt)
    nums = judge.judge_camera_poses(poses, valid, coord, w.ids, w.ok, w.corners, rep(lm_pose), rep(lm_active),
                                    w.gt, inputs.scene, w.tag_size, K)
    nums.update(judge.judge_map(the_map, lm_active, inputs.scene))
    if w.session:
        ends = [c[2]["loops"][-1] for c in w.calls if (c[0] + 1) % w.session == 0]
        ends = ends or [w.calls[-1][2]["loops"][-1]]
        nums["loop_edges_min"] = int(min(ends))
    return nums
