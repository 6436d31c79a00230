"""Detection and PnP only: ``TagDetector.detect`` then
``poses_from_detections`` over the call's frames. Its answers are the
detections and each tag's pose (``T``)."""

from __future__ import annotations

import torch

from perfbench.reference import judge

FRAME_FLAGS = ()


class Program:
    def __init__(self, cfg: dict, inputs, device: torch.device, fault: str | None):
        from aprilslam_tpu_torch.detect import DetectorParams, TagDetector
        from aprilslam_tpu_torch.pose import poses_from_detections

        self.detector = TagDetector(inputs.scene.family, DetectorParams(**cfg["detector"]), device=device)
        self.poses = poses_from_detections
        self.K = torch.as_tensor(inputs.K, dtype=torch.float32, device=device)
        self.tag_size = inputs.scene.tag_size_inner
        self.pnp_iters = int(cfg["step"]["pnp_iters"])

    def reset(self) -> None:
        pass

    def run(self, frames: torch.Tensor) -> dict:
        det = self.detector.detect(frames)
        T, ok, _rms, _seed, _alt = self.poses(det, self.K, self.tag_size, iters=self.pnp_iters)
        return {"det_ids": det.ids, "det_corners": det.corners, "det_ok": ok, "T": T}


def alter(ans: dict, b: int, d: int) -> None:
    """Move the pose of the detection that the fault altered."""
    ans["T"][b, d, 0, 3] += 1.0


def judge_answers(w) -> dict:
    """Each tag pose PnP vouches for, against the reference's solve on its corners."""
    T = w.stack("T")
    if w.control:
        T = judge.control_tag_poses(w.corners, w.ok, w.tag_size, w.inputs.K, w.control).to(torch.float64).numpy()
    return judge.judge_tag_poses(T, w.corners, w.ok, w.tag_size, w.inputs.K)
