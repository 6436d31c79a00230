"""The JAX package and the port on BASELINE config 4's replay, on the CPU.

    JAX_PLATFORMS=cpu python tests/parity_config4.py [--frames 64]

Config 4 is ``bench.py``'s video leg (``bench_video_leg``): the default
scene at 640x480 along three scripted waypoints, frames rendered once by the
JAX rasterizer (supersample 2) and cast to uint8, written as a mono Y4M clip
and replayed in batches of 8: detect (``quad_decimate=2,
min_cluster_pts=12, max_detections=16``) then PnP. Both packages replay the
same frames (the port through its native Y4M reader, the JAX side from the
array). The script prints each side's ok tag poses, the median and 95th
percentile of their translation error against ``camera_to_tag_transforms``
(scene units), and where the two sides' ok (frame, id) sets differ.

Not a test (pytest does not collect it): it takes a few minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from aprilslam_tpu.detect import DetectorParams, TagDetector  # noqa: E402
from aprilslam_tpu.geometry import PinholeCamera  # noqa: E402
from aprilslam_tpu.pose import poses_from_detections  # noqa: E402
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory  # noqa: E402
from aprilslam_tpu_torch import detect as TD  # noqa: E402
from aprilslam_tpu_torch import pose as TP  # noqa: E402
from aprilslam_tpu_torch.runtime import Y4MReader  # noqa: E402
from aprilslam_tpu_torch.sim import camera_to_tag_transforms  # noqa: E402

W, H, B = 640, 480, 8
WAYPOINTS = np.array([[0.0, 0.0, 20.0], [8.0, 2.0, 5.0], [0.0, -2.0, 15.0]])  # bench.py:544


def translation_errors(poses: dict, cfg, traj) -> np.ndarray:
    """|t_est - t_gt| of each ok pose, keyed (frame, tag id)."""
    gt = camera_to_tag_transforms(torch.as_tensor(cfg.tag_positions()), torch.as_tensor(cfg.tag_rotations()),
                                  torch.as_tensor(traj.positions), torch.as_tensor(traj.rotations)).numpy()
    index = {int(t): k for k, t in enumerate(cfg.tag_ids())}
    return np.array([np.linalg.norm(T[:3, 3] - gt[f, index[i], :3, 3]) for (f, i), T in sorted(poses.items())])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(W, H, cfg.fov_y)
    traj = trajectory.scripted_waypoints(args.frames, WAYPOINTS)
    frames = np.asarray(render_frames(scene_tensors(cfg), jnp.asarray(traj.positions),
                                      jnp.asarray(traj.rotations), jnp.asarray(cam.inv_matrix), H, W, 2))
    y = np.clip(frames * 255.0, 0, 255).astype(np.uint8)

    kw = dict(quad_decimate=2, min_cluster_pts=12, max_detections=16)
    jdet = TagDetector(cfg.family, DetectorParams(**kw))
    tdet = TD.TagDetector(cfg.family, TD.DetectorParams(**kw), device="cpu")
    K = torch.as_tensor(cam.matrix)
    sides = {"jax": {}, "port": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.y4m")
        with open(path, "wb") as f:
            f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Cmono\n".encode())
            for fr in y:
                f.write(b"FRAME\n" + fr.tobytes())
        with Y4MReader(path) as r:
            k = 0
            while (b := r.read_batch(B)).shape[0]:
                det = tdet.detect(torch.from_numpy(b))
                T, ok = TP.poses_from_detections(det, K, cfg.tag_size_inner)[:2]
                jd = jdet.detect(jnp.asarray(y[k:k + B]))
                jT, jok = poses_from_detections(jd, jnp.asarray(cam.matrix), cfg.tag_size_inner)[:2]
                for side, ids, Ts, oks in (("port", det.ids.numpy(), T.numpy(), ok.numpy()),
                                           ("jax", np.asarray(jd.ids), np.asarray(jT), np.asarray(jok))):
                    for f, d in zip(*np.nonzero(oks)):
                        sides[side][(k + int(f), int(ids[f, d]))] = Ts[f, d]
                k += b.shape[0]
    out = {"frames": args.frames, "res": f"{W}x{H}"}
    for name, poses in sides.items():
        err = translation_errors(poses, cfg, traj)
        out[name] = {"tag_poses": len(poses), "t_err_median": float(np.median(err)),
                     "t_err_p95": float(np.percentile(err, 95))}
    only = {n: sorted(set(sides[n]) - set(sides[o])) for n, o in (("jax", "port"), ("port", "jax"))}
    out["only_jax"], out["only_port"] = only["jax"], only["port"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
