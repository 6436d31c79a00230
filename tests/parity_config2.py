"""The JAX package and the port on BASELINE config 2, on the CPU.

    JAX_PLATFORMS=cpu python tests/parity_config2.py [--frames 96] [--res 1000]

Config 2 is ``bench.py``'s pgo leg (``bench_pgo_leg``): the default scene
through ``randomize_scene(raw, 0.1, seed=7)``, the two-lap waypoint loop
through ``scripted_waypoints``, frames rendered once by the JAX rasterizer
and cast to uint8, and the chunk-scheduled BA step in chunks of 8 with the
loop-closure back end off and on. Both packages run it from their initial
states. Per chunk the script prints where they disagree (detection ids,
validity, coordinate frame, each side's loop-edge count, the largest pose
gap over frames both call valid), then each side's ATE, valid rate and loop
edges per leg.

Not a test (pytest does not collect it): at 1000x1000 it takes minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from aprilslam_tpu.detect import DetectorParams  # noqa: E402
from aprilslam_tpu.geometry import PinholeCamera  # noqa: E402
from aprilslam_tpu.sim import DEFAULT_SCENE, SceneConfig, randomize_scene, render_frames  # noqa: E402
from aprilslam_tpu.sim import scene_tensors, trajectory  # noqa: E402
from aprilslam_tpu.slam import build_slam_step  # noqa: E402
from aprilslam_tpu_torch import detect as TD  # noqa: E402
from aprilslam_tpu_torch import geometry as TG  # noqa: E402
from aprilslam_tpu_torch import sim as TSim  # noqa: E402
from aprilslam_tpu_torch import slam as TS  # noqa: E402
from aprilslam_tpu_torch.eval import ate_eval  # noqa: E402

B = 8
CONFIG2 = dict(estimator="ba", ba_schedule="chunk", graph_capacity=16, init_joint_iters=3,
               ba_chunk_iters=4, pnp_iters=3)
PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
# bench.py:400-404, the two-lap loop
WAYPOINTS = np.array([
    [0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [60.0, 2.0, 12.0],
    [0.0, 0.0, 10.0], [2.0, 1.0, 11.0], [60.0, 0.0, 10.0],
    [60.0, 2.0, 12.0], [0.0, 0.0, 10.0],
])


def as_torch(out) -> SimpleNamespace:
    return SimpleNamespace(**{k: torch.as_tensor(np.asarray(v)) for k, v in vars(out).items()})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--res", type=int, default=1000)
    args = ap.parse_args()
    n, res = (args.frames // B) * B, args.res
    with open(DEFAULT_SCENE) as f:
        raw = randomize_scene(json.load(f), 0.1, seed=7)
    cfg = SceneConfig.from_dict(raw)
    tcfg = TSim.SceneConfig.from_dict(raw)
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    traj = trajectory.scripted_waypoints(n, WAYPOINTS)
    scene = scene_tensors(cfg)
    u8 = np.concatenate([
        np.asarray(jnp.clip(render_frames(scene, jnp.asarray(traj.positions[i:i + B]),
                                          jnp.asarray(traj.rotations[i:i + B]),
                                          jnp.asarray(cam.inv_matrix), res, res, 2) * 255.0,
                            0, 255).astype(jnp.uint8))
        for i in range(0, n, B)])

    summary = []
    for pgo in (False, True):
        step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=PARAMS,
                                     pgo=pgo, **CONFIG2)
        step = jax.jit(step)
        state = init()
        slam = TS.SlamSystem(TG.PinholeCamera(**cam.__dict__), cfg.family, cfg.tag_size_inner,
                             detector_params=TD.DetectorParams(**PARAMS.__dict__), device="cpu",
                             pgo=pgo, **CONFIG2)
        j_outs, t_outs = [], []
        for c in range(n // B):
            frames = u8[c * B:(c + 1) * B]
            state, jo = step(state, jnp.asarray(frames))
            jo = as_torch(jax.device_get(jo))
            to = slam.process(torch.from_numpy(frames.copy()))
            both = (jo.valid & to.valid).numpy()
            gap = np.abs(jo.poses.numpy() - to.poses.numpy()).max(axis=(1, 2))
            print(json.dumps({
                "pgo": pgo,
                "chunk": c,
                "det_ids_differ": int((jo.det_ids != to.det_ids).any(-1).sum()),
                "valid_differ": int((jo.valid != to.valid).sum()),
                "coord_differ": int((jo.coord_id != to.coord_id).sum()),
                "loop_edges": [int(jo.loop_closures[-1]), int(to.loop_closures[-1])],
                "max_pose_gap_both_valid": float(gap[both].max()) if both.any() else None,
                "frames_gap_over_0.05": [c * B + int(i) for i in np.flatnonzero(both & (gap > 0.05))],
            }), flush=True)
            j_outs.append(jo)
            t_outs.append(to)
        for name, outs in (("jax", j_outs), ("port", t_outs)):
            ate, vrate, n_invalid, _conf = ate_eval(tcfg, traj.positions, traj.rotations, outs)
            row = {"side": name, "pgo": pgo, "frames": n, "res": res, "ate": ate, "valid_rate": vrate,
                   "n_invalid": n_invalid, "loop_edges": int(outs[-1].loop_closures[-1])}
            summary.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
