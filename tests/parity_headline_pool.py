"""The JAX package and the port on the same full-size headline frames, on the CPU.

    JAX_PLATFORMS=cpu python tests/parity_headline_pool.py [--frames 64] [--res 1000]

The frames are the first ``--frames`` poses of the JAX package's own
``monte_carlo(512, seed=3)`` headline pool, rendered once by the JAX
rasterizer and cast to uint8 as ``bench.py`` does. Both SLAM steps run the
headline configuration over them in chunks of 8 from their initial states.
The script prints, per chunk and in all, where the two disagree: detection
ids, PnP-ok flags, validity, the coordinate frame, the largest pose gap over
frames both call valid, and each side's ATE. Per chunk it also lists the
frames on which the reference's own labelling schedules stop short of the
converged labels that the port computes. It also prints how far the
port's own rasterizer is from the JAX one on the same poses.

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
from aprilslam_tpu.detect import threshold as JT  # noqa: E402
from aprilslam_tpu.detect.segment import connected_components as cc_xla  # noqa: E402
from aprilslam_tpu.geometry import PinholeCamera  # noqa: E402
from aprilslam_tpu.ops import connected_components_pallas  # noqa: E402
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory  # noqa: E402
from aprilslam_tpu.slam import build_slam_step  # noqa: E402
from aprilslam_tpu_torch import detect as TD  # noqa: E402
from aprilslam_tpu_torch import geometry as TG  # noqa: E402
from aprilslam_tpu_torch import sim as TSim  # noqa: E402
from aprilslam_tpu_torch import slam as TS  # noqa: E402
from aprilslam_tpu_torch.eval import ate_eval  # noqa: E402
from aprilslam_tpu_torch.ops import ccl  # noqa: E402

B = 8
HEADLINE = dict(estimator="ba", ba_schedule="chunk", graph_capacity=16, ba_keyframes=16,
                ba_obs=512, init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3)
PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)


def as_torch(out) -> SimpleNamespace:
    return SimpleNamespace(**{k: torch.as_tensor(np.asarray(v)) for k, v in vars(out).items()})


def unconverged_frames(frames: np.ndarray, first: int) -> dict:
    """Frames whose reference labels differ from the converged ones: the JAX
    CPU detector's XLA schedule (4 scans) and the TPU's 8-round Pallas
    schedule, run here in interpret mode."""
    dec = JT.decimate(JT.to_grayscale(jnp.asarray(frames)), PARAMS.quad_decimate)
    trin = JT.adaptive_threshold_with_levels(dec, tile=PARAMS.tile, min_contrast=PARAMS.min_contrast)[0]
    conv = ccl.connected_components_plain(torch.as_tensor(np.asarray(trin))).numpy()
    out = {}
    for name, lab in (("xla_cpu", cc_xla(trin, PARAMS.scan_iters, PARAMS.jump_iters)),
                      ("pallas_8_rounds", connected_components_pallas(trin, rounds=8, step_cap=7,
                                                                      interpret=True))):
        bad = (np.asarray(lab) != conv).any(axis=(1, 2))
        out[name] = [first + int(i) for i in np.flatnonzero(bad)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--res", type=int, default=1000)
    args = ap.parse_args()
    n, res = args.frames, args.res
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    traj = trajectory.monte_carlo(512, seed=3)
    pos, rot = traj.positions[:n], traj.rotations[:n]

    scene = scene_tensors(cfg)
    u8 = np.concatenate([
        np.asarray(jnp.clip(render_frames(scene, jnp.asarray(pos[i:i + B]), jnp.asarray(rot[i:i + B]),
                                          jnp.asarray(cam.inv_matrix), res, res, 2) * 255.0,
                            0, 255).astype(jnp.uint8))
        for i in range(0, n, B)])
    tscene = TSim.scene_tensors(TSim.SceneConfig.from_file(), device="cpu")
    render_diff = [
        (TSim.render_frames(tscene, pos[i:i + B], rot[i:i + B], cam.inv_matrix, res, res, 2,
                            device="cpu") * 255.0).clamp(0, 255).to(torch.uint8).numpy() != u8[i:i + B]
        for i in range(0, n, B)]
    print(json.dumps({"render_pixels_differing": float(np.concatenate(render_diff).mean())}), flush=True)

    step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=PARAMS, **HEADLINE)
    step = jax.jit(step)
    state = init()
    slam = TS.SlamSystem(TG.PinholeCamera(**cam.__dict__), cfg.family, cfg.tag_size_inner,
                         detector_params=TD.DetectorParams(**PARAMS.__dict__), device="cpu", **HEADLINE)
    j_outs, t_outs = [], []
    for c in range(n // B):
        frames = u8[c * B:(c + 1) * B]
        state, jo = step(state, jnp.asarray(frames))
        jo = as_torch(jax.device_get(jo))
        to = slam.process(frames)
        both = (jo.valid & to.valid).numpy()
        gap = np.abs(jo.poses.numpy() - to.poses.numpy()).max(axis=(1, 2))
        print(json.dumps({
            "chunk": c,
            "det_ids_differ": int((jo.det_ids != to.det_ids).any(-1).sum()),
            "det_ok_differ": int((jo.det_ok != to.det_ok).any(-1).sum()),
            "valid_differ": int((jo.valid != to.valid).sum()),
            "coord_differ": int((jo.coord_id != to.coord_id).sum()),
            "max_pose_gap_both_valid": float(gap[both].max()) if both.any() else None,
            "labels_unconverged": unconverged_frames(frames, c * B),
        }), flush=True)
        j_outs.append(jo)
        t_outs.append(to)
    tcfg = TSim.SceneConfig.from_file()
    for name, outs in (("jax", j_outs), ("port", t_outs)):
        ate, vrate, n_invalid, conf = ate_eval(tcfg, pos, rot, outs)
        print(json.dumps({"side": name, "frames": n, "res": res, "ate": ate, "valid_rate": vrate,
                          "n_invalid": n_invalid, "confidence": conf}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
