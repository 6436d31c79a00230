"""One stream of the camera-fleet deployment (``perfbench/configs/
sim_fleet8_1k.json``: config 3's step, pgo off, on the scripted loop) on the
CPU: the port's step and the JAX package's step on the same frames, each
judged by the benchmark's plain reference (``perfbench/reference/judge.py``)
as the fleet entry judges a stream, then compared frame by frame. It tells
whether a stream that misses the ATE guarantee does so in the port alone or
in the reference as well (ROADMAP 3b).

Stream s of the fleet flies the 96-frame loop from loop frame 12 s, in
chunks of ``--chunk`` frames from a fresh state, over the scene randomized
by ``--seed`` as the benchmark randomizes it.

    JAX_PLATFORMS=cpu python3 tools/probe_fleet_drift.py --seed 3519000014 --stream 0
    JAX_PLATFORMS=cpu python3 tools/probe_fleet_drift.py --seed 5 --stream 1 --res 256 --chunk 4 --frames 8

Prints each step's judged numbers and its translation error at each loop
frame (``x`` marks a frame without a valid pose), then one
``{"fleet_drift": {...}}`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402
from perfbench.inputs import scene as scene_mod  # noqa: E402
from perfbench.inputs.render import render_u8  # noqa: E402
from perfbench.reference import judge  # noqa: E402
from perfbench.reference.geometry import se3_inverse  # noqa: E402

FIELDS = ("poses", "valid", "coord_id", "det_ids", "det_ok", "det_corners")
INTS = ("valid", "coord_id", "det_ids", "det_ok")


def stream_inputs(seed: int, stream: int, res: int, frames: int = 96, phase: int = 12) -> harness.Inputs:
    """The deployment's scene from the seed, and stream ``stream``'s first
    ``frames`` loop frames rendered at res x res on the CPU."""
    cfg = harness.config("sim_fleet8_1k")
    raw = harness.load_json(harness.HERE / "inputs" / cfg["scene"]["file"])
    raw = scene_mod.randomize_scene(raw, cfg["scene"]["randomize_percentage"], seed)
    sc = scene_mod.Scene(raw)
    K = scene_mod.intrinsics(res, res, float(raw["fov_y"]))
    pos, rot = scene_mod.scripted_waypoints(96, scene_mod.LOOP_WAYPOINTS)
    i = (np.arange(frames) + phase * stream) % 96
    return harness.Inputs(sc, K, res, res, pos[i], rot[i], render_u8(sc, pos[i], rot[i], K, res, res,
                                                                       torch.device("cpu")))


def run_port(inputs: harness.Inputs, chunk: int) -> list:
    """The port's step over the frames, chunk by chunk: the outputs and the
    landmark map after each chunk."""
    from aprilslam_tpu_torch.detect import DetectorParams
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.slam import build_slam_step

    cfg = harness.config("sim_fleet8_1k")
    cam = PinholeCamera.from_fov(inputs.width, inputs.height, float(inputs.scene.raw["fov_y"]))
    step, init = build_slam_step(inputs.scene.family, cam, inputs.scene.tag_size_inner,
                                 detector_params=DetectorParams(**cfg["detector"]), device="cpu", **cfg["step"])
    st, outs = init(), []
    for k in range(0, len(inputs.frames), chunk):
        st, o = step(st, inputs.frames[k:k + chunk])
        outs.append({**{f: getattr(o, f).numpy() for f in FIELDS},
                     "lm_pose": st[1].lm_pose.numpy().copy(), "lm_active": st[1].lm_active.numpy().copy()})
    return outs


def run_jax(inputs: harness.Inputs, chunk: int) -> list:
    """The JAX package's step, jitted, on the same frames and chunks."""
    import jax
    import jax.numpy as jnp

    from aprilslam_tpu.detect import DetectorParams
    from aprilslam_tpu.geometry import PinholeCamera
    from aprilslam_tpu.slam import build_slam_step

    cfg = harness.config("sim_fleet8_1k")
    frames = inputs.frames.numpy()
    with jax.enable_x64(False):
        cam = PinholeCamera.from_fov(inputs.width, inputs.height, float(inputs.scene.raw["fov_y"]))
        step, init = build_slam_step(inputs.scene.family, cam, inputs.scene.tag_size_inner,
                                     detector_params=DetectorParams(**cfg["detector"]), **cfg["step"])
        step = jax.jit(step)
        st, outs = init(), []
        for k in range(0, len(frames), chunk):
            st, o = step(st, jnp.asarray(frames[k:k + chunk]))
            o = jax.device_get(o)
            outs.append({**{f: np.asarray(getattr(o, f)) for f in FIELDS},
                         "lm_pose": np.asarray(st[1].lm_pose), "lm_active": np.asarray(st[1].lm_active)})
    return outs


def judged(inputs: harness.Inputs, outs: list, chunk: int) -> dict:
    """The stream's numbers as ``perfbench/entries/fleet.py`` judges one
    stream, and each frame's translation error in its reported tag's frame."""
    cat = {f: np.concatenate([o[f] for o in outs]) for f in FIELDS}
    lm_pose, lm_active = np.stack([o["lm_pose"] for o in outs]), np.stack([o["lm_active"] for o in outs])
    n = len(cat["valid"])
    gt = judge.ground_truth(inputs.scene, inputs.cam_pos[:n], inputs.cam_rot[:n], inputs.K)
    nums = judge.judge_camera_poses(cat["poses"], cat["valid"], cat["coord_id"], cat["det_ids"], cat["det_ok"],
                                    cat["det_corners"], np.repeat(lm_pose, chunk, 0)[:n],
                                    np.repeat(lm_active, chunk, 0)[:n], gt, inputs.scene,
                                    inputs.scene.tag_size_inner, inputs.K)
    nums.update(judge.judge_map(lm_pose, lm_active, inputs.scene))
    coord = torch.as_tensor(cat["coord_id"]).long()
    tag = torch.argmax((coord[:, None] == torch.as_tensor(inputs.scene.tag_ids())[None]).long(), -1)
    truth = se3_inverse(gt["T_ct"][torch.arange(n), tag])
    err = (torch.as_tensor(cat["poses"])[:, :3, 3].double() - truth[:, :3, 3]).norm(dim=-1).numpy()
    return {"nums": nums, "err": err, **cat}


def compare(seed: int, stream: int, res: int, chunk: int, frames: int) -> dict:
    """Both steps on the stream, judged, and their gaps."""
    inputs = stream_inputs(seed, stream, res, frames)
    port, ref = judged(inputs, run_port(inputs, chunk), chunk), judged(inputs, run_jax(inputs, chunk), chunk)
    both = port["valid"] & ref["valid"]
    return {"seed": seed, "stream": stream, "res": res, "chunk": chunk, "frames": frames,
            "loop_frames": ((np.arange(frames) + 12 * stream) % 96).tolist(),
            "port": port, "jax": ref,
            "ints_equal": {f: bool(np.array_equal(port[f], ref[f])) for f in INTS},
            "pose_gap_su": float(np.abs(port["poses"] - ref["poses"])[both].max()) if both.any() else 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--stream", type=int, default=0)
    ap.add_argument("--res", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--frames", type=int, default=96)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    r = compare(args.seed, args.stream, args.res, args.chunk, args.frames)
    for side in ("port", "jax"):
        print(side, {k: round(v, 4) if isinstance(v, float) else v for k, v in r[side]["nums"].items()})
        print("   err", " ".join(f"{f}:{e:.2f}{'' if v else 'x'}"
                                 for f, e, v in zip(r["loop_frames"], r[side]["err"], r[side]["valid"])))
    print(json.dumps({"fleet_drift": {
        "seed": r["seed"], "stream": r["stream"], "res": r["res"], "chunk": r["chunk"], "frames": r["frames"],
        "ate_su": {s: r[s]["nums"]["ate_su"] for s in ("port", "jax")},
        "map_rms_su": {s: r[s]["nums"]["map_rms_su"] for s in ("port", "jax")},
        "ints_equal": r["ints_equal"], "pose_gap_su": r["pose_gap_su"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
