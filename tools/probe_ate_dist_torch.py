"""The headline ATE's error distribution on the port (port of
``tools/probe_ate_dist.py``): is the RMSE a body or a tail?

Runs the bench's headline (``bench_torch``: its detector, its step at the
default knobs, chunks of 8) on the JAX bench's 512 poses
(``trajectory.reference_pool()``, rendered at 1000x1000 on the device by
``bench_torch.render_u8``; another ``--frames`` draws
``monte_carlo(n, seed=3)`` with numpy) and prints the per-frame translation
error's distribution, its split by the number of visible mapped tags, the
RMSE without the worst frames, the 10 worst frames, and one
``{"ate_dist": {...}}`` line.

    python3 tools/probe_ate_dist_torch.py                # on the card; exits 1 without one
    python3 tools/probe_ate_dist_torch.py --device cpu --frames 16 --res 384

``headline_run`` and ``outputs_numpy`` are the runner that
``tools/probe_tail_split_torch.py`` and ``tools/probe_negev_torch.py`` share;
``ate_distribution`` takes the step's outputs, so that a caller with its
own run (``chip_smoke.py``) can analyse it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIELDS = ("poses", "valid", "coord_id", "n_visible", "reproj_rms", "det_ids", "det_corners", "det_ok")


def outputs_numpy(outs) -> dict:
    """The step's outputs (a list of SlamOutputs, one per chunk, the port's
    or the JAX package's) as numpy arrays over all frames, by FIELDS."""
    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {k: np.concatenate([arr(getattr(o, k)) for o in outs]) for k in FIELDS}


def headline_run(device: str = "cuda", n_frames: int = 512, res: int = 1000, batch: int = 8,
                 frames=None, traj=None) -> dict:
    """The bench's headline step over ``headline_poses(n_frames)`` rendered at
    ``res`` on ``device``, or over ``frames`` ((N, res, res) uint8, any
    array) shot from ``traj`` where those are given. Returns the scene
    config, camera, trajectory, pool label, the outputs (``outputs_numpy``)
    and the step's own per-chunk outputs (``chunks``), the final BA state
    and the step's seconds (synchronised)."""
    from bench_torch import Knobs, headline_params, headline_poses, render_u8

    from aprilslam_tpu_torch.device import resolve_device
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.sim import SceneConfig, scene_tensors
    from aprilslam_tpu_torch.slam import SlamSystem

    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    if frames is None:
        traj, pool = headline_poses(n_frames)
        frames = render_u8(scene_tensors(cfg, device=dev), traj, cam, res, res, dev, batch)
    else:
        frames, pool = torch.as_tensor(frames, device=dev), "given"
    slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, detector_params=headline_params(), device=dev,
                      **Knobs.from_env(False, env={}).step_kwargs())
    sync()
    t0 = time.perf_counter()
    outs = [slam.process(c) for c in frames.split(batch)]
    sync()
    return {"cfg": cfg, "cam": cam, "traj": traj, "pool": pool, "outputs": outputs_numpy(outs), "chunks": outs,
            "ba_state": slam.ba_state, "step_s": time.perf_counter() - t0}


def frame_errors(cfg, traj, o: dict) -> tuple:
    """(translation error per frame, the frames scored: valid and reported in
    a scene tag's frame, the true camera pose in that frame per frame), as
    ``eval/ate.py`` and ``bench.py`` score them."""
    from aprilslam_tpu_torch.sim import camera_in_tag_frames

    ids = cfg.tag_ids()
    gt_all = camera_in_tag_frames(
        torch.as_tensor(cfg.tag_positions()), torch.as_tensor(cfg.tag_rotations()),
        torch.tensor(np.asarray(traj.positions), dtype=torch.float32),
        torch.tensor(np.asarray(traj.rotations), dtype=torch.float32)).numpy()
    id_to_idx = {int(t): i for i, t in enumerate(ids)}
    t_idx = np.array([id_to_idx.get(int(c), -1) for c in o["coord_id"]])
    gt = gt_all[np.arange(len(t_idx)), np.clip(t_idx, 0, len(ids) - 1)]
    err = np.linalg.norm(o["poses"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    return err, o["valid"] & (t_idx >= 0), gt


def rmse(e: np.ndarray, m: np.ndarray) -> float:
    return float(np.sqrt(np.mean(e[m] ** 2))) if m.any() else float("nan")


def ate_distribution(cfg, traj, o: dict) -> dict:
    """The JAX probe's numbers from the step's outputs ``o`` (numpy, by
    FIELDS: ``poses``, ``valid``, ``coord_id``, ``n_visible``,
    ``reproj_rms``)."""
    err, v, _gt = frame_errors(cfg, traj, o)
    nvis, rms = o["n_visible"], o["reproj_rms"]
    e = err[v]
    s = np.sort(e)[::-1]
    worst = np.argsort(err * v)[::-1][:10]
    return {
        "n": int(len(e)), "rmse": rmse(err, v), "mean": float(e.mean()), "median": float(np.median(e)),
        "p90": float(np.percentile(e, 90)), "p99": float(np.percentile(e, 99)), "max": float(e.max()),
        "by_n_visible": {str(k): {"n": int((v & (nvis == k)).sum()), "rmse": rmse(err, v & (nvis == k)),
                                  "median": float(np.median(err[v & (nvis == k)])),
                                  "max": float(err[v & (nvis == k)].max())}
                         for k in range(6) if (v & (nvis == k)).any()},
        "rmse_excluding_top": {str(k): float(np.sqrt(np.mean(s[k:] ** 2))) for k in (5, 10, 20, 50) if k < len(s)},
        "worst": [[int(i), float(err[i]), int(nvis[i]), float(rms[i])] for i in worst],
    }


def print_ate_distribution(d: dict) -> None:
    """The JAX probe's lines."""
    print(f"n={d['n']} rmse={d['rmse']:.4f} mean={d['mean']:.4f} median={d['median']:.4f} p90={d['p90']:.4f} "
          f"p99={d['p99']:.4f} max={d['max']:.4f}")
    for k, b in d["by_n_visible"].items():
        print(f"  nvis={k}: n={b['n']:4d} rmse={b['rmse']:.4f} median={b['median']:.4f} max={b['max']:.4f}")
    for k, r in d["rmse_excluding_top"].items():
        print(f"rmse excluding top {k}: {r:.4f}")
    print("worst frames:", [(i, round(e, 3), nv, round(r, 2)) for i, e, nv, r in d["worst"]])


def device_args(description: str, argv=None):
    """The probes' command line: ``--device`` (exits 1 without a GPU unless
    ``cpu``), ``--frames`` and ``--res``. Returns the arguments or None."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits 1 without a GPU) or cpu")
    ap.add_argument("--frames", type=int, default=512,
                    help="frames, a multiple of 8 (512: the JAX bench's poses; else numpy monte_carlo(n, seed=3))")
    ap.add_argument("--res", type=int, default=1000, help="square frame size")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return None
    if args.frames <= 0 or args.frames % 8:
        ap.error("--frames must be a positive multiple of 8")
    return args


def run_header(run: dict, device: str) -> dict:
    """The device, card and pool of a ``headline_run``, for a probe's line."""
    from aprilslam_tpu_torch.device import card_line

    on_cuda = device == "cuda"
    print(f"device: {torch.cuda.get_device_name(0) if on_cuda else 'cpu'}; {len(run['traj'])} frames "
          f"({run['pool']}) in {run['step_s']:.1f} s", flush=True)
    return {"device": torch.cuda.get_device_name(0) if on_cuda else "cpu", "card": card_line() if on_cuda else None,
            "frames": len(run["traj"]), "pool": run["pool"], "step_s": run["step_s"]}


def main(argv=None) -> int:
    args = device_args(__doc__.split("\n\n")[0], argv)
    if args is None:
        return 1
    run = headline_run(args.device, args.frames, args.res)
    head = run_header(run, args.device)
    d = ate_distribution(run["cfg"], run["traj"], run["outputs"])
    print_ate_distribution(d)
    print(json.dumps({"ate_dist": {**head, **d}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
