"""Split the headline ATE's tail into map error and observation physics, on
the port (port of ``tools/probe_tail_split.py``).

For every frame of the headline run (``tools/probe_ate_dist_torch.py``'s
``headline_run``) it re-localizes the camera with the joint Gauss-Newton
(``slam/localize.joint_camera_pose``, 8 iterations, from the reported pose)
against (a) the run's final estimated landmark map and (b) the true map
(the scene's tag poses in the first tag's frame), and takes each
solution's smallest singular value of the 6-dof Jacobian
(``pose_observability``). If (b) still carries the tail, the error is the
observation's (a distant, frontal single tag), not the map's. Prints the
RMSE of the reported pose and of both re-localizations, their split by
visible tags, the error by sigma_min quartile, the RMSE after dropping the
least observable frames, the 10 worst frames, and one
``{"tail_split": {...}}`` line.

    python3 tools/probe_tail_split_torch.py                # on the card; exits 1 without one
    python3 tools/probe_tail_split_torch.py --device cpu --frames 16 --res 384
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_ate_dist_torch import device_args, frame_errors, headline_run, rmse, run_header  # noqa: E402


def true_map(cfg, traj, n_landmarks: int, device) -> tuple:
    """(landmark poses (M, 4, 4), slots held) of the scene's tags in the
    first tag's frame, the frame the pipeline's landmarks live in: with c[t]
    the camera's pose in tag t's frame, tag t sits at c[0] @ inv(c[t])."""
    from aprilslam_tpu_torch.sim import camera_in_tag_frames

    c = camera_in_tag_frames(
        torch.as_tensor(cfg.tag_positions()), torch.as_tensor(cfg.tag_rotations()),
        torch.tensor(np.asarray(traj.positions[:1]), dtype=torch.float32),
        torch.tensor(np.asarray(traj.rotations[:1]), dtype=torch.float32))[0].double()
    rel = (c[0] @ torch.linalg.inv(c)).float()
    world = torch.eye(4).repeat(n_landmarks, 1, 1)
    held = torch.zeros(n_landmarks, dtype=torch.bool)
    for i, t in enumerate(cfg.tag_ids()):
        if int(t) < n_landmarks:
            world[int(t)], held[int(t)] = rel[i], True
    return world.to(device), held.to(device)


def relocalize(cfg, cam, traj, o: dict, ba_state) -> dict:
    """Every frame re-localized in one batch on the BA state's device, from
    the step's outputs ``o`` (numpy, by ``outputs_numpy``'s fields) and its
    final BA state: the joint Gauss-Newton's pose in the frame's coordinate
    tag's frame and its ``pose_observability``, against the estimated map
    (``T_e``, ``smin_e``) and the true map (``T_g``, ``smin_g``), as numpy."""
    from aprilslam_tpu_torch.geometry import se3_inverse
    from aprilslam_tpu_torch.slam.localize import joint_camera_pose, pose_observability
    from aprilslam_tpu_torch.slam.pipeline import scatter_frame

    lm_pose, lm_active = ba_state.lm_pose, ba_state.lm_active
    dev, Ml = lm_pose.device, ba_state.n_landmarks
    K = torch.as_tensor(cam.matrix, dtype=torch.float32, device=dev)
    tag_size = cfg.tag_size_inner
    t = {k: torch.as_tensor(o[k], device=dev) for k in ("det_ids", "det_ok", "det_corners", "poses", "coord_id")}
    corn_m, seen = scatter_frame(t["det_ids"], t["det_ok"], t["det_corners"], Ml)
    c_slot = t["coord_id"].clamp(0, Ml - 1).long()
    gt_world, gt_held = true_map(cfg, traj, Ml, dev)

    def solve(world, held):
        use = seen & held
        T_wa = world[c_slot]
        T, _r = joint_camera_pose(world, use, corn_m, K, tag_size, T_wa @ t["poses"], iters=8)
        smin = pose_observability(world, use, K, tag_size, T)
        return (se3_inverse(T_wa) @ T).cpu().numpy(), smin.cpu().numpy()

    (T_e, smin_e), (T_g, smin_g) = solve(lm_pose, lm_active), solve(gt_world, gt_held)
    return {"T_e": T_e, "smin_e": smin_e, "T_g": T_g, "smin_g": smin_g}


def summarize(cfg, traj, o: dict, f: dict) -> dict:
    """The JAX probe's numbers from the step's outputs ``o`` and the
    re-localizations ``f`` (``relocalize``'s fields)."""
    err_rep, v, gt = frame_errors(cfg, traj, o)
    err_e = np.linalg.norm(f["T_e"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    err_g = np.linalg.norm(f["T_g"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    smin_e, smin_g = f["smin_e"], f["smin_g"]
    nvis = o["n_visible"]

    qs = np.quantile(smin_g[v], [0, 0.1, 0.25, 0.5, 1.0])
    buckets = []
    for lo, hi in zip(qs[:-1], qs[1:]):
        m = v & (smin_g >= lo) & (smin_g <= hi)
        buckets.append([float(lo), float(hi), int(m.sum()), rmse(err_g, m), rmse(err_e, m)])
    gating = []
    for frac in (0.0, 0.02, 0.05, 0.10):
        m = v & (smin_e >= np.quantile(smin_e[v], frac))
        gating.append([frac, int(m.sum()), rmse(err_e, m)])
    worst = np.argsort(err_e * v)[::-1][:10]
    return {
        "reported_rmse": rmse(err_rep, v), "est_map_rmse": rmse(err_e, v), "gt_map_rmse": rmse(err_g, v),
        "by_n_visible": {str(k): {"n": int((v & (nvis == k)).sum()), "est": rmse(err_e, v & (nvis == k)),
                                  "gt": rmse(err_g, v & (nvis == k))}
                         for k in range(1, 6) if (v & (nvis == k)).any()},
        "sigma_min_buckets": buckets,
        "gating": gating,
        "worst": [[int(i), int(nvis[i]), float(err_e[i]), float(err_g[i]), float(smin_e[i]), float(smin_g[i])]
                  for i in worst],
    }


def tail_split(cfg, cam, traj, o: dict, ba_state) -> dict:
    """``summarize`` of ``relocalize``."""
    return summarize(cfg, traj, o, relocalize(cfg, cam, traj, o, ba_state))


def print_tail_split(d: dict) -> None:
    """The JAX probe's lines."""
    print(f"reported    rmse={d['reported_rmse']:.4f}")
    print(f"est-map GN  rmse={d['est_map_rmse']:.4f}")
    print(f"GT-map GN   rmse={d['gt_map_rmse']:.4f}")
    for k, b in d["by_n_visible"].items():
        print(f"  nvis={k}: n={b['n']:4d} est {b['est']:.4f} gt {b['gt']:.4f}")
    print("\nsigma_min (GT map) vs error:")
    for lo, hi, n, g, e in d["sigma_min_buckets"]:
        print(f"  smin [{lo:8.3f},{hi:8.3f}]: n={n:4d} gt-rmse {g:.4f} est-rmse {e:.4f}")
    print("\nconfidence gating (est map, drop weakest by smin):")
    for frac, n, e in d["gating"]:
        print(f"  drop {frac * 100:4.1f}%: n={n:4d} est-rmse {e:.4f}")
    print("\nworst frames (est map):")
    for i, nv, ee, eg, se, sg in d["worst"]:
        print(f"  f{i:3d} nvis={nv} err est/gt {ee:6.3f}/{eg:6.3f} smin est/gt {se:7.3f}/{sg:7.3f}")


def main(argv=None) -> int:
    args = device_args(__doc__.split("\n\n")[0], argv)
    if args is None:
        return 1
    run = headline_run(args.device, args.frames, args.res)
    head = run_header(run, args.device)
    d = tail_split(run["cfg"], run["cam"], run["traj"], run["outputs"], run["ba_state"])
    print_tail_split(d)
    print(json.dumps({"tail_split": {**head, **d}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
