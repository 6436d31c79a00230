"""Simulation CLI (port of ``aprilslam_tpu/apps/run_simulation.py``).

The reference's render -> detect -> estimate -> GT-compare -> log cycle,
run in device-batched chunks, with the coloured terminal dashboard and the
three CSV logs. Flags are the JAX CLI's; ``--device`` is ``cuda`` (the
default: raises without a GPU, never falls back) or ``cpu``.

Each chunk's outputs reach the host once, one ``.cpu()`` per field; the
per-frame and per-node loops read only those numpy copies, so they make no
host sync. The ground truth is computed on the host from the trajectory.

    python -m aprilslam_tpu_torch.apps.run_simulation --frames 64 --headless
    python -m aprilslam_tpu_torch.apps.run_simulation --device cpu --resolution 256 --frames 8
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

OUTPUT_FIELDS = ("poses", "valid", "pose_obs", "n_nodes", "avg_node_distance", "reproj_rms",
                 "coord_id", "node_visible", "node_weight", "node_local", "node_world")
EXPORT_FIELDS = ("det_ids", "det_corners", "det_ok")


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(
        description="AprilTag SLAM simulation (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="execution device (cuda raises when no GPU is present)")
    p.add_argument("--config", "-c", default=None, help="scene config JSON path")
    p.add_argument("--no-movement", action="store_true",
                   help="Monte Carlo teleporting camera (reference parity mode)")
    p.add_argument("--debug", action="store_true", help="debug logging")
    p.add_argument("--legacy", action="store_true",
                   help="reference-parity estimator (exact chaining + raw averaging, "
                        "like the reference's legacy engine)")
    p.add_argument("--frames", type=int, default=64, help="total frames to process")
    p.add_argument("--batch", type=int, default=8, help="frames per device chunk")
    p.add_argument("--resolution", type=int, default=None,
                   help="override render resolution (default: config display size)")
    p.add_argument("--estimator", choices=["reference_chain", "chain_avg", "joint", "ba"],
                   default="ba")
    p.add_argument("--trajectory", choices=["line", "orbit", "walk", "monte_carlo"],
                   default="walk")
    p.add_argument("--decimate", type=int, default=2, help="detector quad decimation")
    p.add_argument("--output-dir", default="data/csv", help="CSV output directory")
    p.add_argument("--save-viz", default=None,
                   help="directory to save visualizer snapshots (map/graph/error; needs matplotlib)")
    p.add_argument("--export-problem", default=None, metavar="NPZ",
                   help="export the run (poses, detections, odometry, map) as a "
                        "global-BA problem for aprilslam-torch-refine")
    p.add_argument("--headless", action="store_true", help="no dashboard printing")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for SLAM-state checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=32,
                   help="checkpoint interval in frames")
    p.add_argument("--resume", action="store_true",
                   help="resume SLAM state from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--pgo", action="store_true",
                   help="enable the pose-graph backend: loop-closure edges "
                        "from re-observed landmarks redistribute drift "
                        "(ba estimator only)")
    p.add_argument("--interactive", action="store_true",
                   help="manual camera control from the terminal (WASD/QE + "
                        "IJKL/UO keys, reference camera_controller.py:65-103)")
    return p.parse_args(argv)


def setup_logging(debug: bool, log_dir: str = "data/logs"):
    os.makedirs(log_dir, exist_ok=True)
    level = logging.DEBUG if debug else logging.INFO
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[
            logging.FileHandler(os.path.join(log_dir, "simulation_runner.log"), mode="w"),
            logging.StreamHandler(sys.stdout),
        ],
        force=True,
    )


GREEN, YELLOW, RED, RESET, CLEAR = "\033[92m", "\033[93m", "\033[91m", "\033[0m", "\033[2J\033[H"


def fmt_distance(value_su: float, to_mm) -> str:
    """mm/cm/m autoscaling (simulation_engine.py:423-446)."""
    mm = to_mm(value_su)
    if abs(mm) < 10:
        return f"{mm:.2f} mm"
    if abs(mm) < 1000:
        return f"{mm / 10:.2f} cm"
    return f"{mm / 1000:.3f} m"


def colour_for(err_mm: float) -> str:
    if err_mm < 10:
        return GREEN
    if err_mm < 30:
        return YELLOW
    return RED


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    setup_logging(args.debug)
    log = logging.getLogger("aprilslam")

    import numpy as np
    import torch

    from ..detect import DetectorParams
    from ..eval import DataLogger, trajectory_report
    from ..geometry import PinholeCamera
    from ..sim import (
        SceneConfig, camera_in_tag_frames, camera_to_tag_transforms, render_frames,
        scene_tensors, trajectory,
    )
    from ..slam import SlamSystem

    if args.legacy:
        args.estimator = "reference_chain"
    try:
        cfg = SceneConfig.from_file(args.config)
    except (ValueError, OSError) as e:
        log.error(f"Config error: {e}")
        log.error("Check the scene JSON: required keys, positive sizes, non-empty tags.")
        return 2

    res = args.resolution or cfg.display_width
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    log.info(f"Scene: {len(cfg.tags)} tags, family {cfg.family}, {res}x{res}, "
             f"fx={cam.fx:.1f}, device {dev}")

    n = (args.frames // args.batch) * args.batch
    if args.no_movement or args.trajectory == "monte_carlo":
        traj = trajectory.monte_carlo(n, seed=args.seed)
    elif args.trajectory == "line":
        traj = trajectory.scripted_line(n)
    elif args.trajectory == "orbit":
        traj = trajectory.orbit(n)
    else:
        traj = trajectory.smooth_random_walk(n, seed=args.seed)

    # Landmark capacity sized to the scene (slot = tag id), rounded up to a
    # multiple of 8 with a floor of 16, as in the JAX CLI.
    cap = max(16, -(-(max(cfg.tag_ids()) + 2) // 8) * 8)
    slam = SlamSystem(
        cam, cfg.family, cfg.tag_size_inner,
        estimator=args.estimator,
        detector_params=DetectorParams(quad_decimate=args.decimate, min_cluster_pts=12),
        pgo=args.pgo,
        graph_capacity=cap,
        device=dev,
    )

    viz = None
    if args.save_viz:
        os.makedirs(args.save_viz, exist_ok=True)
        from ..viz import SlamVisualizer

        viz = SlamVisualizer(interactive=False)

    # Ground truth on the host: the trajectory is numpy already.
    tag_pos = torch.as_tensor(cfg.tag_positions())
    tag_rot = torch.as_tensor(cfg.tag_rotations())
    ids = cfg.tag_ids()
    id_to_idx = {int(t): i for i, t in enumerate(ids)}
    tag_pos_np = np.asarray(cfg.tag_positions())
    est_all, gt_all, valid_all, obs_all = [], [], [], []
    # --export-problem: the run's poses and detections, chunk by chunk.
    export = ([], [], [], [], [], []) if args.export_problem else None
    fetch = OUTPUT_FIELDS + (EXPORT_FIELDS if export is not None else ())

    ckpt = None
    if args.checkpoint_dir:
        from ..utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        if args.resume:
            try:
                step0 = ckpt.latest_step()
                slam.state = ckpt.restore(slam.state)
                log.info(f"Resumed SLAM state from checkpoint step {step0}")
            except FileNotFoundError:
                log.warning(f"--resume: no checkpoint under {args.checkpoint_dir}; "
                            "starting fresh")

    icam = None
    keyreader = None
    if args.interactive:
        from ..sim.interactive import HELP, InteractiveCamera, TerminalKeys

        icam = InteractiveCamera(size_scale=cfg.size_scale,
                                 position=(0.0, 0.0, 25.0))
        keyreader = TerminalKeys().__enter__()
        print(HELP)

    def chunk_poses(s):
        """(pos, rot) numpy chunks for frames [s, s+batch)."""
        if icam is None:
            return traj.positions[s : s + args.batch], traj.rotations[s : s + args.batch]
        ps, rs = [], []
        for _ in range(args.batch):
            icam.apply_keys(keyreader.read_available(timeout=0.02))
            ps.append(icam.position.copy())
            rs.append(icam.rotation.copy())
        return np.stack(ps), np.stack(rs)

    t_start = time.time()
    last_node_gt = {}
    with DataLogger(args.output_dir) as dlog:
        for s in range(0, n, args.batch):
            pos_np, rot_np = chunk_poses(s)
            frames = render_frames(scene, pos_np, rot_np, cam.inv_matrix, res, res, 2, device=dev)
            outs = slam.process(frames)
            # One host copy per output field for the whole chunk.
            h = {k: getattr(outs, k).cpu().numpy() for k in fetch}
            pos = torch.as_tensor(pos_np, dtype=torch.float32)
            rot = torch.as_tensor(rot_np, dtype=torch.float32)
            # GT transforms for ALL tags at this chunk's camera poses:
            # per-frame pose GT + per-node error attribution share them.
            gt_tags = camera_to_tag_transforms(tag_pos, tag_rot, pos, rot).numpy()
            # Each frame's estimate lives in THAT frame's coordinate-tag
            # frame (coord_id): the anchor is the lowest id seen so far
            # and can change mid-run, so GT must be picked per frame.
            coord = h["coord_id"]
            anchor = int(coord[-1])
            gt_all_tags = camera_in_tag_frames(tag_pos, tag_rot, pos, rot).numpy()
            gt = np.broadcast_to(np.eye(4), (args.batch, 4, 4)).copy()
            frame_aidx = np.full(args.batch, -1)
            for b in range(args.batch):
                t_i = id_to_idx.get(int(coord[b]))
                if t_i is not None:
                    gt[b] = gt_all_tags[b, t_i]
                    frame_aidx[b] = t_i
            est, valid, obs, nn = h["poses"], h["valid"], h["pose_obs"], h["n_nodes"]
            ad, rms = h["avg_node_distance"], h["reproj_rms"]
            node_vis, node_w = h["node_visible"], h["node_weight"]
            node_local, node_world = h["node_local"], h["node_world"]
            for b in range(args.batch):
                if not valid[b] or frame_aidx[b] < 0:
                    continue
                dlog.log_frame(est[b], gt[b], int(nn[b]), float(ad[b]),
                               t=time.time() - t_start, reproj_rms=float(rms[b]))
                est_all.append(est[b])
                gt_all.append(gt[b])
                obs_all.append(float(obs[b]))
                # Per-visible-node error attribution (reference
                # simulation_engine.py:302-356): GT camera->tag transform,
                # GT tag->anchor distance, |est - GT| distance errors.
                for tid in np.nonzero(node_vis[b])[0]:
                    t_i = id_to_idx.get(int(tid))
                    if t_i is None:
                        continue
                    gt_local = gt_tags[b, t_i]
                    gt_world_dist = float(
                        np.linalg.norm(tag_pos_np[t_i] - tag_pos_np[frame_aidx[b]])
                    )
                    loc = node_local[b, tid]
                    wor = node_world[b, tid]
                    err_local = abs(float(np.linalg.norm(loc[:3, 3]))
                                    - float(np.linalg.norm(gt_local[:3, 3])))
                    err_world = abs(float(np.linalg.norm(wor[:3, 3])) - gt_world_dist)
                    t_err = float(np.linalg.norm(loc[:3, 3] - gt_local[:3, 3]))
                    dlog.log_node(float(node_w[b, tid]), loc, wor, gt_local,
                                  err_world, err_local, t_err)
                    last_node_gt[int(tid)] = (
                        gt_world_dist, float(np.linalg.norm(gt_local[:3, 3]))
                    )
            valid_all.append(valid)
            if export is not None:
                for buf, arr in zip(export, (est, valid, coord, h["det_ids"], h["det_corners"], h["det_ok"])):
                    buf.append(arr)
            if ckpt is not None and ((s + args.batch) % max(args.checkpoint_every, args.batch) == 0
                                     or s + args.batch >= n):
                ckpt.save(s + args.batch, slam.state)
            if icam is not None and icam.quit:
                log.info("Interactive session ended by user (x).")
                break

            if not args.headless and valid.any():
                b = int(np.nonzero(valid)[0][-1])
                te = float(np.linalg.norm(est[b][:3, 3] - gt[b][:3, 3]))
                re = float(np.linalg.norm(est[b][:3, :3] - gt[b][:3, :3]))
                te_mm = cfg.simulation_units_to_mm(te)
                c = colour_for(te_mm)
                done = s + args.batch
                fps = done / (time.time() - t_start)
                print(
                    f"{CLEAR}=== AprilSLAM (PyTorch/{dev.type}) ===\n"
                    f"frames      : {done}/{n}   ({fps:.1f} fps incl. host loop)\n"
                    f"nodes       : {int(nn[b])}   anchor tag {anchor}\n"
                    f"est pos     : {np.round(est[b][:3, 3], 2)}\n"
                    f"gt  pos     : {np.round(gt[b][:3, 3], 2)}\n"
                    f"trans error : {c}{fmt_distance(te, cfg.simulation_units_to_mm)}{RESET}\n"
                    f"rot error   : {re:.4f} (Frobenius)\n"
                )

        stats = dlog.get_statistics()

    if keyreader is not None:
        keyreader.__exit__()
    if ckpt is not None:
        ckpt.close()

    if viz is not None:
        gstate = slam.graph_state
        viz.vis_slam(gstate, save_path=os.path.join(args.save_viz, "map3d.png"))
        viz.slam_graph(gstate, save_path=os.path.join(args.save_viz, "graph.png"))
        if last_node_gt:
            viz.error_graph(
                gstate,
                gt_world_dist={t: v[0] for t, v in last_node_gt.items()},
                gt_local_dist={t: v[1] for t, v in last_node_gt.items()},
                save_path=os.path.join(args.save_viz, "error_graph.png"),
            )

    if not est_all:
        log.warning("No valid pose estimates produced.")
        return 1
    rep = trajectory_report(
        np.stack(est_all), np.stack(gt_all), unit_to_mm=cfg.simulation_units_to_mm(1.0)
    )
    log.info(f"ATE RMSE: {rep['ate_rmse']:.4f} su "
             f"({rep['translation_mm']['rmse']:.2f} mm); "
             f"mean {rep['translation']['mean']:.4f} su; "
             f"rotation mean {rep['rotation']['mean']:.5f}")
    # Low-confidence poses: near-zero observability marks frames whose pose
    # is weakly constrained (single frontal tag at distance) even when the
    # reprojection rms looks perfect (slam/localize.py:pose_observability).
    n_weak = int(np.sum(np.asarray(obs_all) < 0.25)) if obs_all else 0
    log.info(f"Valid pose rate: {np.concatenate(valid_all).mean():.3f}; "
             f"low-confidence poses (pose_obs<0.25): {n_weak}/{len(obs_all)}; "
             f"runtime {stats['runtime_seconds']:.1f}s; "
             f"avg {stats['average_fps']:.2f} fps")
    summary = {
        "ate_rmse_su": round(rep["ate_rmse"], 4),
        "ate_rmse_mm": round(rep["translation_mm"]["rmse"], 2),
        "frames": len(est_all),
        "low_confidence_frames": n_weak,
        "fps": round(stats["average_fps"], 2),
        "estimator": args.estimator,
    }
    if args.pgo and slam.pgo_state is not None:
        summary["loop_closures"] = int(slam.pgo_state.n_loops)
    if export is not None:
        from .refine_trajectory import problem_from_run, save_problem

        poses_e, valid_e, coord_e, ids_e, corners_e, ok_e = (np.concatenate(b) for b in export)
        gstate = slam.graph_state
        lm_world, lm_present = gstate.world.cpu().numpy(), gstate.present.cpu().numpy()
        ba = slam.ba_state
        if ba is not None and valid_e.any():
            # Prefer the refined BA landmarks, conjugated into the anchor
            # (coordinate-tag) frame the exported poses live in.
            anchor = int(coord_e[valid_e][-1])
            lm_pose = ba.lm_pose.cpu().numpy()
            lm_act = ba.lm_active.cpu().numpy()
            if 0 <= anchor < len(lm_pose) and lm_act[anchor]:
                T_wa_inv = np.linalg.inv(lm_pose[anchor])
                lm_world = np.einsum("ij,mjk->mik", T_wa_inv, lm_pose)
                lm_present = lm_act
        prob = problem_from_run(poses_e, valid_e, coord_e, ids_e, corners_e, ok_e,
                                lm_world, lm_present, device="cpu")
        save_problem(args.export_problem, prob, cam.matrix, tag_size=cfg.tag_size_inner)
        summary["exported_problem"] = args.export_problem
        summary["exported_keyframes"] = prob.n_keyframes
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
