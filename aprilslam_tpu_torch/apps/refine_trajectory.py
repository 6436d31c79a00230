"""Offline long-trajectory refinement: keyframe-axis sharded global BA
(port of ``aprilslam_tpu/apps/refine_trajectory.py``).

The online pipeline (``apps/run_simulation.py``) is a fixed-lag system: its
BA window forgets keyframes beyond the ring. This app loads a dead-reckoned
trajectory with its tag observations and odometry, splits the keyframes
into contiguous windows over ``--devices`` shards (``parallel/keyframe_ba.py``;
the shards are a parameter of the problem and all run on the one device),
and solves one global bundle adjustment over the whole trajectory.

Problem files are the JAX app's ``.npz`` archives (``save_problem`` /
``load_problem``), so each app reads the other's files. ``--demo``
synthesizes a drifted serpentine sweep. ``--device`` is ``cuda`` (the
default: raises without a GPU, never falls back) or ``cpu``.

Usage:
  aprilslam-torch-refine --demo --keyframes 2048 --output refined.npz
  aprilslam-torch-refine --input problem.npz --devices 8 --output refined.npz
  aprilslam-torch-refine --device cpu --demo --keyframes 256 --landmarks 16
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FIELDS = (
    "kf_pose", "kf_active", "lm_pose", "lm_active",
    "obs_kf", "obs_lm", "obs_uv", "obs_ok",
    "odom_T", "odom_ok", "odom_weight",
)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_problem(path: str, prob, Kmat, tag_size: float = 10.0) -> None:
    np.savez_compressed(
        path,
        tag_size=np.float32(tag_size),
        **{f: _np(getattr(prob, f)) for f in FIELDS},
        K=_np(Kmat),
    )


def load_problem(path: str, device=None):
    """(problem, Kmat, tag_size) from a problem file, on ``device``
    (``None``: the CUDA device)."""
    from ..device import resolve_device
    from ..parallel import KeyframeBAProblem

    dev = resolve_device(device)
    with np.load(path) as z:
        prob = KeyframeBAProblem(**{f: torch.as_tensor(z[f], device=dev) for f in FIELDS})
        tag_size = float(z["tag_size"]) if "tag_size" in z else 10.0
        Kmat = torch.as_tensor(z["K"], device=dev)
    return prob, Kmat, tag_size


def problem_from_run(
    poses, valid, coord, det_ids, det_corners, det_ok,
    lm_world, lm_present, odom_weight: float = 1.0, device=None,
):
    """Build a KeyframeBAProblem from an online run's outputs (numpy).

    ``poses`` are the per-frame estimates in each frame's coordinate-tag
    frame; only frames whose coordinate tag equals the final anchor (and
    that are valid) become active keyframes — mixed-frame poses would
    corrupt the problem. Leading invalid frames are trimmed so global
    keyframe 0 (the solver's gauge pin) is always an active frame.
    Odometry edges are self-consistency factors between consecutive active
    frames (weight ``odom_weight``; they smooth, the corner observations
    carry the metric information). Landmarks come from the final online
    map (tag->world transforms).
    """
    from ..device import resolve_device
    from ..parallel import KeyframeBAProblem

    dev = resolve_device(device)
    poses = np.asarray(poses)
    valid = np.asarray(valid).astype(bool)
    coord = np.asarray(coord)
    final_anchor = coord[valid][-1] if valid.any() else -1
    active = valid & (coord == final_anchor)
    first = int(np.argmax(active)) if active.any() else 0
    sl = slice(first, len(poses))

    poses = poses[sl]
    active = active[sl]
    ids = np.asarray(det_ids)[sl]
    corners = np.asarray(det_corners)[sl]
    ok = np.asarray(det_ok)[sl]
    K = len(poses)
    M = int(np.asarray(lm_world).shape[0])

    # Observations: every ok detection of an active frame.
    frame_idx = np.repeat(np.arange(K), ids.shape[1])
    obs_kf = frame_idx.astype(np.int32)
    obs_lm = ids.reshape(-1).astype(np.int32)
    obs_uv = corners.reshape(-1, 4, 2).astype(np.float32)
    obs_ok = (ok.reshape(-1) & (obs_lm >= 0) & (obs_lm < M)
              & active[frame_idx]
              & np.asarray(lm_present)[np.clip(obs_lm, 0, M - 1)])
    obs_lm = np.clip(obs_lm, 0, M - 1)

    # Odometry between consecutive active frames only.
    odom_T = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    odom_ok = np.zeros(K, bool)
    for k in range(K - 1):
        if active[k] and active[k + 1]:
            odom_T[k] = np.linalg.inv(poses[k]) @ poses[k + 1]
            odom_ok[k] = True

    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return KeyframeBAProblem(
        kf_pose=t(poses.astype(np.float32)),
        kf_active=t(active),
        lm_pose=t(np.asarray(lm_world).astype(np.float32)),
        lm_active=t(np.asarray(lm_present).astype(bool)),
        obs_kf=t(obs_kf),
        obs_lm=t(obs_lm),
        obs_uv=t(obs_uv),
        obs_ok=t(obs_ok),
        odom_T=t(odom_T),
        odom_ok=t(odom_ok),
        odom_weight=t(np.full((K,), odom_weight, np.float32)),
    )


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser(
        prog="aprilslam-torch-refine",
        description="Global keyframe-axis sharded BA over one long trajectory (PyTorch/CUDA)",
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="problem .npz (see save_problem)")
    src.add_argument("--demo", action="store_true",
                     help="synthesize a drifted demo trajectory")
    ap.add_argument("--keyframes", type=int, default=2048, help="demo size")
    ap.add_argument("--landmarks", type=int, default=128, help="demo size")
    ap.add_argument("--devices", type=int, default=0,
                    help="kf-axis shard count (0 = one per visible device); all "
                         "shards run on --device")
    ap.add_argument("--iters", type=int, default=24, help="LM iterations")
    ap.add_argument("--cg-iters", type=int, default=128,
                    help="PCG depth per LM step (long trajectories need "
                         "~128 to traverse low-frequency drift modes)")
    ap.add_argument("--damping", type=float, default=1e-4)
    ap.add_argument("--tag-size", type=float, default=None,
                    help="tag side length in scene units (default: the "
                         "value stored in the problem file, or 10.0)")
    ap.add_argument("--output", "-o", default=None, help="refined .npz")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="execution device (cuda raises when no GPU is present)")
    return ap.parse_args(argv)


def _largest_divisor(n_keyframes: int, n: int) -> int:
    """The largest shard count not above ``n`` that divides the keyframes."""
    return next(d for d in range(n, 0, -1) if n_keyframes % d == 0)


def main(argv=None) -> int:
    args = parse_arguments(argv)

    from dataclasses import replace

    from ..device import resolve_device
    from ..parallel import (
        build_keyframe_ba, keyframe_ba_cost, make_mesh, partition_obs_by_keyframe,
        synthesize_trajectory_problem,
    )

    dev = resolve_device(args.device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    kf_gt = None
    if args.demo:
        n_dev = _largest_divisor(args.keyframes, args.devices or visible)
        prob, kf_gt, Kmat = synthesize_trajectory_problem(
            n_keyframes=args.keyframes, n_landmarks=args.landmarks,
            n_shards=n_dev, obs_per_kf=6, seed=7, device=dev,
        )
        K = prob.n_keyframes
        tag_size = args.tag_size if args.tag_size is not None else 10.0
    else:
        prob, Kmat, saved_tag_size = load_problem(args.input, device=dev)
        tag_size = args.tag_size if args.tag_size is not None else saved_tag_size
        K = prob.n_keyframes
        n_dev = _largest_divisor(K, args.devices or visible)
        # The file may have been partitioned for another shard count (or
        # not at all): equal shards must align with keyframe ownership, so
        # always re-bucket for the shard count in use (padding rows carry
        # obs_ok=False and re-bucket harmlessly).
        p_kf, p_lm, p_uv, p_ok = partition_obs_by_keyframe(
            _np(prob.obs_kf), _np(prob.obs_lm), _np(prob.obs_uv), _np(prob.obs_ok), K, n_dev,
        )
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        prob = replace(prob, obs_kf=t(p_kf), obs_lm=t(p_lm), obs_uv=t(p_uv), obs_ok=t(p_ok))
    print(f"{K} keyframes, {prob.n_landmarks} landmarks, "
          f"{int(prob.obs_ok.sum())} observations; "
          f"kf axis over {n_dev} shard(s) on {dev}", file=sys.stderr)

    c0 = float(keyframe_ba_cost(prob, Kmat, tag_size))
    run = build_keyframe_ba(
        make_mesh(n_dev, axis="kf", device=dev), K, prob.n_landmarks,
        int(prob.obs_kf.shape[0]), tag_size,
        iters=args.iters, cg_iters=args.cg_iters, damping=args.damping,
    )
    t0 = time.perf_counter()
    refined, _ = run(prob, Kmat)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = float(keyframe_ba_cost(refined, Kmat, tag_size))

    out = {
        "keyframes": K,
        "landmarks": prob.n_landmarks,
        "devices": n_dev,
        "cost_initial": round(c0, 1),
        "cost_refined": round(c1, 1),
        "solve_s": round(dt, 2),
        "finite": bool(torch.isfinite(refined.kf_pose).all()),
    }
    if kf_gt is not None:
        for name, p in (("ate_initial", prob), ("ate_refined", refined)):
            e = _np(p.kf_pose)[:, :3, 3] - kf_gt[:, :3, 3]
            out[name] = round(float(np.sqrt(np.mean(np.sum(e * e, -1)))), 4)
    if args.output:
        save_problem(args.output, refined, Kmat, tag_size)
        out["output"] = args.output
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
