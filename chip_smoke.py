"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--frames 64 | --reference-pool]

Phases (any failed check exits non-zero):
1. card: name and power limit; fails without a CUDA device;
2. build the CCL kernel (csrc/ccl.cu) with nvcc for sm_90a;
3. the kernel against its plain PyTorch version and a scipy oracle, bit for
   bit, on block-random, uniform, odd-sized, serpentine and rendered
   main-path inputs and on stress inputs that cross tile borders
   (checkerboard, stripes, staircase, 1x1, 1x501, 501x1, a batch of 32);
   the kernel timed with CUDA events on four inputs (back-to-back eager
   calls, as the main path makes them, and device time from a replayed CUDA
   graph), the plain version on the main-path one, and each of the kernel's
   launches with torch.profiler;
4. the main path: render the default 5-tag scene at 1000x1000 on the card,
   cast to uint8, run the headline SLAM configuration in chunks of 8, and
   check ATE against the analytic ground truth, the valid rate, the kernel's
   launch count and that every output lives on the card;
5. BASELINE config 2 (``bench.py``'s pgo leg): the randomized scene, the
   two-lap loop of 96 frames at 1000x1000, the chunk-scheduled BA step with
   the loop-closure back end off and then on; per leg an accuracy pass, two
   timed passes (best of two), ATE, valid rate, loop edges, the kernel's
   launches, and one step's host syncs, kernel launches and busy share;
6. every other estimator and schedule for one chunk of the main-path frames
   (``reference_chain``, ``chain_avg``, ``joint``, the frame schedule, zero
   distortion coefficients against none), and the sparse BA coupling
   against the dense one from the main path's final BA state;
7. the apps, on the card in this process: the simulation CLI at the
   scene's 1000x1000 with its defaults (64 frames of the random walk; its
   fps against ``SlamSystem.process`` alone on the same frames), a ``--pgo``
   orbit run, a checkpointed run and its ``--resume``; the SLAM service at
   its defaults in a thread (poses against an in-process step, stats,
   reset, a malformed request); and the installation verifier. The CCL
   launches of the CLI run and of the service's requests are counted;
8. BASELINE config 4, the real-camera path (``bench.py:525-584``): the
   native runtime (built with g++ beside the kernel in phase 2) and its CPU
   rasterizer against the card's; Zhang calibration on the card (the
   distorted views of ``tests/test_calib.py`` against their truth, then the
   config-4 camera, saved as the app's ``.npz``); the 64-frame 640x480 Y4M
   clip rendered on the card and replayed through the native reader,
   batched detection and PnP (a warm-up pass kept for accuracy, a timed
   pass); the video app in process on that clip and calibration; and a
   generated 1024-code family against the built-in one on 8 headline poses;
9. the parallel package: BASELINE config 3 (``bench.py:465-522``: 8
   sequences x 2 chunks of 8 frames at 1000x1000 through
   ``build_parallel_slam``, a warm pass kept for accuracy, one timed pass,
   then one chunk with both pose graphs on); config 5 on the keyframe axis
   (10240 keyframes, 256 tags, 4 LM x 32 PCG) and the landmark axis (10240
   tags, 64 keyframes, 16384 observations, 4 LM), each at 1 and 8 shards on
   the one card, with the landmark solve once more on a single-rank NCCL
   process group; ``aprilslam-torch-refine --demo`` at its defaults at 1 and
   8 shards; a 16-frame CLI run's ``--export-problem`` refined on the card;
10. the CCL timing line (the config-4 map 8x240x320 included), one JSON line
   per kernel, the card line, and a final JSON status line.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import Counter
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import torch

HEADLINE = dict(
    estimator="ba", ba_schedule="chunk", graph_capacity=16, ba_keyframes=16,
    ba_obs=512, init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3,
)
CONFIG2 = dict(estimator="ba", ba_schedule="chunk", graph_capacity=16, init_joint_iters=3,
               ba_chunk_iters=4, pnp_iters=3)
# bench.py:400-404, the two-lap loop of config 2
WAYPOINTS = np.array([
    [0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [60.0, 2.0, 12.0],
    [0.0, 0.0, 10.0], [2.0, 1.0, 11.0], [60.0, 0.0, 10.0],
    [60.0, 2.0, 12.0], [0.0, 0.0, 10.0],
])
CONFIG2_FRAMES = 96
# BASELINE config 3 (bench.py:465-522): 8 sequences, 2 chunks of 8 frames
# each, the headline step.
CONFIG3 = dict(estimator="ba", ba_schedule="chunk", init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3,
               graph_capacity=16)
CONFIG3_SEQ, CONFIG3_CHUNKS = 8, 2
# BASELINE config 5 (tools/scaling_bench.py --mode kf and --mode lm).
CONFIG5_KF = dict(keyframes=10240, landmarks=256, iters=4, cg_iters=32)
CONFIG5_LM = dict(landmarks=10240, keyframes=64, obs=16384, iters=4)
# The JAX refine demo's cost_refined at its defaults on the CPU, by shard count.
REFINE_JAX_CPU_COST = {1: 9081.0, 8: 8934.6}
APPS_FRAMES = 64  # the simulation CLI's default --frames
BATCH = 8
RES = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The port's median translation error (scene units) over the config-4
# clip's ok tag poses, on the JAX-rendered frames on the CPU
# (tests/parity_config4.py; the JAX package gives 0.1283475, 162 poses each).
CONFIG4_CPU_T_ERR_MEDIAN = 0.12829819321632385


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def scipy_labels(trinary: np.ndarray) -> np.ndarray:
    """Oracle: scipy 4-connected labelling per colour, relabelled to the
    minimum linear index of each component; unknown pixels get H*W."""
    from scipy import ndimage

    B, H, W = trinary.shape
    out = np.full((B, H * W), H * W, dtype=np.int64)
    for b in range(B):
        for colour in (0, 1):
            lab, n = ndimage.label(trinary[b] == colour)
            if n == 0:
                continue
            flat = lab.ravel()
            ids, first = np.unique(flat, return_index=True)
            keep = ids > 0
            root = np.zeros(n + 1, dtype=np.int64)
            root[ids[keep]] = first[keep]
            m = flat > 0
            out[b, m] = root[flat[m]]
    return out.reshape(B, H, W)


def serpentine(H: int, W: int) -> np.ndarray:
    """A one-pixel-wide white path snaking over the whole frame on black."""
    t = np.zeros((H, W), np.int8)
    t[0::2, :] = 1
    for r in range(1, H, 2):
        t[r, W - 1 if (r // 2) % 2 == 0 else 0] = 1
    return t[None]


def block_random(rng, B, H, W, block=4) -> np.ndarray:
    base = rng.integers(-1, 2, size=(B, -(-H // block), -(-W // block))).astype(np.int8)
    return np.repeat(np.repeat(base, block, axis=1), block, axis=2)[:, :H, :W].copy()


def stress_cases(rng) -> dict:
    """Inputs that cross tile borders in every way: no same-colour neighbour
    at all (checkerboard), one long component per column (1-pixel stripes),
    diagonal bands that cross many tiles (staircase), frames narrower or
    shorter than a tile or with W % 4 != 0, and a large batch."""
    y, x = np.mgrid[:500, :500]
    frames = lambda img: np.broadcast_to(img.astype(np.int8), (8, 500, 500)).copy()
    return {
        "checkerboard_8x500x500": frames((y + x) % 2),
        "stripes_8x500x500": frames(x % 2),
        "staircase_8x500x500": frames((x - y) % 16 < 2),
        "pixel_random_2x1x1": rng.integers(-1, 2, size=(2, 1, 1)).astype(np.int8),
        "pixel_random_2x1x501": rng.integers(-1, 2, size=(2, 1, 501)).astype(np.int8),
        "pixel_random_2x501x1": rng.integers(-1, 2, size=(2, 501, 1)).astype(np.int8),
        "block_random_2x37x501": block_random(rng, 2, 37, 501),
        "block_random_32x500x500": block_random(rng, 32, 500, 500),
    }


def launch_split(fn, reps: int = 20) -> dict:
    """Mean device ms of each of the kernel's launches per call, by kernel
    name (torch.profiler)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"ccl_\w+", e.key)
        if e.device_type == DeviceType.CUDA and name:
            split[name.group(0)] = e.self_device_time_total / 1e3 / reps
    return split or {"ccl": "not measured"}


def time_cuda(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cuda_graph(fn, reps: int = 20, replays: int = 20) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA graph
    and replayed, so that the host's per-call overhead (allocation, ctypes,
    launches: tens of microseconds) stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_cuda(graph.replay, replays) / reps


def render_chunks(cfg, cam, traj, n: int, dev) -> list:
    """uint8 frames of ``traj`` rendered on the card, in chunks of BATCH."""
    from aprilslam_tpu_torch.sim import render_frames, scene_tensors

    scene = scene_tensors(cfg, device=dev)
    return [
        torch.clamp(render_frames(scene, traj.positions[i:i + BATCH], traj.rotations[i:i + BATCH],
                                  cam.inv_matrix, RES, RES, 2, device=dev) * 255.0, 0, 255
                    ).to(torch.uint8)
        for i in range(0, n, BATCH)
    ]


def check_outputs(outs, n: int, what: str) -> None:
    for o in outs:
        for name, v in vars(o).items():
            check(v.device.type == "cuda", f"{what}: output {name} is on {v.device}")
    poses = torch.cat([o.poses for o in outs])
    valid = torch.cat([o.valid for o in outs])
    check(poses.shape == (n, 4, 4), f"{what}: poses shape {tuple(poses.shape)}")
    check(bool(torch.isfinite(poses[valid]).all()), f"{what}: non-finite pose on a valid frame")


def config2_phase(params, dev, card: str) -> tuple[dict, dict]:
    """BASELINE config 2, pgo off then on (``bench.py:381-462`` on the port).
    Returns the report and the CCL launches of each leg's accuracy pass."""
    from aprilslam_tpu_torch.eval import ate_eval
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.sim import DEFAULT_SCENE, SceneConfig, randomize_scene, trajectory
    from aprilslam_tpu_torch.slam import SlamSystem

    with open(DEFAULT_SCENE) as f:
        cfg = SceneConfig.from_dict(randomize_scene(json.load(f), 0.1, seed=7))
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    traj = trajectory.scripted_waypoints(CONFIG2_FRAMES, WAYPOINTS)
    chunks = render_chunks(cfg, cam, traj, CONFIG2_FRAMES, dev)
    torch.cuda.synchronize()
    out = {"frames": CONFIG2_FRAMES, "trajectory": "two-lap loop", "scene": "randomized(0.1, seed 7)",
           "batch": BATCH, "res": RES, "card": card}
    launches = {}
    for pgo in (False, True):
        leg = "pgo_on" if pgo else "pgo_off"
        slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, detector_params=params, device=dev,
                          pgo=pgo, **CONFIG2)
        ccl.ccl_launches = 0
        t0 = time.perf_counter()
        outs = [slam.process(c) for c in chunks]  # accuracy pass, also the warm-up
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[leg] = ccl.ccl_launches
        check(launches[leg] == len(chunks), f"config 2 {leg}: ccl launches {launches[leg]} != {len(chunks)}")
        check_outputs(outs, CONFIG2_FRAMES, f"config 2 {leg}")
        ate, vrate, n_invalid, _conf = ate_eval(cfg, traj.positions, traj.rotations, outs)
        loop_edges = int(outs[-1].loop_closures[-1])
        dt = float("inf")
        for _ in range(2):  # two timed passes, best of two, as bench.py does
            t0 = time.perf_counter()
            for c in chunks:
                slam.process(c)
            torch.cuda.synchronize()
            dt = min(dt, time.perf_counter() - t0)
        fps = CONFIG2_FRAMES / dt
        breakdown = time_breakdown([chunks[-1]], cfg, cam, params, slam, 1e3 * BATCH / fps)
        out[leg] = {"ate": ate, "valid_rate": vrate, "n_invalid": n_invalid, "loop_edges": loop_edges,
                    "fps": fps, "first_pass_s": first_s, "ccl_launches_per_pass": launches[leg],
                    "breakdown": breakdown}
        log(f"config 2 {leg}: ATE {ate:.4f} su, valid {vrate:.4f}, loop edges {loop_edges}, "
            f"{fps:.3f} fps, {breakdown['host_syncs']} host syncs and "
            f"{breakdown['kernel_launches']} kernel launches per chunk [{card}]")
        check(vrate >= 0.95, f"config 2 {leg}: valid rate {vrate} < 0.95")
    check(out["pgo_on"]["ate"] < 1.0, f"config 2 pgo on: ATE {out['pgo_on']['ate']} >= 1.0 su")
    check(out["pgo_on"]["loop_edges"] >= 1, "config 2 pgo on: no loop edge was minted")
    out["fps_on_over_off"] = out["pgo_on"]["fps"] / out["pgo_off"]["fps"]
    return out, launches


def options_phase(chunk, cfg, cam, params, dev, headline_ba) -> dict:
    """Every other estimator and schedule on one chunk of the main-path
    frames, and the sparse BA coupling against the dense one."""
    from aprilslam_tpu_torch.geometry import se3_exp
    from aprilslam_tpu_torch.slam import ba_optimize, build_slam_step

    res = {}
    runs = {
        "reference_chain": dict(HEADLINE, estimator="reference_chain"),
        "chain_avg": dict(HEADLINE, estimator="chain_avg"),
        "joint": dict(HEADLINE, estimator="joint"),
        "ba_frame": dict(HEADLINE, ba_schedule="frame"),
        "ba_chunk": dict(HEADLINE),
        "ba_chunk_zero_dist": dict(HEADLINE, dist_coeffs=[0.0, 0.0, 0.0, 0.0, 0.0]),
    }
    outs = {}
    for name, kw in runs.items():
        step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=params,
                                     device=dev, **kw)
        t0 = time.perf_counter()
        _state, outs[name] = step(init(), chunk)
        torch.cuda.synchronize()
        check_outputs([outs[name]], BATCH, name)
        res[name] = {"valid": int(outs[name].valid.sum()), "s": time.perf_counter() - t0}
    gap = float((outs["ba_chunk_zero_dist"].poses - outs["ba_chunk"].poses).abs().max())
    res["zero_dist_max_pose_gap"] = gap
    check(gap <= 1e-4, f"zero distortion moved the poses by {gap}")

    # From the main path's converged map LM rejects every step, which would
    # make the comparison vacuous: start from its landmarks moved by seeded
    # noise (0.002 rad, 0.02 units) with the initial damping.
    K = torch.as_tensor(cam.matrix, device=dev)
    gen = torch.Generator().manual_seed(0)
    xi = torch.randn((headline_ba.n_landmarks, 6), generator=gen) * torch.tensor([0.002] * 3 + [0.02] * 3)
    start = replace(headline_ba, lam=torch.full_like(headline_ba.lam, 1e-2), lm_pose=torch.where(
        headline_ba.lm_active[:, None, None], se3_exp(xi.to(dev)) @ headline_ba.lm_pose, headline_ba.lm_pose))
    dense = ba_optimize(start, K, cfg.tag_size_inner, iters=4, coupling="dense")
    sparse = ba_optimize(start, K, cfg.tag_size_inner, iters=4, coupling="sparse")
    res["ba_moved"] = float((dense.lm_pose - start.lm_pose)[start.lm_active].abs().max())
    check(res["ba_moved"] > 1e-3, "the BA comparison took no step")
    # The world gauge is held only by damping: compare relative to the anchor.
    a = headline_ba.anchor.clamp(min=0)
    rel = {n: torch.linalg.inv(s.lm_pose[a]) @ torch.cat([s.lm_pose[headline_ba.lm_active],
                                                          s.kf_pose[headline_ba.kf_active]])
           for n, s in (("dense", dense), ("sparse", sparse))}
    res["sparse_vs_dense_max_gap"] = float((rel["sparse"] - rel["dense"]).abs().max())
    res["sparse_vs_dense_max_gap_raw"] = float(torch.cat([
        (sparse.lm_pose - dense.lm_pose).abs().flatten(), (sparse.kf_pose - dense.kf_pose).abs().flatten()]).max())
    check(res["sparse_vs_dense_max_gap"] <= 1e-3,
          f"sparse coupling differs from dense by {res['sparse_vs_dense_max_gap']}")
    return res


def run_cli(argv: list, cwd: str) -> tuple[int, dict | None, float]:
    """The port's simulation CLI in this process, from ``cwd`` (it writes
    data/logs there). Returns (rc, summary JSON or None, wall seconds); its
    log lines are echoed once it returns."""
    from aprilslam_tpu_torch.apps.run_simulation import main as sim_main

    old, out = os.getcwd(), io.StringIO()
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            rc = sim_main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(old)
        for h in logging.root.handlers[:]:
            h.close()
            logging.root.removeHandler(h)
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for line in lines[-4:]:
        log(f"  cli| {line}")
    try:
        return rc, json.loads(lines[-1]), wall
    except (IndexError, json.JSONDecodeError):
        return rc, None, wall


def apps_phase(main_chunks, dev, card: str) -> tuple[dict, int, int]:
    """The apps on the card: the simulation CLI (fps against the step alone
    on the same frames), its --pgo and checkpoint/resume runs, the service
    against an in-process step, and the verifier. Returns the report and the
    CCL launches of the CLI's main run and of the service's requests."""
    from aprilslam_tpu_torch.apps import verify_install
    from aprilslam_tpu_torch.apps.serve import SlamClient, make_server
    from aprilslam_tpu_torch.detect import DetectorParams
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory
    from aprilslam_tpu_torch.slam import SlamSystem

    out = {}
    cfg = SceneConfig.from_file()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI at its defaults: 64 frames of the walk, batch 8, ba.
        frames_n = APPS_FRAMES
        ccl.ccl_launches = 0
        rc, summary, wall = run_cli(["--frames", str(frames_n), "--batch", str(BATCH), "--estimator", "ba",
                                     "--trajectory", "walk", "--headless", "--output-dir", "csv",
                                     "--device", dev.type], tmp)
        launches_cli = ccl.ccl_launches
        check(rc == 0 and summary is not None, f"apps: the CLI returned {rc}")
        check(summary["ate_rmse_su"] < 1.8, f"apps: CLI ATE {summary['ate_rmse_su']} >= 1.8 su")
        check(launches_cli == frames_n // BATCH, f"apps: CLI ccl launches {launches_cli} != {frames_n // BATCH}")
        rows = {}
        for name in ("slam_simulation_data.csv", "error_analysis.csv", "covariance_analysis.csv"):
            with open(os.path.join(tmp, "csv", name)) as f:
                rows[name] = len(list(csv.DictReader(f)))
            check(rows[name] > 0, f"apps: {name} has no data rows")
        # The same frames through SlamSystem.process alone, built as the CLI builds it.
        res = cfg.display_width
        cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
        traj = trajectory.smooth_random_walk(frames_n, seed=0)
        scene = scene_tensors(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = [render_frames(scene, traj.positions[i:i + BATCH], traj.rotations[i:i + BATCH],
                                cam.inv_matrix, res, res, 2, device=dev) for i in range(0, frames_n, BATCH)]
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        cap = max(16, -(-(max(cfg.tag_ids()) + 2) // 8) * 8)
        cli_params = DetectorParams(quad_decimate=2, min_cluster_pts=12)
        slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, estimator="ba",
                          detector_params=cli_params, graph_capacity=cap, device=dev)
        t0 = time.perf_counter()
        for f in frames:
            slam.process(f)
        torch.cuda.synchronize()
        process_s = time.perf_counter() - t0
        out["sim_cli"] = {
            "frames": frames_n, "summary": summary, "rc": rc, "csv_rows": rows,
            "ccl_launches": launches_cli, "cli_fps": summary["fps"], "cli_wall_s": wall,
            "process_fps": frames_n / process_s, "render_s": render_s,
        }
        # One more step's host syncs on the last chunk. No profiled step as in
        # phases 4 and 5: at this step's launch count the profiler takes minutes.
        syncs = host_syncs(slam, frames[-1])
        out["sim_cli"]["host_syncs"] = sum(syncs.values())
        out["sim_cli"]["top_sync_lines"] = syncs.most_common(8)
        log(f"apps cli: {json.dumps(summary)}; CLI {summary['fps']} fps incl. host loop "
            f"(wall {wall:.2f} s), process alone {frames_n / process_s:.3f} fps, render {render_s:.2f} s; "
            f"step {out['sim_cli']['host_syncs']} host syncs per chunk [{card}]")

        # The --pgo orbit run, and a checkpointed run then its --resume.
        runs = {
            "pgo_orbit": ["--pgo", "--trajectory", "orbit", "--frames", "32"],
            "checkpoint": ["--checkpoint-dir", "ckpt", "--checkpoint-every", "8", "--frames", "16"],
            "resume": ["--checkpoint-dir", "ckpt", "--checkpoint-every", "8", "--frames", "16", "--resume"],
        }
        for name, extra in runs.items():
            rc, summary, wall = run_cli(extra + ["--headless", "--output-dir", f"csv_{name}",
                                                 "--device", dev.type], tmp)
            check(rc == 0, f"apps: CLI {name} returned {rc}")
            out[name] = {"rc": rc, "summary": summary, "wall_s": wall}

    # (b) the service at its defaults, in a thread, on a free port.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cam = PinholeCamera.from_fov(RES, RES, 45.0)
    srv = make_server("127.0.0.1", port, cam, "tagStandard41h12", 10.0, BATCH, RES, 1, device=dev)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        cli = SlamClient(port=port)
        check(cli.ping() == {"ok": True, "shape": [BATCH, RES, RES]}, "apps: serve ping")
        u8 = [c.cpu().numpy() for c in main_chunks[:3]]
        ccl.ccl_launches = 0
        reps = [cli.process(c) for c in u8]
        stats = cli.stats()
        reset_ok = cli.reset()["ok"]
        again = cli.process(u8[0])
        launches_serve = ccl.ccl_launches
        bad = cli._call({"cmd": "process", "shape": [BATCH, RES, RES]}, b"\0" * 10)
        cli.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    check(all(r["ok"] for r in reps + [again]), "apps: a serve request failed")
    check(launches_serve == len(reps) + 1, f"apps: serve ccl launches {launches_serve} != {len(reps) + 1}")
    check(reset_ok and stats["requests"] == len(reps), f"apps: serve stats {stats}")
    check(not bad["ok"] and "payload" in bad["error"], f"apps: malformed request answered {bad}")
    ref = SlamSystem(cam, "tagStandard41h12", 10.0, estimator="ba", ba_schedule="chunk", device=dev)
    gap, step_ms = 0.0, []
    for rep, c in zip(reps, u8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = ref.process(c)
        poses, valid = o.poses.cpu().numpy(), o.valid.cpu().numpy()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(np.asarray(rep["valid"]), valid), "apps: serve validity != in-process step")
        gap = max(gap, float(np.abs(np.asarray(rep["poses"])[valid] - poses[valid]).max(initial=0.0)))
    reset_gap = float(np.abs(np.asarray(again["poses"]) - np.asarray(reps[0]["poses"])).max())
    check(gap <= 1e-3, f"apps: serve poses differ from the in-process step by {gap}")
    check(reset_gap <= 1e-3, f"apps: poses after reset differ by {reset_gap}")
    out["serve"] = {
        "batch": BATCH, "res": RES, "compile_s": stats["compile_s"], "requests": stats["requests"],
        "latency_ms": [r["latency_ms"] for r in reps], "in_process_step_ms": step_ms,
        "max_pose_gap": gap, "reset_max_pose_gap": reset_gap, "ccl_launches": launches_serve,
        "valid": [int(np.sum(r["valid"])) for r in reps], "malformed_error": bad["error"],
    }
    syncs = host_syncs(ref, u8[-1])
    out["serve"]["host_syncs"] = sum(syncs.values())
    out["serve"]["top_sync_lines"] = syncs.most_common(8)
    log(f"apps serve: latency {out['serve']['latency_ms']} ms against the in-process step "
        f"{[round(x, 1) for x in step_ms]} ms, pose gap {gap:.2e}, after reset {reset_gap:.2e}, "
        f"warm-up {stats['compile_s']} s; step {out['serve']['host_syncs']} host syncs per chunk [{card}]")

    # (c) the verifier on the card.
    rc = verify_install.main([])
    check(rc == 0, f"apps: verify_install returned {rc}")
    out["verify_install_rc"] = rc
    return out, launches_cli, launches_serve


def distorted_views(K: np.ndarray, k1: float, k2: float, obj: np.ndarray, w: int, h: int,
                    seed: int, n: int = 8) -> list:
    """``tests/test_calib.py``'s synthetic views: a board at random poses
    (drawn in its order from ``default_rng(seed)``) through ``K`` and radial
    distortion, kept when the board lies in front and inside the image."""
    from aprilslam_tpu_torch.geometry import se3_exp

    rng = np.random.default_rng(seed)
    views = []
    while len(views) < n:
        xi = np.r_[rng.normal(scale=0.25, size=3), rng.normal(scale=40, size=2), 0]
        T = se3_exp(torch.as_tensor(xi)).numpy()
        T[:3, 3] += [0, 0, rng.uniform(420, 700)]
        p = obj @ T[:3, :3].T + T[:3, 3]
        if p[:, 2].min() < 50:
            continue
        xy = p[:, :2] / p[:, 2:3]
        r2 = np.sum(xy**2, axis=-1, keepdims=True)
        xyd = xy * (1 + k1 * r2 + k2 * r2**2)
        uv = np.stack([K[0, 0] * xyd[:, 0] + K[0, 2], K[1, 1] * xyd[:, 1] + K[1, 2]], axis=-1)
        if uv.min() < 5 or uv[:, 0].max() > w - 5 or uv[:, 1].max() > h - 5:
            continue
        views.append(uv.astype(np.float32))
    return views


def config4_phase(dev, card: str, main_traj, runtime_build_s: float) -> tuple[dict, dict, torch.Tensor]:
    """BASELINE config 4, the real-camera path: the native runtime, Zhang
    calibration on the card, the 640x480 Y4M replay of ``bench.py:525-584``
    (native reader -> batched detect -> PnP), the video app in process on
    the calibration it wrote, and a generated 1024-code family. Returns the
    report, the CCL launches of each run, and the replay's first trinary map
    (8x240x320) for the kernel's timing."""
    from aprilslam_tpu_torch.apps import video_detection
    from aprilslam_tpu_torch.calib import board_points, calibrate_camera
    from aprilslam_tpu_torch.detect import DetectorParams, TagDetector
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
    from aprilslam_tpu_torch.families.generate import generate_family
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.pose import poses_from_detections
    from aprilslam_tpu_torch.runtime import Y4MReader, render_frames_native
    from aprilslam_tpu_torch.sim import (SceneConfig, camera_to_tag_transforms, render_frames,
                                         scene_tensors, trajectory)

    out = {"card": card, "runtime_build_s": runtime_build_s}
    cfg = SceneConfig.from_file()
    scene = scene_tensors(cfg, device=dev)

    # (a) the native CPU rasterizer against the card's, tests/test_runtime.py's bounds.
    cam256 = PinholeCamera.from_fov(256, 256, cfg.fov_y)
    pos = np.asarray([[0.0, 0.0, 10.0], [6.0, 2.0, -4.0]], np.float32)
    rot = np.asarray([[0.0, 0.0, 0.0], [3.0, -5.0, 2.0]], np.float32)
    t0 = time.perf_counter()
    native = render_frames_native(scene, pos, rot, cam256, 256, 256, supersample=1)
    native_s = time.perf_counter() - t0
    card_img = render_frames(scene, pos, rot, cam256.inv_matrix, 256, 256, 1, device=dev).cpu().numpy()
    diff = np.abs(native - card_img)
    out["rasterizer"] = {"share_off_by_half": float((diff > 0.5).mean()), "mean_abs_diff": float(diff.mean()),
                         "native_s": native_s}
    check(out["rasterizer"]["share_off_by_half"] < 0.002 and out["rasterizer"]["mean_abs_diff"] < 0.01,
          f"config 4: native rasterizer differs from the card's: {out['rasterizer']}")

    # (b) calibration on the card: tests/test_calib.py's distorted views, then
    # undistorted views through the config-4 camera, saved for the app.
    obj = board_points(10, 7, 25.0)
    K_true = np.array([[820.0, 0, 315.0], [0, 825.0, 245.0], [0, 0, 1]])
    views = distorted_views(K_true, -0.12, 0.035, obj, 640, 480, seed=11)
    t0 = time.perf_counter()
    res = calibrate_camera(obj, views, iters=40, device=dev)
    calib_s = time.perf_counter() - t0
    out["calib_distorted"] = {"K": res.camera_matrix.tolist(), "dist": res.dist_coeffs.tolist(),
                              "mean_reprojection_error": res.mean_reprojection_error,
                              "quality": res.quality, "s": calib_s}
    check(res.mean_reprojection_error < 0.1 and np.abs(res.camera_matrix - K_true).max() < 4.0
          and abs(res.dist_coeffs[0] + 0.12) < 0.02 and abs(res.dist_coeffs[1] - 0.035) < 0.03,
          f"config 4: calibration missed the truth: {out['calib_distorted']}")
    W4, H4 = 640, 480
    cam = PinholeCamera.from_fov(W4, H4, cfg.fov_y)
    t0 = time.perf_counter()
    res4 = calibrate_camera(obj, distorted_views(cam.matrix.astype(np.float64), 0.0, 0.0, obj, W4, H4, seed=4),
                            device=dev)
    out["calib_config4"] = {"K": res4.camera_matrix.tolist(), "dist": res4.dist_coeffs.tolist(),
                            "mean_reprojection_error": res4.mean_reprojection_error,
                            "quality": res4.quality, "s": time.perf_counter() - t0}
    check(np.abs(res4.camera_matrix - cam.matrix).max() < 1.0 and res4.mean_reprojection_error < 0.01,
          f"config 4: calibration of the config-4 camera missed: {out['calib_config4']}")
    log(f"config 4 calibration: distorted views {res.camera_matrix[[0, 1, 0, 1], [0, 1, 2, 2]].round(3).tolist()} "
        f"k {res.dist_coeffs[:2].round(5).tolist()} err {res.mean_reprojection_error:.4f} px "
        f"{res.quality} in {calib_s:.2f} s; config-4 camera err {res4.mean_reprojection_error:.5f} px "
        f"in {out['calib_config4']['s']:.2f} s [{card}]")

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "camera_calibration_parameters.npz")
        res4.save_npz(npz)
        # (c) the clip: bench.py:538-556, rendered on the card.
        n_frames = 64
        traj = trajectory.scripted_waypoints(n_frames, np.array([[0.0, 0.0, 20.0], [8.0, 2.0, 5.0],
                                                                 [0.0, -2.0, 15.0]]))
        frames = torch.clamp(render_frames(scene, traj.positions, traj.rotations, cam.inv_matrix, H4, W4, 2,
                                           device=dev) * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
        clip = os.path.join(tmp, "bench_clip.y4m")
        with open(clip, "wb") as f:
            f.write(f"YUV4MPEG2 W{W4} H{H4} F30:1 Cmono\n".encode())
            for fr in frames:
                f.write(b"FRAME\n" + fr.tobytes())

        # (d) the replay, as bench.py:563-581: a warm-up pass that also
        # keeps the poses for accuracy, then a timed pass.
        params = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16)
        detector = TagDetector(cfg.family, params, device=dev)
        K = torch.as_tensor(cam.matrix, device=dev)

        def replay(keep=None):
            n, dets = 0, 0
            with Y4MReader(clip) as r:
                while True:
                    b = r.read_batch(BATCH)
                    if b.shape[0] == 0:
                        break
                    det = detector.detect(torch.from_numpy(b).to(dev))
                    T, okp, _rms, _seed, _alt = poses_from_detections(det, K, cfg.tag_size_inner)
                    dets += int(okp.sum())
                    if keep is not None:
                        keep.append((n, det.ids.cpu().numpy(), T.cpu().numpy(), okp.cpu().numpy()))
                    n += int(b.shape[0])
            return n, dets

        kept = []
        ccl.ccl_launches = 0
        replay(kept)
        launches_warm = ccl.ccl_launches
        torch.cuda.synchronize()
        ccl.ccl_launches = 0
        t0 = time.perf_counter()
        n, dets = replay()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches_replay = ccl.ccl_launches
        gt = camera_to_tag_transforms(scene.tag_pos.cpu(), scene.tag_rot.cpu(), torch.as_tensor(traj.positions),
                                      torch.as_tensor(traj.rotations)).numpy()
        index = {int(t): k for k, t in enumerate(cfg.tag_ids())}
        err = np.array([np.linalg.norm(T[f, d, :3, 3] - gt[first + f, index[int(ids[f, d])], :3, 3])
                        for first, ids, T, ok in kept for f, d in zip(*np.nonzero(ok))])
        out["replay"] = {"resolution": f"{W4}x{H4}", "frames": n, "fps": n / dt, "vs_realtime_30fps": n / dt / 30.0,
                         "tag_poses": dets, "ccl_launches_per_pass": launches_replay,
                         "ccl_launches_warmup": launches_warm, "t_err_median": float(np.median(err)),
                         "t_err_p95": float(np.percentile(err, 95))}
        # Where a batch's time goes: the reader, the detector and PnP, each
        # alone over the clip's batches (host clock, synchronised).
        with Y4MReader(clip) as r:
            t0 = time.perf_counter()
            batches = [r.read_batch(BATCH) for _ in range(n // BATCH)]
            read_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        on_card = [torch.from_numpy(b).to(dev) for b in batches]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets_all = [detector.detect(b) for b in on_card]
        torch.cuda.synchronize()
        detect_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        t0 = time.perf_counter()
        for d in dets_all:
            poses_from_detections(d, K, cfg.tag_size_inner)
        torch.cuda.synchronize()
        out["replay"].update(read_ms=read_ms, detect_ms=detect_ms,
                             pnp_ms=(time.perf_counter() - t0) * 1e3 / len(batches), batch_ms=1e3 * dt / len(batches))
        log(f"config 4 replay: {n / dt:.2f} fps over {n} frames ({dets} tag poses), "
            f"t err median {out['replay']['t_err_median']:.4f} p95 {out['replay']['t_err_p95']:.4f} su, "
            f"{launches_replay} CCL launches; per batch {out['replay']['batch_ms']:.1f} ms: read "
            f"{read_ms:.2f}, detect {detect_ms:.1f}, PnP {out['replay']['pnp_ms']:.1f} [{card}]")
        check(dets >= 146, f"config 4: {dets} tag poses < 146 (0.9 x the reference's 162)")
        check(len(err) == dets, f"config 4: the accuracy pass found {len(err)} poses, the timed one {dets}")
        check(launches_replay == n // BATCH, f"config 4: CCL launches {launches_replay} != {n // BATCH}")
        check(out["replay"]["t_err_median"] <= 1.1 * CONFIG4_CPU_T_ERR_MEDIAN,
              f"config 4: median translation error {out['replay']['t_err_median']} > 1.1 x "
              f"{CONFIG4_CPU_T_ERR_MEDIAN}")
        dec = decimate(to_grayscale(torch.from_numpy(frames[:BATCH]).to(dev)), params.quad_decimate)
        first_map = adaptive_threshold_with_levels(dec, tile=params.tile,
                                                   min_contrast=params.min_contrast)[0].contiguous()

        # (e) the video app in this process, on the calibration it wrote.
        lines = []
        grab = logging.Handler(logging.INFO)
        grab.emit = lambda record: lines.append(record.getMessage())
        video_log = logging.getLogger("video")
        video_log.setLevel(logging.INFO)
        video_log.addHandler(grab)
        ccl.ccl_launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                rc = video_detection.main(["--source", clip, "--calibration", npz, "--family", cfg.family,
                                           "--tag-size", str(cfg.tag_size_inner), "--batch", str(BATCH),
                                           "--max-frames", str(n_frames), "--device", dev.type])
            torch.cuda.synchronize()
        finally:
            video_log.removeHandler(grab)
            for h in logging.root.handlers[:]:
                h.close()
                logging.root.removeHandler(h)
        app_wall = time.perf_counter() - t0
        launches_app = ccl.ccl_launches
        tag_lines = [m for m in lines if m.startswith("tag ")]
        fps_lines = [m for m in lines if m.startswith("[")]
        out["app"] = {"rc": rc, "tag_lines": len(tag_lines), "ccl_launches": launches_app, "wall_s": app_wall,
                      "wall_fps": n_frames / app_wall, "fps_lines": fps_lines, "last_line": lines[-1] if lines else None,
                      "dist_coeffs_shape": list(np.load(npz)["dist_coeffs"].shape)}
        log(f"config 4 app: rc {rc}, {len(tag_lines)} tag lines, {launches_app} CCL launches, "
            f"{fps_lines[-1] if fps_lines else 'no fps line'}, wall {n_frames / app_wall:.2f} fps [{card}]")
        check(rc == 0, f"config 4: the video app returned {rc}")
        check(launches_app == n_frames // BATCH, f"config 4: app CCL launches {launches_app} != {n_frames // BATCH}")
        check(len(tag_lines) > 0, "config 4: the video app reported no tag")

    # (f) a generated 1024-code family against the built-in one on 8 headline
    # poses of the default scene at 1000x1000.
    t0 = time.perf_counter()
    fam = generate_family(1024, seed=0)
    gen_s = time.perf_counter() - t0
    cam_h = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    hp = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
    ids = {}
    ccl.ccl_launches = 0
    for name, family in (("builtin", None), ("generated", fam)):
        sc = scene_tensors(cfg, family=family, device=dev)
        img = torch.clamp(render_frames(sc, main_traj.positions[:BATCH], main_traj.rotations[:BATCH],
                                        cam_h.inv_matrix, RES, RES, 2, device=dev) * 255.0, 0, 255).to(torch.uint8)
        det = TagDetector(family or cfg.family, hp, device=dev).detect(img)
        ids[name] = [sorted(int(i) for i in row[v]) for row, v in zip(det.ids.cpu().numpy(), det.valid.cpu().numpy())]
    launches_gen = ccl.ccl_launches
    out["generated_family"] = {"name": fam.name, "n_codes": fam.n_codes, "generate_s": gen_s,
                               "ids_builtin": ids["builtin"], "ids_generated": ids["generated"],
                               "ccl_launches": launches_gen}
    log(f"config 4 generated family {fam.name}: {gen_s:.2f} s; ids per frame {ids['generated']} "
        f"(built-in {ids['builtin']}) [{card}]")
    check(ids["generated"] == ids["builtin"], "config 4: the generated family's ids differ from the built-in's")
    check(sum(map(len, ids["builtin"])) > 0, "config 4: no tag detected on the headline poses")
    launches = {"replay_per_pass": launches_replay, "app": launches_app, "generated_family": launches_gen}
    return out, launches, first_map


def lm_world(n_lm: int, n_kf: int, n_obs: int, seed: int = 0):
    """The landmark-axis world of ``tools/scaling_bench.py:64-131`` on the
    port: a square grid of ``n_lm`` tags 25 units apart, ``n_kf`` keyframes
    looking down from 140 units at random spots, each observing its
    ``n_obs / n_kf`` nearest tags with 0.3 px corner noise, and keyframes
    and tags perturbed by se3_exp of 0.01-sigma noise. Returns (BAState on
    the CPU, Kmat, the largest observation count of one landmark)."""
    from aprilslam_tpu_torch.geometry import PinholeCamera, se3_exp, tag_object_corners
    from aprilslam_tpu_torch.slam import ba_init

    rng = np.random.default_rng(seed)
    M, K, O = n_lm, n_kf, n_obs
    Km = PinholeCamera.from_fov(1000, 1000, 45.0).matrix
    obj = tag_object_corners(10.0).numpy()
    side = int(np.ceil(np.sqrt(M)))
    lm_pose = np.broadcast_to(np.eye(4, dtype=np.float32), (M, 4, 4)).copy()
    lm_pose[:, 0, 3] = (np.arange(M) % side) * 25.0
    lm_pose[:, 1, 3] = (np.arange(M) // side) * 25.0
    kf_pose = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    for k in range(K):
        kf_pose[k][:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
        kf_pose[k][:3, 3] = [rng.uniform(0, side * 25), rng.uniform(0, side * 25), 140.0]
    obs_kf, obs_lm = np.zeros(O, np.int32), np.zeros(O, np.int32)
    obs_uv = np.zeros((O, 4, 2), np.float32)
    i = 0
    for k in range(K):
        d = np.linalg.norm(lm_pose[:, :3, 3] - kf_pose[k][:3, 3], axis=-1)
        for m in np.argsort(d)[:O // K]:
            T_ct = np.linalg.inv(kf_pose[k]) @ lm_pose[m]
            p = obj @ T_ct[:3, :3].T + T_ct[:3, 3]
            uv = p[:, :2] / p[:, 2:3]
            obs_uv[i] = np.stack([Km[0, 0] * uv[:, 0] + Km[0, 2], Km[1, 1] * uv[:, 1] + Km[1, 2]], -1) \
                + rng.normal(scale=0.3, size=(4, 2))
            obs_kf[i], obs_lm[i] = k, m
            i += 1

    def noisy(T):
        xi = torch.as_tensor(np.stack([rng.normal(scale=0.01, size=6) for _ in range(len(T))]), dtype=torch.float32)
        return (se3_exp(xi).numpy() @ T).astype(np.float32)

    kf_noisy, lm_noisy = noisy(kf_pose), noisy(lm_pose)
    t = torch.as_tensor
    st = replace(ba_init(K, M, O, device="cpu"),
                 kf_pose=t(kf_noisy), kf_active=torch.ones(K, dtype=torch.bool),
                 lm_pose=t(lm_noisy), lm_active=torch.ones(M, dtype=torch.bool),
                 obs_kf=t(obs_kf), obs_lm=t(obs_lm), obs_uv=t(obs_uv), obs_ok=t(np.arange(O) < i),
                 anchor=torch.tensor(0, dtype=torch.int32), kf_ptr=torch.tensor(K, dtype=torch.int32))
    return st, t(Km), int(np.bincount(obs_lm[:i], minlength=M).max())


def sync_lines(fn) -> tuple:
    """(fn's result, its host syncs counted by the line of the port that
    made them), from torch's sync debug mode."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return res, Counter(f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}"
                        for w in caught if "synchroniz" in str(w.message))


def timed(fn):
    """(fn's result, its wall seconds, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(params, dev, card: str) -> tuple[dict, dict]:
    """The parallel package (ROADMAP item 17): BASELINE config 3 through
    ``build_parallel_slam`` (``bench.py:465-522``), config 5 on the
    keyframe axis and the landmark axis (``tools/scaling_bench.py`` kf and
    lm modes) at 1 and 8 shards on the one card, the landmark solve on a
    single-rank NCCL group, ``aprilslam-torch-refine --demo`` in process,
    and a CLI run's ``--export-problem`` refined on the card. Returns the
    report and the CCL launches of config 3."""
    import torch.distributed as dist

    from aprilslam_tpu_torch.apps import refine_trajectory
    from aprilslam_tpu_torch.eval import ate_eval
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.parallel import (
        build_distributed_ba, build_keyframe_ba, build_parallel_slam, initialize_distributed,
        keyframe_ba_cost, make_mesh, partition_obs_by_keyframe, shard_observations_by_owner,
        synthesize_trajectory_problem)
    from aprilslam_tpu_torch.parallel.multihost import make_global
    from aprilslam_tpu_torch.parallel.distributed_ba import LM_SHARDED
    from aprilslam_tpu_torch.sim import SceneConfig, trajectory
    from aprilslam_tpu_torch.slam import SlamOutputs, ba_cost

    out = {"card": card}
    launches = {}

    # (a) config 3: 8 sequences x 2 chunks of 8 frames at 1000x1000.
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    trajs = [[trajectory.monte_carlo(BATCH, seed=100 + 10 * s + k) for k in range(CONFIG3_CHUNKS)]
             for s in range(CONFIG3_SEQ)]
    t0 = time.perf_counter()
    per_seq = [render_chunks(cfg, cam, trajectory.Trajectory(
        np.concatenate([t.positions for t in tr]), np.concatenate([t.rotations for t in tr])),
        BATCH * CONFIG3_CHUNKS, dev) for tr in trajs]
    chunks3 = [torch.stack([per_seq[s][k] for s in range(CONFIG3_SEQ)]) for k in range(CONFIG3_CHUNKS)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    mesh = make_mesh(CONFIG3_SEQ, axis="data", device=dev)
    pstep, init_states, _shard = build_parallel_slam(mesh, cfg.family, cam, cfg.tag_size_inner,
                                                     detector_params=params, **CONFIG3)
    states = init_states()
    ccl.ccl_launches = 0
    warm = []
    for c in chunks3:  # the warm pass, kept for accuracy
        states, o = pstep(states, c)
        warm.append(o)
    torch.cuda.synchronize()
    launches["warm_pass"] = ccl.ccl_launches
    ccl.ccl_launches = 0
    t0 = time.perf_counter()
    timed_outs = []
    for c in chunks3:
        states, o = pstep(states, c)
        timed_outs.append(o)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["per_pass"] = ccl.ccl_launches
    frames_timed = CONFIG3_SEQ * CONFIG3_CHUNKS * BATCH
    valid = torch.cat([o.valid.reshape(-1) for o in timed_outs])
    for o in timed_outs + warm:
        for name, v in vars(o).items():
            check(v.device.type == "cuda", f"config 3: output {name} is on {v.device}")
    seq_outs = lambda outs, s: [SlamOutputs(**{k: v[s] for k, v in vars(o).items()}) for o in outs]  # noqa: E731
    ates = [ate_eval(cfg, np.concatenate([t.positions for t in trajs[s]]),
                     np.concatenate([t.rotations for t in trajs[s]]), seq_outs(warm, s))[0]
            for s in range(CONFIG3_SEQ)]
    c3 = {"sequences": CONFIG3_SEQ, "batch_per_seq": BATCH, "chunks": CONFIG3_CHUNKS, "resolution": RES,
          "timed_passes": 1, "aggregate_fps": frames_timed / dt, "frames_timed": frames_timed,
          "valid_rate": float(valid.float().mean()), "valid_rate_last_step": float(timed_outs[-1].valid.float().mean()),
          "ccl_launches_per_pass": launches["per_pass"], "ccl_launches_warm_pass": launches["warm_pass"],
          "ate_per_sequence_warm_pass": ates, "render_s": render_s}
    check(bool(torch.isfinite(torch.cat([o.poses[o.valid] for o in timed_outs])).all()),
          "config 3: a valid pose is not finite")
    check(c3["valid_rate"] >= 0.95, f"config 3: valid rate {c3['valid_rate']} < 0.95")
    check(launches["per_pass"] == CONFIG3_SEQ * CONFIG3_CHUNKS,
          f"config 3: CCL launches {launches['per_pass']} != {CONFIG3_SEQ * CONFIG3_CHUNKS}")
    # One chunk with both pose graphs on (the production composition).
    pstep_pgo, init_pgo, _ = build_parallel_slam(mesh, cfg.family, cam, cfg.tag_size_inner,
                                                 detector_params=params, pgo=True, **CONFIG3)
    ccl.ccl_launches = 0
    (st_pgo, o_pgo), pgo_s = timed(lambda: pstep_pgo(init_pgo(), chunks3[0]))
    launches["pgo_chunk"] = ccl.ccl_launches
    c3["pgo_chunk"] = {"valid_rate": float(o_pgo.valid.float().mean()), "s": pgo_s,
                       "finite": bool(torch.isfinite(o_pgo.poses[o_pgo.valid]).all()),
                       "pgo_frames": [int(s[2].frame) for s in st_pgo], "ccl_launches": launches["pgo_chunk"]}
    check(c3["pgo_chunk"]["finite"] and c3["pgo_chunk"]["valid_rate"] >= 0.95,
          f"config 3 pgo: {c3['pgo_chunk']}")
    check(c3["pgo_chunk"]["pgo_frames"] == [BATCH] * CONFIG3_SEQ, f"config 3 pgo: {c3['pgo_chunk']}")
    out["config3"] = c3
    log(f"config 3: {c3['aggregate_fps']:.3f} aggregate fps over {frames_timed} frames, valid "
        f"{c3['valid_rate']:.4f}, {launches['per_pass']} CCL launches per pass, ATE per sequence "
        f"{[round(a, 4) for a in ates]}; pgo chunk valid {c3['pgo_chunk']['valid_rate']:.4f} in {pgo_s:.2f} s [{card}]")

    # (b) config 5, keyframe axis: scaling_bench --mode kf.
    t0 = time.perf_counter()
    prob8, kf_gt, Kk = synthesize_trajectory_problem(CONFIG5_KF["keyframes"], CONFIG5_KF["landmarks"], 8,
                                                     obs_per_kf=4, seed=7, device=dev)
    synth_s = time.perf_counter() - t0
    p_kf, p_lm, p_uv, p_ok = partition_obs_by_keyframe(prob8.obs_kf.cpu().numpy(), prob8.obs_lm.cpu().numpy(),
                                                       prob8.obs_uv.cpu().numpy(), prob8.obs_ok.cpu().numpy(),
                                                       prob8.n_keyframes, 1)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    probs = {1: replace(prob8, obs_kf=t(p_kf), obs_lm=t(p_lm), obs_uv=t(p_uv), obs_ok=t(p_ok)), 8: prob8}
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p.kf_pose[:, :3, 3].cpu().numpy() - kf_gt[:, :3, 3]) ** 2, -1))))  # noqa: E731
    kf = {"keyframes": prob8.n_keyframes, "landmarks": prob8.n_landmarks, "obs_per_kf": 4,
          "iters": CONFIG5_KF["iters"], "cg_iters": CONFIG5_KF["cg_iters"], "synth_s": synth_s,
          "cost_initial": float(keyframe_ba_cost(prob8, Kk, 10.0)), "ate_initial": ate(prob8)}
    for n, prob in probs.items():
        run = build_keyframe_ba(make_mesh(n, axis="kf", device=dev), prob.n_keyframes, prob.n_landmarks,
                                int(prob.obs_kf.shape[0]), 10.0, iters=CONFIG5_KF["iters"],
                                cg_iters=CONFIG5_KF["cg_iters"])
        run(prob, Kk)  # warm-up: the card's libraries and allocator
        torch.cuda.reset_peak_memory_stats()
        ((p, _c), syncs), solve_s = timed(lambda: sync_lines(lambda: run(prob, Kk)))
        kf[f"shards_{n}"] = {"solve_s": solve_s, "cost_refined": float(keyframe_ba_cost(p, Kk, 10.0)),
                             "ate_refined": ate(p), "host_syncs": sum(syncs.values()),
                             "sync_lines": syncs.most_common(4),
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "finite": bool(torch.isfinite(p.kf_pose).all())}
        check(kf[f"shards_{n}"]["finite"], f"config 5 kf: non-finite poses at {n} shards")
        check(kf[f"shards_{n}"]["ate_refined"] < kf["ate_initial"],
              f"config 5 kf: ATE {kf[f'shards_{n}']['ate_refined']} not below {kf['ate_initial']} at {n} shards")
    c1, c8 = kf["shards_1"]["cost_refined"], kf["shards_8"]["cost_refined"]
    check(abs(c8 - c1) <= 0.05 * c1, f"config 5 kf: 8-shard cost {c8} not within 5 % of 1-shard {c1}")
    out["config5_kf"] = kf
    log(f"config 5 kf axis: {json.dumps(kf)} [{card}]")

    # (c) config 5, landmark axis: scaling_bench --mode lm.
    t0 = time.perf_counter()
    st, Kl, P_max = lm_world(CONFIG5_LM["landmarks"], CONFIG5_LM["keyframes"], CONFIG5_LM["obs"])
    lm = {"landmarks": CONFIG5_LM["landmarks"], "keyframes": CONFIG5_LM["keyframes"],
          "observations": int(st.obs_ok.sum()), "max_obs_per_landmark": P_max, "iters": CONFIG5_LM["iters"],
          "synth_s": time.perf_counter() - t0}
    st = replace(st, **{f.name: getattr(st, f.name).to(dev) for f in fields(st)})
    Kl = Kl.to(dev)
    lm["cost_initial"] = float(ba_cost(st, Kl, 10.0))
    sharded = {1: st, 8: shard_observations_by_owner(st, 8, fit=True)}
    for n, s_n in sharded.items():
        run = build_distributed_ba(make_mesh(n, axis="lm", device=dev), s_n.n_keyframes, s_n.n_landmarks,
                                   s_n.n_obs_capacity, 10.0, iters=CONFIG5_LM["iters"], max_obs_per_lm=P_max)
        run(s_n, Kl)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        ((o, _c), syncs), solve_s = timed(lambda: sync_lines(lambda: run(s_n, Kl)))
        lm[f"shards_{n}"] = {"solve_s": solve_s, "s_per_iter": solve_s / CONFIG5_LM["iters"],
                             "cost_refined": float(ba_cost(o, Kl, 10.0)), "host_syncs": sum(syncs.values()),
                             "sync_lines": syncs.most_common(4),
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(lm[f"shards_{n}"]["cost_refined"] < lm["cost_initial"],
              f"config 5 lm: cost not reduced at {n} shards: {lm[f'shards_{n}']}")
    c1, c8 = lm["shards_1"]["cost_refined"], lm["shards_8"]["cost_refined"]
    check(abs(c8 - c1) <= 0.05 * c1, f"config 5 lm: 8-shard cost {c8} not within 5 % of 1-shard {c1}")
    # The same one-shard solve on a single-rank NCCL process group.
    initialize_distributed(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, platform="gpu")
    try:
        check(dist.get_backend() == "nccl", f"process group backend {dist.get_backend()}")
        mesh_pg = make_mesh(axis="lm", device=dev, group=dist.group.WORLD)
        s_pg = replace(st, **{f: make_global(mesh_pg, "lm", getattr(st, f)) for f in LM_SHARDED})
        run = build_distributed_ba(mesh_pg, st.n_keyframes, st.n_landmarks, st.n_obs_capacity, 10.0,
                                   iters=CONFIG5_LM["iters"], max_obs_per_lm=P_max)
        (o_pg, _c), pg_s = timed(lambda: run(s_pg, Kl))
    finally:
        dist.destroy_process_group()
    lm["nccl_1rank"] = {"backend": "nccl", "world_size": 1, "solve_s": pg_s,
                        "cost_refined": float(ba_cost(o_pg, Kl, 10.0))}
    gap = abs(lm["nccl_1rank"]["cost_refined"] - c1) / c1
    lm["nccl_1rank"]["rel_gap_to_stacked"] = gap
    check(gap <= 1e-5, f"config 5 lm: NCCL cost {lm['nccl_1rank']['cost_refined']} != stacked {c1}")
    out["config5_lm"] = lm
    log(f"config 5 lm axis: {json.dumps(lm)} [{card}]")

    # (d) aprilslam-torch-refine --demo at its defaults, then a CLI run's export.
    refine = {}
    for n in (1, 8):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = refine_trajectory.main(["--demo", "--devices", str(n)])
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        refine[f"devices_{n}"] = rep
        check(rc == 0 and rep["finite"] and rep["devices"] == n, f"refine demo: {rep}")
        check(rep["ate_refined"] <= 0.45 * rep["ate_initial"], f"refine demo: ATE not reduced enough: {rep}")
        want = REFINE_JAX_CPU_COST[n]
        check(abs(rep["cost_refined"] - want) <= 0.10 * want,
              f"refine demo: cost {rep['cost_refined']} not within 10 % of JAX's {want} at {n} shards")
    with tempfile.TemporaryDirectory() as tmp:
        rc, summary, wall = run_cli(["--frames", "16", "--batch", str(BATCH), "--headless", "--output-dir", "csv",
                                     "--export-problem", "run.npz", "--device", dev.type], tmp)
        check(rc == 0 and summary is not None and summary.get("exported_keyframes", 0) > 0,
              f"export: the CLI returned {rc}: {summary}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = refine_trajectory.main(["--input", os.path.join(tmp, "run.npz"), "--output",
                                         os.path.join(tmp, "refined.npz")])
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and rep["finite"] and rep["cost_refined"] <= rep["cost_initial"], f"refine --input: {rep}")
    refine["export"] = {"cli": summary, "cli_wall_s": wall, "refine": rep}
    out["refine"] = refine
    log(f"refine: {json.dumps(refine)} [{card}]")
    return out, launches


def host_syncs(slam, chunk) -> Counter:
    """Host syncs of one step, counted by the line of the port that made them."""
    return sync_lines(lambda: slam.process(chunk))[1]


def time_breakdown(chunks, cfg, cam, params, slam, step_ms: float) -> dict:
    """Where a chunk's time goes: the detector and PnP alone (host clock,
    synchronised, mean over the chunks), one profiled step's kernel time,
    kernel launches and busiest kernels (busy share = kernel time / step
    time), and one more step's host syncs by the source line that made them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aprilslam_tpu_torch.detect import TagDetector
    from aprilslam_tpu_torch.pose import poses_from_detections

    detector = TagDetector(cfg.family, params, device="cuda")
    K = torch.as_tensor(cam.matrix, device="cuda")

    def mean_ms(fn, inputs):
        fn(inputs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(inputs)

    detect_ms = mean_ms(detector.detect, chunks)
    dets = [detector.detect(c) for c in chunks]
    pnp_ms = mean_ms(lambda d: poses_from_detections(d, K, cfg.tag_size_inner, iters=3), dets)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam.process(chunks[0])
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kernels = sorted((e for e in rows if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    syncs = host_syncs(slam, chunks[0])
    return {
        "step_ms": step_ms,
        "detect_ms": detect_ms,
        "pnp_ms": pnp_ms,
        "slam_backend_ms": step_ms - detect_ms - pnp_ms,
        "kernel_ms": kernel_ms if kernels else "not measured",
        "busy_share": kernel_ms / step_ms if kernels else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in kernels[:8]],
        "host_syncs": sum(syncs.values()),
        "top_sync_lines": syncs.most_common(8),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64, help="main-path frames (multiple of 8)")
    ap.add_argument("--reference-pool", action="store_true",
                    help="run the JAX package's own 512 headline poses instead of "
                         "monte_carlo(--frames, seed=3)")
    args = ap.parse_args()
    if args.reference_pool:
        args.frames = 512
    check(args.frames % BATCH == 0 and args.frames > 0, "--frames must be a positive multiple of 8")

    # ---- 1. card ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    from aprilslam_tpu_torch.detect import DetectorParams
    from aprilslam_tpu_torch.detect.threshold import (
        adaptive_threshold_with_levels, decimate, to_grayscale)
    from aprilslam_tpu_torch.eval import ate_eval
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory
    from aprilslam_tpu_torch.slam import SlamSystem

    dev = torch.device("cuda")

    # ---- 2. build: the kernel (nvcc) and the native runtime (g++) together --
    from concurrent.futures import ThreadPoolExecutor

    from aprilslam_tpu_torch.runtime import build_runtime

    with ThreadPoolExecutor(2) as pool:
        ccl_build, runtime_build = pool.submit(ccl.build_ccl, True), pool.submit(build_runtime)
        (lib_path, build_s), (rt_path, rt_build_s) = ccl_build.result(), runtime_build.result()
    log(f"build: {lib_path.name} in {build_s:.2f} s; {rt_path.name} in {rt_build_s:.2f} s")

    # ---- main-path frames (also phase 3's rendered inputs) ----------------
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    traj = trajectory.reference_pool() if args.reference_pool else trajectory.monte_carlo(args.frames, seed=3)
    t0 = time.perf_counter()
    chunks = render_chunks(cfg, cam, traj, args.frames, dev)
    torch.cuda.synchronize()
    log(f"render: {args.frames} frames {RES}x{RES} in {time.perf_counter() - t0:.2f} s")
    params = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)

    def trinary_of(frames):
        dec = decimate(to_grayscale(frames), params.quad_decimate)
        return adaptive_threshold_with_levels(dec, tile=params.tile, min_contrast=params.min_contrast)[0]

    # ---- 3. kernel vs plain vs oracle -------------------------------------
    rng = np.random.default_rng(0)
    cases = {f"block_random_2x40x52_s{s}": block_random(np.random.default_rng(s), 2, 40, 52) for s in range(3)}
    cases["block_random_8x500x500"] = block_random(rng, 8, 500, 500)
    cases["all_unknown_2x64x96"] = np.full((2, 64, 96), -1, np.int8)
    cases["all_white_2x64x96"] = np.ones((2, 64, 96), np.int8)
    cases["all_black_1x500x500"] = np.zeros((1, 500, 500), np.int8)
    cases["pixel_random_3x37x501"] = rng.integers(-1, 2, size=(3, 37, 501)).astype(np.int8)
    cases["serpentine_1x37x501"] = serpentine(37, 501)
    cases["serpentine_1x500x500"] = serpentine(500, 500)
    cases["all_white_8x500x500"] = np.ones((8, 500, 500), np.int8)
    cases.update(stress_cases(rng))
    for k in (0, len(chunks) - 1):
        cases[f"rendered_chunk{k}_8x500x500"] = trinary_of(chunks[k]).cpu().numpy()
    max_err = 0
    for name, t_np in cases.items():
        t = torch.as_tensor(t_np, device=dev).contiguous()
        got = ccl.connected_components(t)
        torch.cuda.synchronize()
        plain = ccl.connected_components_plain(t)
        oracle = scipy_labels(t_np)
        err = int((got.long() - plain.long()).abs().max().item())
        max_err = max(max_err, err)
        check(err == 0, f"kernel != plain on {name}")
        check(np.array_equal(got.cpu().numpy(), oracle), f"kernel != scipy oracle on {name}")
        log(f"ccl {name}: kernel == plain == oracle ({len(np.unique(oracle))} labels)")

    main_trin = trinary_of(chunks[0]).contiguous()
    timed = {"rendered_chunk0_8x500x500": main_trin}
    for name in ("block_random_8x500x500", "serpentine_1x500x500", "all_white_8x500x500"):
        timed[name] = torch.as_tensor(cases[name], device=dev).contiguous()
    # The byte bound: one int8 read and one int32 write per pixel.
    # "ms": back-to-back eager calls, as the main path makes them;
    # "device_ms": the card's time alone, from a replayed CUDA graph.
    ccl_timing = {"card": card, "ms": {}, "device_ms": {}, "bound_ms": {}}
    for name, t in timed.items():
        ccl_timing["ms"][name] = time_cuda(lambda: ccl.connected_components(t), 200)
        ccl_timing["device_ms"][name] = time_cuda_graph(lambda: ccl.connected_components(t))
        ccl_timing["bound_ms"][name] = t.numel() * (1 + 4) / HBM_BYTES_PER_S * 1e3
    kernel_ms = ccl_timing["ms"]["rendered_chunk0_8x500x500"]
    device_ms = ccl_timing["device_ms"]["rendered_chunk0_8x500x500"]
    bound_ms = ccl_timing["bound_ms"]["rendered_chunk0_8x500x500"]
    plain_ms = time_cuda(lambda: ccl.connected_components_plain(main_trin), 5)
    ccl_timing["launch_ms_rendered_chunk0"] = launch_split(lambda: ccl.connected_components(main_trin))
    Bm, Hm, Wm = main_trin.shape
    log(f"ccl timing {Bm}x{Hm}x{Wm}: kernel {kernel_ms:.4f} ms ({device_ms:.4f} ms on the card), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes) [{card}]")

    # ---- 4. main path -----------------------------------------------------
    slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, detector_params=params,
                      device=dev, **HEADLINE)
    ccl.ccl_launches = 0
    t0 = time.perf_counter()
    outs = [slam.process(c) for c in chunks]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ccl.ccl_launches
    check(launches == len(chunks), f"ccl launches {launches} != chunks {len(chunks)}")
    check_outputs(outs, args.frames, "main path")
    ate, vrate, n_invalid, conf = ate_eval(cfg, traj.positions, traj.rotations, outs)
    log(f"main path: {args.frames} frames, ATE {ate:.4f} su, valid {vrate:.4f} "
        f"({n_invalid} invalid), confident {conf}, first pass {first_s:.2f} s")
    check(ate < 1.0, f"ATE {ate} >= 1.0 su")
    check(vrate >= 0.9, f"valid rate {vrate} < 0.9")

    t0 = time.perf_counter()
    for c in chunks:
        slam.process(c)
    torch.cuda.synchronize()
    fps = args.frames / (time.perf_counter() - t0)
    log(f"steady state: {fps:.3f} fps (batch {BATCH}, {RES}x{RES}) [{card}]")
    breakdown = time_breakdown(chunks, cfg, cam, params, slam, 1e3 * BATCH / fps)
    log(f"breakdown per chunk of {BATCH}: {json.dumps(breakdown)} [{card}]")
    headline_ba = slam.ba_state

    # ---- 5. config 2 ------------------------------------------------------
    config2, config2_launches = config2_phase(params, dev, card)

    # ---- 6. the other estimators and schedules, the sparse coupling -------
    options = options_phase(chunks[0], cfg, cam, params, dev, headline_ba)
    log(f"options: {json.dumps(options)} [{card}]")

    # ---- 7. the apps -------------------------------------------------------
    t0 = time.perf_counter()
    apps, launches_cli, launches_serve = apps_phase(chunks, dev, card)
    apps["phase_s"] = time.perf_counter() - t0
    log(f"apps phase: {apps['phase_s']:.1f} s")

    # ---- 8. config 4 -------------------------------------------------------
    t0 = time.perf_counter()
    config4, config4_launches, config4_map = config4_phase(dev, card, traj, rt_build_s)
    config4["phase_s"] = time.perf_counter() - t0
    log(f"config 4 phase: {config4['phase_s']:.1f} s")
    name4 = "config4_8x240x320"
    ccl_timing["ms"][name4] = time_cuda(lambda: ccl.connected_components(config4_map), 200)
    ccl_timing["device_ms"][name4] = time_cuda_graph(lambda: ccl.connected_components(config4_map))
    ccl_timing["bound_ms"][name4] = config4_map.numel() * (1 + 4) / HBM_BYTES_PER_S * 1e3
    check(np.array_equal(ccl.connected_components(config4_map).cpu().numpy(),
                         scipy_labels(config4_map.cpu().numpy())), "kernel != scipy oracle on the config-4 map")
    log(f"ccl timing {name4}: kernel {ccl_timing['ms'][name4]:.4f} ms "
        f"({ccl_timing['device_ms'][name4]:.4f} ms on the card), bound {ccl_timing['bound_ms'][name4]:.5f} ms "
        f"(bytes) [{card}]")

    # ---- 9. the parallel package ------------------------------------------
    t0 = time.perf_counter()
    parallel, config3_launches = parallel_phase(params, dev, card)
    parallel["phase_s"] = time.perf_counter() - t0
    log(f"parallel phase: {parallel['phase_s']:.1f} s")

    # ---- 10. report -------------------------------------------------------
    kernels = [{
        "name": "ccl",
        "route": "cuda",
        "source": "aprilslam_tpu_torch/csrc/ccl.cu",
        "replaces": "aprilslam_tpu/ops/ccl_pallas.py:60",
        "launches": launches,
        "launches_config2_per_pass": config2_launches,
        "launches_sim_cli": launches_cli,
        "launches_serve": launches_serve,
        "launches_config4": config4_launches,
        "launches_config3": config3_launches,
        "max_abs_err": max_err,
        "match": max_err == 0,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]
    log(json.dumps({"main_path": {
        "frames": args.frames, "pool": "reference" if args.reference_pool else "monte_carlo_numpy",
        "ate": ate, "valid_rate": vrate, "n_invalid": n_invalid,
        "confidence": conf, "fps": fps, "breakdown": breakdown, "card": card}}))
    log(json.dumps({"config2": config2}))
    log(json.dumps({"options": options, "card": card}))
    log(json.dumps({"apps": apps, "card": card}))
    log(json.dumps({"config4": config4}))
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"ccl_timing": ccl_timing}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
