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
5. the CCL timing line, one JSON line per kernel, the card line, and a
   final JSON status line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HEADLINE = dict(
    estimator="ba", ba_schedule="chunk", graph_capacity=16, ba_keyframes=16,
    ba_obs=512, init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3,
)
BATCH = 8
RES = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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
    # Host syncs of one step, counted by the line of the port that made them.
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        slam.process(chunks[0])
    torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message))
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

    # ---- 2. build ---------------------------------------------------------
    lib_path, build_s = ccl.build_ccl(verbose=True)
    log(f"build: {lib_path.name} in {build_s:.2f} s")

    # ---- main-path frames (also phase 3's rendered inputs) ----------------
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    traj = trajectory.reference_pool() if args.reference_pool else trajectory.monte_carlo(args.frames, seed=3)
    t0 = time.perf_counter()
    chunks = [
        torch.clamp(render_frames(scene, traj.positions[i:i + BATCH], traj.rotations[i:i + BATCH],
                                  cam.inv_matrix, RES, RES, 2, device=dev) * 255.0, 0, 255
                    ).to(torch.uint8)
        for i in range(0, args.frames, BATCH)
    ]
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
    for o in outs:
        for name, v in vars(o).items():
            check(v.device.type == "cuda", f"output {name} is on {v.device}")
    poses = torch.cat([o.poses for o in outs])
    valid = torch.cat([o.valid for o in outs])
    check(poses.shape == (args.frames, 4, 4), f"poses shape {tuple(poses.shape)}")
    check(bool(torch.isfinite(poses[valid]).all()), "non-finite pose on a valid frame")
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

    # ---- 5. report --------------------------------------------------------
    kernels = [{
        "name": "ccl",
        "route": "cuda",
        "source": "aprilslam_tpu_torch/csrc/ccl.cu",
        "replaces": "aprilslam_tpu/ops/ccl_pallas.py:60",
        "launches": launches,
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
    log(json.dumps({"ccl_timing": ccl_timing}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
