"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--frames 64]

Phases (any failed check exits non-zero):
1. card: name and power limit; fails without a CUDA device;
2. build the CCL kernel (csrc/ccl.cu) and the chain-graph kernel
   (csrc/chain_graph.cu) with nvcc for sm_90a;
3. the kernel against its plain PyTorch version and a scipy oracle, bit for
   bit, on block-random, uniform, odd-sized, serpentine and rendered
   main-path inputs and on stress inputs that cross tile borders
   (checkerboard, stripes, staircase, 1x1, 1x501, 501x1, a batch of 32);
   the kernel timed with CUDA events on four inputs (back-to-back eager
   calls, as the main path makes them, and device time from a replayed CUDA
   graph), the plain version on the main-path one, and each of the kernel's
   launches with torch.profiler; then the chain-graph kernel against its
   plain version (on the card and on the CPU: integers equal, floats within
   1e-5 of each tensor's largest magnitude) on random chunks at the closure
   cell's shape (B 8, D 16, M 16) and at the step's defaults (D 32, M 64),
   each of two chunks in a row, the rotation projected and not, and timed
   at both shapes beside an empty launch and the plain version;
4. the main path: the bench's headline poses (``bench_torch.headline_poses``)
   of the default 5-tag scene rendered at 1000x1000 on the card as uint8,
   the headline detector and SLAM step in chunks of 8 through
   ``SlamSystem``; ATE against the analytic ground truth, the valid rate,
   both kernels' launch counts (one each per chunk) and that every output
   lives on the card;
5. BASELINE config 2 through ``bench_torch``'s pgo leg (``pgo_frames``,
   ``pgo_run``): the randomized scene, the two-lap loop of 96 frames at
   1000x1000, the loop-closure back end off and then on; per side an
   accuracy pass, two timed passes (best of two), ATE, valid rate, loop
   edges, the kernel's launches, and one step's host syncs, kernel launches
   and busy share; then the pgo-on step (the closure cell's) on the same
   chunks with every chunk's chain-graph input recorded: one launch per
   chunk, and each recorded chunk through the kernel and the plain version;
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
   batched detection and PnP (``bench_torch.video_clip`` and
   ``video_replay``: a warm-up pass kept for accuracy, a timed pass); the
   video app in process on that clip and calibration; and a
   generated 1024-code family against the built-in one on 8 headline poses;
9. the parallel package: BASELINE config 3 (``bench_torch``'s multiseq
   leg, ``bench.py:465-522``: 8 sequences x 2 chunks of 8 frames at
   1000x1000 through ``build_parallel_slam``, which runs the detector and
   PnP once per chunk over all 64 frames, then each sequence's back end: a
   warm chunk and one timed pass (the bench's 4 cut for time), one CCL
   launch per chunk, each sequence's ATE over that pass; the warm chunk
   against the eight sequences' own steps (integers equal, the largest
   float gaps); the batched front end's peak memory; the batched step and
   the per-sequence loop interleaved, a chunk each in turn; the kernel on
   the 64x500x500 map against its plain version and the scipy oracle,
   timed; then one chunk with both pose graphs on); config 5 on the
   keyframe axis (10240 keyframes, 256 tags, 4 LM x 32 PCG) and the
   landmark axis (10240 tags, 64 keyframes, 16384 observations, 4 LM) through
   ``tools/scaling_bench_torch.py`` (8 shards on the one card against 1
   shard, and against ``ba_optimize`` with the sparse coupling), with the
   landmark solve once more on a single-rank NCCL process group;
   ``aprilslam-torch-refine --demo`` at its defaults at 1 and 8 shards; a
   16-frame CLI run's ``--export-problem`` refined on the card;
10. the port's bench (``bench_torch.main()`` in this process): the 64-frame
   headline at batch 8 with its ATE gate at 1.0 su, and the stage split
   (its other legs are phases 5, 8 and 9); its first line must carry every
   headline key and name the card;
11. the measurement tools: ``tools/profile_step_torch.py``'s trace of its
   step (8 frames at 1000x1000; every detector stage and back-end bucket
   must get kernel time, and so must every bucket of the JAX tool's split
   of the same time but its ``other``; the two splits' totals are equal),
   and ``tools/scaling_bench_torch.py --mode kf-proc`` at 10240 keyframes
   on one NCCL rank and at 2048 keyframes on 1 and 2 gloo ranks;
12. robustness: ``tools/probe_robustness_torch.py``'s sweep on the card (the
   default scene from 3 poses at 512x512 under noise, blur, gradients,
   gamma with vignette and the combined stack, then 3 tilted scenes,
   rendered and degraded on the card, detected at ``quad_decimate=1``)
   against ``tests/test_detect_robustness.py``'s floors; the same frames
   through the CPU detector (the same ids, corners within 0.001 px); each
   scenario's full-resolution trinary map through the kernel, the plain
   version and the scipy oracle, bit for bit, and the sigma-0.10 map
   timed; then ``tools/probe_ate_dist_torch.py``'s and
   ``tools/probe_tail_split_torch.py``'s analyses of phase 4's outputs;
13. probes (ROADMAP items 21a, 21b): on phase 5's config-2 frames,
   ``tools/probe_pgo_cost_torch.py``'s five ablation variants and its
   ``on_cap16_it6``/``on_cap16_it4`` rows, ``tools/probe_pgo_iters_torch.py``'s
   ``off``, (10, 6) and (4, 3) rows (one timed pass each): every pgo-on row
   under 1.0 su with a loop edge, the rows that are phase 5's pgo-on step
   (graph capacity 16, depths 4/3) at its ATE to 1e-4 su and its loop edges,
   the two ATE rows equal; then ``tools/probe_quads_torch.py`` at B=8 and
   ``tools/probe_quads_batch_torch.py`` at B=8 and 32 (1000x1000): the full
   prefix equal to ``quad_candidates``, frames 0-7 of B=32 giving B=8's
   quads, the kernel's 8x500x500 and 32x500x500 labels equal to the plain
   version's;
14. the CCL timing line (the config-4 map 8x240x320, config 3's batched
   64x500x500 map, a degraded 3x512x512 map and the probes' 32x500x500 map
   included), one JSON line per kernel,
   the card line, and a final JSON status line.
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

# BASELINE config 3 (bench.py:465-522): 8 sequences of the headline step;
# the keywords of the chunk run with both pose graphs on.
CONFIG3 = dict(estimator="ba", ba_schedule="chunk", init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3,
               graph_capacity=16)
CONFIG3_SEQ = 8
# BASELINE config 5 through tools/scaling_bench_torch.py (its lm defaults
# are config 5's landmark axis); 1 timed solve each, not the tool's 3.
CONFIG5_KF = ["--mode", "kf", "--keyframes", "10240", "--landmarks", "256", "--devices", "8", "--reps", "1"]
CONFIG5_LM = ["--mode", "lm", "--reps", "1"]
# Phase 11: the kf-axis solve in worker processes, one NCCL rank on the card
# and 1 and 2 gloo ranks on the host, one timed solve each.
KF_PROC = {"gpu": ["--mode", "kf-proc", "--platform", "gpu", "--processes", "1", "--keyframes", "10240",
                   "--landmarks", "256", "--reps", "1"],
           "cpu": ["--mode", "kf-proc", "--platform", "cpu", "--processes", "1,2", "--keyframes", "2048",
                   "--landmarks", "256", "--reps", "1"]}
# The JAX refine demo's cost_refined at its defaults on the CPU, by shard count.
REFINE_JAX_CPU_COST = {1: 9081.0, 8: 8934.6}
APPS_FRAMES = 64  # the simulation CLI's default --frames
# Phase 12: the largest corner gap between the card's and the host's
# detections of the same frames. Both run the same detector code on the
# same input; measured at most 0.000092 px apart on the H100.
ROBUST_CORNER_TOL_PX = 1e-3
BATCH = 8
RES = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The port's median translation error (scene units) over the config-4
# clip's ok tag poses, on the JAX-rendered frames on the CPU
# (tests/parity_config4.py; the JAX package gives 0.1283475, 162 poses each).
CONFIG4_CPU_T_ERR_MEDIAN = 0.12829819321632385
# Phase 10: bench_torch.py's headline on 64 frames and its stage split; the
# ATE ceiling is the 64-frame pool's bound (it gave 0.5250 su).
BENCH_KNOBS = dict(BENCH_FRAMES="64", BENCH_PASSES="1", BENCH_BATCH="8", BENCH_PGO="0", BENCH_VIDEO="0",
                   BENCH_MULTISEQ="0", BENCH_STAGES="1", BENCH_ATE_MAX="1.0")
# bench.py's headline keys, less device_fallback, plus the port's card and pool.
BENCH_HEADLINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "ate_rmse_sim_units", "ate_rmse_baseline", "ate_gate",
    "valid_pose_rate", "invalid_frames", "batch", "batch_choice", "batch_sweep_fps", "resolution",
    "frames_timed", "frames_distinct", "graph_capacity", "compile_s", "compile_first_program_s", "device",
    "card", "pool",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


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


def time_ccl_map(ccl_timing: dict, name: str, t: torch.Tensor, card: str) -> None:
    """The kernel on map ``t``: eager and device ms beside its byte bound,
    into ``ccl_timing`` under ``name``."""
    from aprilslam_tpu_torch.ops import ccl

    ccl_timing["ms"][name] = time_cuda(lambda: ccl.connected_components(t), 200)
    ccl_timing["device_ms"][name] = time_cuda_graph(lambda: ccl.connected_components(t))
    ccl_timing["bound_ms"][name] = t.numel() * (1 + 4) / HBM_BYTES_PER_S * 1e3
    log(f"ccl timing {name}: kernel {ccl_timing['ms'][name]:.4f} ms ({ccl_timing['device_ms'][name]:.4f} ms on the "
        f"card), bound {ccl_timing['bound_ms'][name]:.5f} ms (bytes) [{card}]")


def chain_graph_cases():
    """``tests/chain_graph_cases.py``: the chunks and the comparison of the
    chain-graph card tests."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import chain_graph_cases

    return chain_graph_cases


def chain_graph_phase(card: str) -> dict:
    """Phase 3's chain-graph part: the kernel against its plain version on
    random chunks (``tests/chain_graph_cases.py``), then timed at both
    shapes. Returns the worst float gap and the times."""
    from aprilslam_tpu_torch.ops import chain_graph
    from aprilslam_tpu_torch.slam import graph as G
    cases = chain_graph_cases()
    SHAPES, chain_chunk, compare_scans = cases.SHAPES, cases.chain_chunk, cases.compare_scans
    state_to, to_device = cases.state_to, cases.to_device

    dev = torch.device("cuda")
    worst, n = 0.0, 0
    for B, D, M in SHAPES:
        for seed in range(3):
            for project in (True, False):
                state = G.init_graph(M, device=dev)
                for c in (seed, seed + 100):
                    chunk = chain_chunk(c, B, D, M)
                    before = chain_graph.chain_graph_launches
                    got = G.scan_chain_graph(state, *to_device(chunk, dev), project_rotation=project)
                    torch.cuda.synchronize()
                    check(chain_graph.chain_graph_launches == before + 1, "chain graph: not one launch")
                    plain = G.scan_chain_graph_plain(state, *to_device(chunk, dev), project_rotation=project)
                    cpu = G.scan_chain_graph(state_to(state, "cpu"), *to_device(chunk, "cpu"),
                                             project_rotation=project)
                    gap = max(compare_scans(got, plain), compare_scans(got, cpu))
                    check(gap <= 1e-5, f"chain graph {B}x{D}x{M} chunk {c}: float gap {gap} > 1e-5")
                    worst, n = max(worst, gap), n + 1
                    state = got[0]
    log(f"chain graph: kernel == plain on {n} chunks (integers equal, floats within {worst:.3g})")
    timing = {"card": card, "max_rel_gap": worst, "chunks_checked": n,
              "empty_launch_ms": time_cuda(chain_graph.empty_launch, 500),
              "empty_launch_device_ms": time_cuda_graph(chain_graph.empty_launch)}
    for B, D, M in SHAPES:
        name = f"B{B}_D{D}_M{M}"
        state = G.init_graph(M, device=dev)
        chunk = to_device(chain_chunk(0, B, D, M), dev)
        state, _ = G.scan_chain_graph(state, *chunk)  # a warm graph: re-anchoring, hops, keeps
        chunk = to_device(chain_chunk(100, B, D, M), dev)
        args = (state.local, state.world, state.weight, state.present, state.updated, state.reference,
                state.coordinate_id, state.has_estimate, *chunk)
        timing[name] = {
            "kernel_ms": time_cuda(lambda: chain_graph.chain_graph_scan(*args), 200),
            "kernel_device_ms": time_cuda_graph(lambda: chain_graph.chain_graph_scan(*args)),
            "scan_ms": time_cuda(lambda: G.scan_chain_graph(state, *chunk), 100),
            "plain_ms": time_cuda(lambda: G.scan_chain_graph_plain(state, *chunk), 3),
        }
        log(f"chain graph timing {name}: kernel {timing[name]['kernel_ms']:.4f} ms eager, "
            f"{timing[name]['kernel_device_ms']:.4f} ms on the card; with the projection "
            f"{timing[name]['scan_ms']:.4f} ms; plain {timing[name]['plain_ms']:.2f} ms; empty launch "
            f"{timing['empty_launch_ms']:.4f} / {timing['empty_launch_device_ms']:.4f} ms [{card}]")
    return timing


def closure_scan_phase(c2: tuple, params, dev) -> dict:
    """Phase 5's chain-graph part: the pgo-on step of config 2 (the closure
    cell's) over the loop's chunks, every chunk's scan input recorded, one
    launch per chunk; then each recorded chunk through the kernel and the
    plain version."""
    from aprilslam_tpu_torch.ops import chain_graph
    from aprilslam_tpu_torch.slam import SlamSystem, pipeline
    from aprilslam_tpu_torch.slam import graph as G
    compare_scans = chain_graph_cases().compare_scans

    cfg, cam, _traj, chunks = c2
    slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, detector_params=params, device=dev,
                      estimator="ba", ba_schedule="chunk", graph_capacity=16, init_joint_iters=3,
                      ba_chunk_iters=4, pnp_iters=3, pgo=True)
    recorded = []
    scan = pipeline.scan_chain_graph

    def record(state, ids, T, ok, project_rotation=True):
        recorded.append((state, ids.clone(), T.clone(), ok.clone()))
        return scan(state, ids, T, ok, project_rotation=project_rotation)

    pipeline.scan_chain_graph = record
    try:
        before = chain_graph.chain_graph_launches
        for c in chunks:
            slam.process(c)
        torch.cuda.synchronize()
        launches = chain_graph.chain_graph_launches - before
    finally:
        pipeline.scan_chain_graph = scan
    check(launches == len(chunks), f"closure chunks: chain-graph launches {launches} != {len(chunks)}")
    worst = max(compare_scans(G.scan_chain_graph(*r), G.scan_chain_graph_plain(*r)) for r in recorded)
    check(worst <= 1e-5, f"closure chunks: kernel against plain float gap {worst} > 1e-5")
    log(f"closure chunks: {launches} chain-graph launches for {len(chunks)} chunks; kernel == plain on "
        f"each recorded chunk (floats within {worst:.3g})")
    return {"chunks": len(chunks), "launches": launches, "max_rel_gap": worst}


def check_outputs(outs, n: int, what: str) -> None:
    for o in outs:
        for name, v in vars(o).items():
            check(v.device.type == "cuda", f"{what}: output {name} is on {v.device}")
    poses = torch.cat([o.poses for o in outs])
    valid = torch.cat([o.valid for o in outs])
    check(poses.shape == (n, 4, 4), f"{what}: poses shape {tuple(poses.shape)}")
    check(bool(torch.isfinite(poses[valid]).all()), f"{what}: non-finite pose on a valid frame")


def config2_phase(params, dev, card: str) -> tuple[dict, dict, tuple]:
    """BASELINE config 2, pgo off then on, through ``bench_torch``'s config-2
    leg (``bench.py:381-462`` on the port). Returns the report, the CCL
    launches of each side's accuracy pass and the leg's (scene config,
    camera, trajectory, chunks)."""
    from bench_torch import pgo_frames, pgo_run

    from aprilslam_tpu_torch.eval import ate_eval
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.sim import DEFAULT_SCENE

    with open(DEFAULT_SCENE) as f:
        cfg, cam, traj, chunks = pgo_frames(json.load(f), RES, BATCH, dev)
    n_frames = len(traj)
    out = {"frames": n_frames, "trajectory": "two-lap loop", "scene": "randomized(0.1, seed 7)",
           "batch": BATCH, "res": RES, "card": card}
    launches = {}
    for pgo in (False, True):
        leg = "pgo_on" if pgo else "pgo_off"
        ccl.ccl_launches = 0
        outs, dt, step, state = pgo_run(cfg, cam, chunks, params, pgo, dev)
        # An accuracy pass and two timed passes, one launch per chunk each.
        launches[leg] = ccl.ccl_launches // 3
        check(ccl.ccl_launches == 3 * len(chunks),
              f"config 2 {leg}: ccl launches {ccl.ccl_launches} != 3 x {len(chunks)}")
        check_outputs(outs, n_frames, f"config 2 {leg}")
        ate, vrate, n_invalid, _conf = ate_eval(cfg, traj.positions, traj.rotations, outs)
        loop_edges = int(outs[-1].loop_closures[-1])
        fps = n_frames / dt
        breakdown = time_breakdown([chunks[-1]], cfg, cam, params, lambda c: step(state, c)[1],
                                   1e3 * BATCH / fps)
        out[leg] = {"ate": ate, "valid_rate": vrate, "n_invalid": n_invalid, "loop_edges": loop_edges,
                    "fps": fps, "ccl_launches_per_pass": launches[leg], "breakdown": breakdown}
        log(f"config 2 {leg}: ATE {ate:.4f} su, valid {vrate:.4f}, loop edges {loop_edges}, "
            f"{fps:.3f} fps, {breakdown['host_syncs']} host syncs and "
            f"{breakdown['kernel_launches']} kernel launches per chunk [{card}]")
        check(vrate >= 0.95, f"config 2 {leg}: valid rate {vrate} < 0.95")
    check(out["pgo_on"]["ate"] < 1.0, f"config 2 pgo on: ATE {out['pgo_on']['ate']} >= 1.0 su")
    check(out["pgo_on"]["loop_edges"] >= 1, "config 2 pgo on: no loop edge was minted")
    out["fps_on_over_off"] = out["pgo_on"]["fps"] / out["pgo_off"]["fps"]
    return out, launches, (cfg, cam, traj, chunks)


def options_phase(chunk, cfg, cam, params, dev, headline_ba, headline: dict) -> dict:
    """Every other estimator and schedule on one chunk of the main-path
    frames (``headline``: the main path's step keywords), and the sparse BA
    coupling against the dense one."""
    from aprilslam_tpu_torch.geometry import se3_exp
    from aprilslam_tpu_torch.slam import ba_optimize, build_slam_step

    res = {}
    runs = {
        "reference_chain": dict(headline, estimator="reference_chain"),
        "chain_avg": dict(headline, estimator="chain_avg"),
        "joint": dict(headline, estimator="joint"),
        "ba_frame": dict(headline, ba_schedule="frame"),
        "ba_chunk": dict(headline),
        "ba_chunk_zero_dist": dict(headline, dist_coeffs=[0.0, 0.0, 0.0, 0.0, 0.0]),
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
        syncs = host_syncs(slam.process, frames[-1])
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
    syncs = host_syncs(ref.process, u8[-1])
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
    through ``bench_torch``'s config-4 pieces (native reader -> batched
    detect -> PnP), the video app in process on
    the calibration it wrote, and a generated 1024-code family. Returns the
    report, the CCL launches of each run, and the replay's first trinary map
    (8x240x320) for the kernel's timing."""
    from bench_torch import headline_params, video_clip, video_replay

    from aprilslam_tpu_torch.apps import video_detection
    from aprilslam_tpu_torch.calib import board_points, calibrate_camera
    from aprilslam_tpu_torch.detect import TagDetector
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
    from aprilslam_tpu_torch.families.generate import generate_family
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.pose import poses_from_detections
    from aprilslam_tpu_torch.runtime import Y4MReader, render_frames_native
    from aprilslam_tpu_torch.sim import SceneConfig, camera_to_tag_transforms, render_frames, scene_tensors

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
        # (c) the clip and (d) its replay through bench_torch's config-4 leg
        # (bench.py:538-581): a warm-up pass that also keeps the poses for
        # accuracy, then a timed pass.
        clip = os.path.join(tmp, "bench_clip.y4m")
        _cam, traj = video_clip(cfg, dev, clip)
        n_frames = len(traj)
        replay, detector, K = video_replay(clip, cfg, cam, dev, BATCH)
        kept = []
        ccl.ccl_launches = 0
        replay(kept)
        launches_warm = ccl.ccl_launches
        ccl.ccl_launches = 0
        t0 = time.perf_counter()
        n, dets = replay()
        dt = time.perf_counter() - t0
        launches_replay = ccl.ccl_launches
        gt = camera_to_tag_transforms(scene.tag_pos.cpu(), scene.tag_rot.cpu(), torch.as_tensor(traj.positions),
                                      torch.as_tensor(traj.rotations)).numpy()
        index = {int(t): k for k, t in enumerate(cfg.tag_ids())}
        kept = [(first, det.ids.cpu().numpy(), T.cpu().numpy(), ok.cpu().numpy()) for first, det, T, ok in kept]
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
        p = detector.params
        dec = decimate(to_grayscale(on_card[0]), p.quad_decimate)
        first_map = adaptive_threshold_with_levels(dec, tile=p.tile, min_contrast=p.min_contrast)[0].contiguous()

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
    hp = headline_params()
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


def load_tool(name: str):
    """``tools/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def parallel_phase(params, dev, card: str) -> tuple[dict, dict, torch.Tensor]:
    """The parallel package (ROADMAP item 17): BASELINE config 3 through
    ``build_parallel_slam`` (``bench.py:465-522``), config 5 on the
    keyframe axis and the landmark axis through
    ``tools/scaling_bench_torch.py`` (kf and lm modes; 8 shards on the one
    card against 1 shard and against ``ba_optimize``), the landmark solve on
    a single-rank NCCL group, ``aprilslam-torch-refine --demo`` in process,
    and a CLI run's ``--export-problem`` refined on the card. Returns the
    report, the CCL launches of config 3 and its batched 64x500x500 trinary
    map."""
    import torch.distributed as dist
    from bench_torch import Run, bench_multiseq_leg, multiseq_chunks

    from aprilslam_tpu_torch.apps import refine_trajectory
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
    from aprilslam_tpu_torch.eval import ate_eval
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl
    from aprilslam_tpu_torch.parallel import (
        build_distributed_ba, build_parallel_slam, initialize_distributed, keyframe_ba_cost, make_mesh)
    from aprilslam_tpu_torch.parallel.multihost import make_global
    from aprilslam_tpu_torch.parallel.distributed_ba import LM_SHARDED
    from aprilslam_tpu_torch.sim import SceneConfig, trajectory
    from aprilslam_tpu_torch.slam import SlamOutputs, ba_cost, build_slam_step
    from aprilslam_tpu_torch.slam.pipeline import _step_halves

    out = {"card": card}
    launches = {}

    # (a) config 3 through bench_torch's leg: 8 sequences x 2 chunks of 8
    # frames at 1000x1000, a warm chunk and one timed pass (the bench's 4
    # are cut for time). The detector and PnP run once per chunk over the
    # 64 frames of all sequences: one CCL launch per chunk.
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    passes = 1
    ccl.ccl_launches = 0
    c3, outs = bench_multiseq_leg(cfg, params, RES, dev, Run(float("inf")), n_seq=CONFIG3_SEQ, batch=BATCH,
                                  passes=passes)
    n_chunks = (len(outs) - 1) // passes
    launches["leg"] = ccl.ccl_launches
    check(launches["leg"] == 1 + n_chunks * passes,
          f"config 3: CCL launches {launches['leg']} != 1 + {n_chunks} x {passes}")
    launches["per_pass"] = n_chunks
    for o in outs:
        for name, v in vars(o).items():
            check(v.device.type == "cuda", f"config 3: output {name} is on {v.device}")
    timed_outs, last_pass = outs[1:], outs[-n_chunks:]
    trajs = [[trajectory.monte_carlo(BATCH, seed=100 + 10 * s + k) for k in range(n_chunks)]
             for s in range(CONFIG3_SEQ)]
    seq_outs = lambda outs, s: [SlamOutputs(**{k: v[s] for k, v in vars(o).items()}) for o in outs]  # noqa: E731
    ates = [ate_eval(cfg, np.concatenate([t.positions for t in trajs[s]]),
                     np.concatenate([t.rotations for t in trajs[s]]), seq_outs(last_pass, s))[0]
            for s in range(CONFIG3_SEQ)]
    valid = torch.cat([o.valid.reshape(-1) for o in timed_outs])
    c3.update(chunks=n_chunks, timed_passes=passes, valid_rate_last_step=c3["valid_rate"],
              valid_rate=float(valid.float().mean()), ccl_launches_per_pass=launches["per_pass"],
              ate_per_sequence_last_pass=ates)
    check(bool(torch.isfinite(torch.cat([o.poses[o.valid] for o in timed_outs])).all()),
          "config 3: a valid pose is not finite")
    check(c3["valid_rate"] >= 0.95, f"config 3: valid rate {c3['valid_rate']} < 0.95")
    chunks = multiseq_chunks(cfg, cam, RES, dev, CONFIG3_SEQ, BATCH)
    # The warm chunk through each sequence's own step, one after another (the
    # loop the batched step replaced): integers equal to the batched step's,
    # and the largest float gaps.
    step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=params, device=dev, **CONFIG3)
    looped = [step(init(), chunks[0][s]) for s in range(CONFIG3_SEQ)]
    warm = {"bit_equal": True}
    for f in fields(SlamOutputs):
        got, want = getattr(outs[0], f.name), torch.stack([getattr(o, f.name) for _st, o in looped])
        warm["bit_equal"] &= torch.equal(got, want)
        if got.is_floating_point():
            warm[f"{f.name}_max_gap"] = float((got - want).abs().nan_to_num().max())
        else:
            check(torch.equal(got, want), f"config 3: batched {f.name} != the per-sequence steps'")
    c3["warm_chunk_vs_per_sequence"] = warm
    log(f"config 3 warm chunk, batched against per-sequence: integers equal, bit equal {warm['bit_equal']}, pose gap "
        f"{warm['poses_max_gap']}, corner gap {warm['det_corners_max_gap']} [{card}]")
    # Peak memory of the batched front end at 64x1000x1000.
    front, _back = _step_halves(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    front(chunks[0].reshape((-1,) + chunks[0].shape[2:]))
    torch.cuda.synchronize()
    c3["front_peak_mem_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # The batched step against the per-sequence loop, interleaved: from the
    # warm chunk's states each takes chunk 1 then chunk 0, in the order
    # batched, looped, looped, batched, one timed chunk at a time.
    pstep, init_states, _ = build_parallel_slam(make_mesh(CONFIG3_SEQ, axis="data", device=dev), cfg.family, cam,
                                                cfg.tag_size_inner, detector_params=params, **CONFIG3)
    st_b, _o = pstep(init_states(), chunks[0])
    st_l = [st for st, _o in looped]

    def batched_chunk(c):
        nonlocal st_b
        st_b, _o = pstep(st_b, c)

    def looped_chunk(c):
        for s in range(CONFIG3_SEQ):
            st_l[s], _o = step(st_l[s], c[s])

    fps = {"batched": [], "looped": []}
    peak = {}
    for name, k in (("batched", 1), ("looped", 1), ("looped", 0), ("batched", 0)):
        torch.cuda.reset_peak_memory_stats()
        _r, dt = timed(lambda: (batched_chunk if name == "batched" else looped_chunk)(chunks[k]))
        fps[name].append(CONFIG3_SEQ * BATCH / dt)
        peak[name] = max(peak.get(name, 0.0), torch.cuda.max_memory_allocated() / 1e9)
    c3["interleaved"] = {"aggregate_fps": fps, "peak_mem_gb": peak,
                         "batched_over_looped": sum(fps["batched"]) / sum(fps["looped"])}
    log(f"config 3 interleaved: aggregate fps batched {fps['batched']}, looped {fps['looped']}; peak GB {peak}; "
        f"batched front end alone {c3['front_peak_mem_gb']:.3f} GB above its input [{card}]")
    # The CCL on config 3's batched map: the 64 frames of the warm chunk.
    dec = decimate(to_grayscale(chunks[0].reshape((-1,) + chunks[0].shape[2:])), params.quad_decimate)
    config3_map = adaptive_threshold_with_levels(dec, tile=params.tile, min_contrast=params.min_contrast)[0].contiguous()

    # One chunk with both pose graphs on (the production composition).
    chunk0 = chunks[0]
    pstep_pgo, init_pgo, _ = build_parallel_slam(make_mesh(CONFIG3_SEQ, axis="data", device=dev), cfg.family, cam,
                                                 cfg.tag_size_inner, detector_params=params, pgo=True, **CONFIG3)
    ccl.ccl_launches = 0
    (st_pgo, o_pgo), pgo_s = timed(lambda: pstep_pgo(init_pgo(), chunk0))
    launches["pgo_chunk"] = ccl.ccl_launches
    check(launches["pgo_chunk"] == 1, f"config 3 pgo: {launches['pgo_chunk']} CCL launches, not 1")
    c3["pgo_chunk"] = {"valid_rate": float(o_pgo.valid.float().mean()), "s": pgo_s,
                       "finite": bool(torch.isfinite(o_pgo.poses[o_pgo.valid]).all()),
                       "pgo_frames": [int(s[2].frame) for s in st_pgo], "ccl_launches": launches["pgo_chunk"]}
    check(c3["pgo_chunk"]["finite"] and c3["pgo_chunk"]["valid_rate"] >= 0.95,
          f"config 3 pgo: {c3['pgo_chunk']}")
    check(c3["pgo_chunk"]["pgo_frames"] == [BATCH] * CONFIG3_SEQ, f"config 3 pgo: {c3['pgo_chunk']}")
    out["config3"] = c3
    log(f"config 3: {c3['aggregate_fps']:.3f} aggregate fps over {c3['frames_timed']} frames, valid "
        f"{c3['valid_rate']:.4f}, {launches['per_pass']} CCL launches per pass, ATE per sequence "
        f"{[round(a, 4) for a in ates]}; pgo chunk valid {c3['pgo_chunk']['valid_rate']:.4f} in {pgo_s:.2f} s [{card}]")

    # (b) config 5, keyframe axis: tools/scaling_bench_torch.py --mode kf,
    # then one more solve at each shard count for its host syncs and peak
    # memory.
    sb = load_tool("scaling_bench_torch")
    kf_args = sb.parse_args(CONFIG5_KF)
    t0 = time.perf_counter()
    prob, kf_gt, Kk = sb.kf_problem(kf_args)
    kf = {"synth_s": time.perf_counter() - t0, "tool": sb.kf_axis_bench(kf_args, (prob, kf_gt, Kk))}
    tool = kf["tool"]
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p.kf_pose[:, :3, 3].cpu().numpy() - kf_gt[:, :3, 3]) ** 2, -1))))  # noqa: E731
    for n, run in zip((1, kf_args.devices), sb.kf_solvers(kf_args, prob, Kk)):
        torch.cuda.reset_peak_memory_stats()
        ((p, _c), syncs), solve_s = timed(lambda: sync_lines(run))
        kf[f"shards_{n}"] = {"solve_s": solve_s, "cost_refined": float(keyframe_ba_cost(p, Kk, 10.0)),
                             "ate_refined": ate(p), "host_syncs": sum(syncs.values()),
                             "sync_lines": syncs.most_common(4),
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "finite": bool(torch.isfinite(p.kf_pose).all())}
        check(kf[f"shards_{n}"]["finite"], f"config 5 kf: non-finite poses at {n} shards")
        check(kf[f"shards_{n}"]["ate_refined"] < tool["ate_initial"],
              f"config 5 kf: ATE {kf[f'shards_{n}']['ate_refined']} not below {tool['ate_initial']} at {n} shards")
    c1, c8 = tool["cost_single"], tool["cost_distributed"]
    check(abs(c8 - c1) <= 0.05 * c1, f"config 5 kf: 8-shard cost {c8} not within 5 % of 1-shard {c1}")
    check(tool["ate_distributed"] < tool["ate_initial"] and tool["device"] == torch.cuda.get_device_name(0),
          f"config 5 kf: {tool}")
    out["config5_kf"] = kf
    log(f"config 5 kf axis: {json.dumps(kf)} [{card}]")

    # (c) config 5, landmark axis: tools/scaling_bench_torch.py --mode lm (its
    # baseline ba_optimize with the sparse coupling against 8 shards), one
    # more solve of each and of 1 shard for their host syncs and peak
    # memory, and the 1-shard solve on a single-rank NCCL group.
    lm_args = sb.parse_args(CONFIG5_LM)
    t0 = time.perf_counter()
    st, Kl, P_max = sb.lm_world(lm_args.landmarks, lm_args.keyframes, lm_args.obs)
    lm = {"synth_s": time.perf_counter() - t0}
    st = replace(st, **{f.name: getattr(st, f.name).to(dev) for f in fields(st)})
    Kl = Kl.to(dev)
    lm["tool"] = tool = sb.lm_bench(lm_args, (st, Kl, P_max))
    one = build_distributed_ba(make_mesh(1, axis="lm", device=dev), st.n_keyframes, st.n_landmarks,
                               st.n_obs_capacity, 10.0, iters=lm_args.iters, max_obs_per_lm=P_max)
    one(st, Kl)  # warm-up
    single, sharded = sb.lm_solvers(lm_args, st, Kl, P_max)
    for name, run in (("single", single), ("shards_1", lambda: one(st, Kl)), (f"shards_{lm_args.devices}", sharded)):
        torch.cuda.reset_peak_memory_stats()
        (o, syncs), solve_s = timed(lambda: sync_lines(run))
        o = o[0] if isinstance(o, tuple) else o
        lm[name] = {"solve_s": solve_s, "s_per_iter": solve_s / lm_args.iters,
                    "cost_refined": float(ba_cost(o, Kl, 10.0)), "host_syncs": sum(syncs.values()),
                    "sync_lines": syncs.most_common(4), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(lm[name]["cost_refined"] < tool["cost_initial"], f"config 5 lm: cost not reduced ({name}): {lm[name]}")
    c1, c8 = tool["cost_single"], tool["cost_distributed"]
    check(abs(c8 - c1) <= 0.05 * c1, f"config 5 lm: 8-shard cost {c8} not within 5 % of the single solve's {c1}")
    c1 = lm["shards_1"]["cost_refined"]
    # The same one-shard solve on a single-rank NCCL process group.
    initialize_distributed(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, platform="gpu")
    try:
        check(dist.get_backend() == "nccl", f"process group backend {dist.get_backend()}")
        mesh_pg = make_mesh(axis="lm", device=dev, group=dist.group.WORLD)
        s_pg = replace(st, **{f: make_global(mesh_pg, "lm", getattr(st, f)) for f in LM_SHARDED})
        run = build_distributed_ba(mesh_pg, st.n_keyframes, st.n_landmarks, st.n_obs_capacity, 10.0,
                                   iters=lm_args.iters, max_obs_per_lm=P_max)
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
    return out, launches, config3_map


def bench_phase(card: str, kind: str) -> dict:
    """``bench_torch.main()`` in this process with BENCH_KNOBS (every other
    BENCH_ knob unset). Returns its first and last JSON lines and the CCL
    launches of the run."""
    import bench_torch
    from aprilslam_tpu_torch.ops import ccl

    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(BENCH_KNOBS)
    buf = io.StringIO()
    try:
        ccl.ccl_launches = 0
        with contextlib.redirect_stdout(buf):
            rc = bench_torch.main()
        launches = ccl.ccl_launches
    finally:
        for k in BENCH_KNOBS:
            del os.environ[k]
        os.environ.update(saved)
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    check(rc == 0 and len(lines) >= 2, f"bench: exit code {rc}, {len(lines)} JSON lines")
    first, last = lines[0], lines[-1]
    missing = BENCH_HEADLINE_KEYS - set(first)
    check(not missing, f"bench: the headline line lacks {sorted(missing)}")
    check(set(first) <= set(last), "bench: the last line lacks headline keys")
    check(first["device"] == kind and first["card"] == card, f"bench: device {first['device']!r}, card {first['card']!r}")
    n_chunks = int(BENCH_KNOBS["BENCH_FRAMES"]) // BATCH
    check(first["frames_timed"] == n_chunks * BATCH * int(BENCH_KNOBS["BENCH_PASSES"]) and first["batch"] == BATCH,
          f"bench: frames_timed {first['frames_timed']} at batch {first['batch']}")
    check(first["ate_gate"]["pass"] and first["valid_pose_rate"] >= 0.9, f"bench: ATE gate {first['ate_gate']}, "
          f"ATE {first['ate_rmse_sim_units']}, valid {first['valid_pose_rate']}")
    check("extras_failed" not in last and "thr_ccl" in last.get("stage_ms_per_frame", {}),
          f"bench: stages {last.get('stage_ms_per_frame')}, failed {last.get('extras_failed')}")
    # One launch per step (the first, the sweep's, the accuracy and timed
    # passes) and per call of the stage split's three timed prefixes (2
    # warm-up calls and 8 reps each).
    want = 1 + min(n_chunks, 256 // BATCH) + n_chunks * (1 + int(BENCH_KNOBS["BENCH_PASSES"])) + 3 * (2 + 8)
    check(launches == want, f"bench: {launches} CCL launches, expected {want}")
    return {"first": first, "last": last, "ccl_launches": launches}


def tools_phase(card: str) -> tuple[dict, int]:
    """The measurement tools: ``tools/profile_step_torch.py``'s trace of its
    step (8 frames at 1000x1000), and ``tools/scaling_bench_torch.py
    --mode kf-proc`` on one NCCL rank on the card and on 1 and 2 gloo ranks
    (``KF_PROC``). Returns the report and the CCL launches of the profile
    run (its warm-up step and its traced steps)."""
    from aprilslam_tpu_torch.ops import ccl

    pst = load_tool("profile_step_torch")
    ccl.ccl_launches = 0
    t0 = time.perf_counter()
    prof = pst.profile_step("cuda", BATCH, RES, "chunk")
    launches = ccl.ccl_launches
    pst.print_tables(prof)
    stages = prof["stages_us_per_frame"]
    out = {"profile": prof, "profile_s": time.perf_counter() - t0}
    missing = [b for b in (*pst.STAGES, *pst.BACKEND.values()) if not stages.get(b, 0.0) > 0.0]
    check(not missing, f"profile: no time in {missing}: {stages}")
    check(abs(sum(stages.values()) - prof["total_us_per_frame"]) <= 1e-9 * prof["total_us_per_frame"],
          f"profile: the buckets do not sum to the total: {stages}")
    jb = prof["jax_buckets"]
    log("profile, the JAX tool's buckets beside the port's (us per frame): "
        + ", ".join(f"{b} {jb[b]:.1f}" for b in pst.JAX_BUCKETS) + " | "
        + ", ".join(f"{b} {us:.1f}" for b, us in sorted(stages.items(), key=lambda kv: -kv[1])) + f" [{card}]")
    missing = [b for b in pst.JAX_BUCKETS if b != "other" and not jb.get(b, 0.0) > 0.0]
    check(not missing, f"profile: no time in the JAX buckets {missing}: {jb}")
    check(abs(sum(jb.values()) - prof["total_us_per_frame"]) <= 1e-9 * prof["total_us_per_frame"],
          f"profile: the JAX buckets do not sum to the total: {jb}")
    check(prof["card"] == card and prof["launches_per_call"] > 0,
          f"profile: card {prof['card']}, {prof['launches_per_call']} launches per call")
    check(launches == 1 + pst.CALLS, f"profile: {launches} CCL launches, expected {1 + pst.CALLS}")

    sb = load_tool("scaling_bench_torch")
    for platform, argv in KF_PROC.items():
        t0 = time.perf_counter()
        res = sb.kf_proc_bench(sb.parse_args(argv), wall_s=300.0)
        res["wall_s"] = time.perf_counter() - t0
        out[f"kf_proc_{platform}"] = res
        counts = [int(n) for n in argv[argv.index("--processes") + 1].split(",")]
        check(not res["failed"] and [r["processes"] for r in res["rows"]] == counts, f"kf-proc {platform}: {res}")
        for r in res["rows"]:
            check(r["backend"] == {"gpu": "nccl", "cpu": "gloo"}[platform] and np.isfinite(r["cost_final"])
                  and r["ate_final"] < r["ate_initial"], f"kf-proc {platform}: {r}")
        costs = [r["cost_final"] for r in res["rows"]]
        check(max(costs) - min(costs) <= 0.05 * min(costs), f"kf-proc {platform}: costs {costs} not within 5 %")
    return out, launches


def robustness_phase(card: str, cfg, cam, traj, main_outs, main_ba, main_ate: float) -> tuple[dict, int, torch.Tensor]:
    """``tools/probe_robustness_torch.py``'s sweep on the card against the
    robustness test's floors, the same frames through the CPU detector, each
    scenario's full-resolution trinary map through the kernel, its plain
    version and the scipy oracle, and the ATE-distribution and tail-split
    analyses of the main path's outputs (``main_outs``, its BA state after
    that pass, ``main_ate`` its ATE). Returns the report, the CCL launches of
    the sweep and the sigma-0.10 map (the timed one)."""
    from aprilslam_tpu_torch.detect import DetectorParams, TagDetector
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
    from aprilslam_tpu_torch.ops import ccl

    prt = load_tool("probe_robustness_torch")
    ccl.ccl_launches = 0
    swept = list(prt.sweep("cuda"))
    torch.cuda.synchronize()
    launches = ccl.ccl_launches
    check(launches == len(swept) == 14, f"robustness: {launches} CCL launches for {len(swept)} scenarios, expected 14")
    rows, names, host, noisy = [row for _sc, _det, row in swept], [], {}, None
    params = DetectorParams(**prt.DETECTOR)
    for sc, det, row in swept:
        log(f"robustness {row['name']}: found {row['found']}/{row['expected']}, rms {row['rms']:.4f} px, "
            f"false ids {row['false_ids']}, floor {row['floor_ok']} [{card}]")
        check(row["floor_ok"] is not False, f"robustness {row['name']}: below the floor: {row}")
        # The same frames through the CPU detector.
        cpu = TagDetector(sc.family, params, device="cpu").detect(sc.frames.cpu())
        check(prt.id_sets(cpu) == prt.id_sets(det), f"robustness {row['name']}: card ids {prt.id_sets(det)} "
              f"!= host ids {prt.id_sets(cpu)}")
        on_card, on_host = prt.corners_by_id(det), prt.corners_by_id(cpu)
        gap = max((float(np.abs(c[i] - h[i]).max()) for c, h in zip(on_card, on_host) for i in c), default=0.0)
        host[row["name"]] = gap
        check(gap <= ROBUST_CORNER_TOL_PX, f"robustness {row['name']}: card and host corners {gap} px apart")
        # The scenario's full-resolution trinary map through the kernel.
        dec = decimate(to_grayscale(sc.frames), params.quad_decimate)
        trin = adaptive_threshold_with_levels(dec, tile=params.tile, min_contrast=params.min_contrast)[0].contiguous()
        name = f"degraded_{row['name']}_{'x'.join(map(str, trin.shape))}"
        got = ccl.connected_components(trin)
        plain = ccl.connected_components_plain(trin)
        check(torch.equal(got, plain), f"kernel != plain on {name}")
        oracle = scipy_labels(trin.cpu().numpy())
        check(np.array_equal(got.cpu().numpy(), oracle), f"kernel != scipy oracle on {name}")
        log(f"ccl {name}: kernel == plain == oracle ({len(np.unique(oracle))} labels)")
        names.append(name)
        if row["name"] == "noise0.10":
            noisy = trin
    out = {"rows": rows, "card_vs_host_corner_gap_px": host, "maps": names, "ccl_launches": launches, "card": card}

    pad, pts = load_tool("probe_ate_dist_torch"), load_tool("probe_tail_split_torch")
    o = pad.outputs_numpy(main_outs)
    dist = pad.ate_distribution(cfg, traj, o)
    check(abs(dist["rmse"] - main_ate) <= 1e-6 * main_ate,
          f"ate_dist: RMSE {dist['rmse']} != the main path's {main_ate}")
    tail = pts.tail_split(cfg, cam, traj, o, main_ba)
    check(all(np.isfinite(tail[k]) for k in ("est_map_rmse", "gt_map_rmse")), f"tail_split: {tail}")
    out["ate_dist"], out["tail_split"] = dist, tail
    log(json.dumps({"ate_analysis": {
        "frames": len(traj), "rmse": dist["rmse"], "median": dist["median"], "p90": dist["p90"], "max": dist["max"],
        "by_n_visible": dist["by_n_visible"], "rmse_excluding_top": dist["rmse_excluding_top"],
        "est_map_gn_rmse": tail["est_map_rmse"], "gt_map_gn_rmse": tail["gt_map_rmse"],
        "tail_by_n_visible": tail["by_n_visible"], "card": card}}))
    return out, launches, noisy


def probes_phase(card: str, params, dev, config2: dict, c2: tuple) -> tuple[dict, int, torch.Tensor]:
    """ROADMAP items 21a and 21b on the card. On phase 5's config-2 frames
    (``c2``): ``tools/probe_pgo_cost_torch.py``'s five ablation variants and
    its ``on_cap16_it6`` and ``on_cap16_it4`` rows,
    ``tools/probe_pgo_iters_torch.py``'s ``off``, (10, 6) and (4, 3) rows,
    one pass each from a fresh state, timed (the tools' repeated passes are
    cut for time: phase 5 warmed these shapes up); then
    ``tools/probe_quads_torch.py`` at B=8 and ``tools/probe_quads_batch_torch.py``
    at B=8 and 32 (1000x1000). Returns the report, the CCL launches of the
    phase and the 32x500x500 trinary map."""
    from aprilslam_tpu_torch.detect import quad_candidates
    from aprilslam_tpu_torch.ops import ccl

    pc, pi = load_tool("probe_pgo_cost_torch"), load_tool("probe_pgo_iters_torch")
    pq, qb = load_tool("probe_quads_torch"), load_tool("probe_quads_batch_torch")
    cfg, cam, traj, chunks = c2
    phase5 = config2["pgo_on"]
    ccl.ccl_launches = 0
    rows = {}
    n_frames = len(traj)

    def keep(name: str, r: dict) -> None:
        rows[name] = {"fps": n_frames / r["first_s"], "loops": r["loops"],
                      "ate": r["ate"] if "ate" in r else pc.ate_of(cfg, traj, r["outputs"])}
        log(f"probes {name}: {rows[name]['fps']:.3f} fps, ATE {rows[name]['ate']:.4f} su, loop edges {r['loops']} "
            f"[{card}]")

    for name, (pgo, patches) in pc.VARIANTS.items():
        keep(name, pc.run_variant(cfg, cam, chunks, params, dev, pgo, patches, reps=0))
    it_rows = {name: pc.run_variant(cfg, cam, chunks, params, dev, pgo, pc.iters_patch(it), reps=0,
                                    graph_capacity=cap)
               for name, cap, it, pgo in pc.ATE_ROWS if pgo}
    for name, r in it_rows.items():
        keep(name, r)
    it_equal = pc.same_outputs(it_rows["on_cap16_it6"]["outputs"], it_rows["on_cap16_it4"]["outputs"])
    check(it_equal, "probes: on_cap16_it6 and on_cap16_it4 outputs differ")
    for name, pgo, oi, ti in (("iters_off", False, 10, 6), ("iters_on_oi10_ti6", True, 10, 6),
                              ("iters_on_oi4_ti3", True, 4, 3)):
        keep(name, pi.iters_row(cfg, cam, traj, chunks, params, dev, pgo, oi, ti, reps=0))
    torch.cuda.synchronize()
    launches_pgo = ccl.ccl_launches
    check(launches_pgo == len(rows) * len(chunks), f"probes: {launches_pgo} CCL launches != {len(rows)} passes x "
          f"{len(chunks)} chunks")
    for name, r in rows.items():
        if name not in ("off", "iters_off"):
            check(r["ate"] < 1.0 and r["loops"] >= 1, f"probes {name}: ATE {r['ate']} su, {r['loops']} loop edges")
    # The same step as phase 5's pgo-on side (graph capacity 16, the chunk
    # schedule's depths 4/3) on the same frames. The cost probe's "on" runs
    # at build_slam_step's default capacity, 64, as the JAX probe's does.
    for name in ("iters_on_oi4_ti3", "on_cap16_it6", "on_cap16_it4"):
        r = rows[name]
        check(abs(r["ate"] - phase5["ate"]) <= 1e-4 and r["loops"] == phase5["loop_edges"],
              f"probes {name}: ATE {r['ate']} su and {r['loops']} loop edges, phase 5 {phase5['ate']} and "
              f"{phase5['loop_edges']}")
    fps = {k: rows[k]["fps"] for k in pc.VARIANTS}
    out = {"rows": rows, "pgo_on_over_off": fps["on"] / fps["off"], "recovers_pct": pc.recovers(fps),
           "it6_it4_equal_outputs": it_equal, "phase5_pgo_on": {"ate": phase5["ate"], "loops": phase5["loop_edges"]},
           "iters_ratio": {k: rows[k]["fps"] / rows["iters_off"]["fps"]
                           for k in ("iters_on_oi10_ti6", "iters_on_oi4_ti3")},
           "card": card}
    log("probes: " + ", ".join(f"{k} recovers {v:.1f} %" for k, v in out["recovers_pct"].items())
        + f" of the on/off gap; pgo_on/pgo_off {out['pgo_on_over_off']:.3f} [{card}]")

    # The quads sub-stages at B=8, then the nested prefixes at B=8 and 32.
    quads = pq.run(dev, BATCH, RES)
    pq.print_rows(quads)
    batch = qb.run(dev, RES, 10)
    torch.cuda.synchronize()
    for B, b in batch.items():
        qb.print_rows(B, b["rows"])
        m = b["maps"]
        name = "x".join(map(str, m["trinary"].shape))
        check(torch.equal(m["labels"], ccl.connected_components_plain(m["trinary"])),
              f"probes: kernel != plain on the {name} map")
        log(f"ccl probes_{name}: kernel == plain")
        q = quad_candidates(m["trinary"], m["labels"], m["dec"], pq.PARAMS.quad_decimate, m["level"],
                            **pq.quads_kwargs(qb.PARAMS))
        check(torch.equal(torch.nan_to_num(b["outputs"]["full quads"]), torch.nan_to_num(q.corners)),
              f"probes: the full-quads prefix != quad_candidates at B={B}")
    small, big = batch[BATCH], batch[max(batch)]
    check(torch.equal(big["maps"]["frames"][:BATCH], small["maps"]["frames"]),
          "probes: frames 0-7 of the B=32 render differ from B=8's")
    check(torch.equal(torch.nan_to_num(big["outputs"]["full quads"][:BATCH]),
                      torch.nan_to_num(small["outputs"]["full quads"])),
          "probes: the B=32 run's quads of frames 0-7 differ from the B=8 run's")
    launches = ccl.ccl_launches
    check(launches == launches_pgo + 1 + len(batch), f"probes: {launches} CCL launches, expected "
          f"{launches_pgo} + {1 + len(batch)}")
    out["quads"] = {"batch": quads["batch"], "rows": quads["rows"]}
    out["quads_batch"] = {str(B): b["rows"] for B, b in batch.items()}
    out["ccl_launches"] = {"pgo": launches_pgo, "quads": launches - launches_pgo}
    return out, launches, big["maps"]["trinary"]


def host_syncs(process, chunk) -> Counter:
    """Host syncs of one step, ``process(chunk)``, counted by the line of the
    port that made them."""
    return sync_lines(lambda: process(chunk))[1]


def time_breakdown(chunks, cfg, cam, params, process, step_ms: float) -> dict:
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
        process(chunks[0])
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # The card-side spans of the detector's stage ranges are no kernels.
    kernels = sorted((e for e in rows if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                     key=lambda e: -e.self_device_time_total)
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    syncs = host_syncs(process, chunks[0])
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
    ap.add_argument("--frames", type=int, default=64,
                    help="main-path frames (multiple of 8); the bench's poses for that count: at 512 the JAX "
                         "bench's own, else monte_carlo(--frames, seed=3)")
    args = ap.parse_args()
    check(args.frames % BATCH == 0 and args.frames > 0, "--frames must be a positive multiple of 8")

    # ---- 1. card ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from aprilslam_tpu_torch.device import card_line

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    from bench_torch import Knobs, headline_params, headline_poses, render_u8

    from aprilslam_tpu_torch.detect.threshold import (
        adaptive_threshold_with_levels, decimate, to_grayscale)
    from aprilslam_tpu_torch.eval import ate_eval
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.ops import ccl, chain_graph
    from aprilslam_tpu_torch.sim import SceneConfig, scene_tensors
    from aprilslam_tpu_torch.slam import SlamSystem

    dev = torch.device("cuda")

    # ---- 2. build: the kernel (nvcc) and the native runtime (g++) together --
    from concurrent.futures import ThreadPoolExecutor

    from aprilslam_tpu_torch.runtime import build_runtime

    with ThreadPoolExecutor(3) as pool:
        ccl_build, runtime_build = pool.submit(ccl.build_ccl, True), pool.submit(build_runtime)
        cg_build = pool.submit(chain_graph.build_chain_graph, True)
        (lib_path, build_s), (rt_path, rt_build_s) = ccl_build.result(), runtime_build.result()
        cg_path, cg_build_s = cg_build.result()
    log(f"build: {lib_path.name} in {build_s:.2f} s; {cg_path.name} in {cg_build_s:.2f} s; "
        f"{rt_path.name} in {rt_build_s:.2f} s")

    # ---- main-path frames (also phase 3's rendered inputs) ----------------
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    traj, pool_label = headline_poses(args.frames)
    t0 = time.perf_counter()
    chunks = list(render_u8(scene, traj, cam, RES, RES, dev, BATCH).split(BATCH))
    torch.cuda.synchronize()
    log(f"render: {args.frames} frames {RES}x{RES} in {time.perf_counter() - t0:.2f} s")
    # The bench's headline: its detector and its step at the default knobs.
    params = headline_params()
    headline = Knobs.from_env(False, env={}).step_kwargs()

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
    chain_timing = chain_graph_phase(card)

    # ---- 4. main path -----------------------------------------------------
    slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, detector_params=params,
                      device=dev, **headline)
    ccl.ccl_launches = chain_graph.chain_graph_launches = 0
    t0 = time.perf_counter()
    outs = [slam.process(c) for c in chunks]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ccl.ccl_launches
    main_ba = slam.ba_state  # the map the accuracy pass ended with (phase 12)
    check(launches == len(chunks), f"ccl launches {launches} != chunks {len(chunks)}")
    chain_launches = chain_graph.chain_graph_launches
    check(chain_launches == len(chunks), f"chain-graph launches {chain_launches} != chunks {len(chunks)}")
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
    breakdown = time_breakdown(chunks, cfg, cam, params, slam.process, 1e3 * BATCH / fps)
    log(f"breakdown per chunk of {BATCH}: {json.dumps(breakdown)} [{card}]")
    headline_ba = slam.ba_state

    # ---- 5. config 2 ------------------------------------------------------
    config2, config2_launches, config2_frames = config2_phase(params, dev, card)
    closure_scan = closure_scan_phase(config2_frames, params, dev)

    # ---- 6. the other estimators and schedules, the sparse coupling -------
    options = options_phase(chunks[0], cfg, cam, params, dev, headline_ba, headline)
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
    check(np.array_equal(ccl.connected_components(config4_map).cpu().numpy(),
                         scipy_labels(config4_map.cpu().numpy())), "kernel != scipy oracle on the config-4 map")
    time_ccl_map(ccl_timing, "config4_8x240x320", config4_map, card)

    # ---- 9. the parallel package ------------------------------------------
    t0 = time.perf_counter()
    parallel, config3_launches, config3_map = parallel_phase(params, dev, card)
    parallel["phase_s"] = time.perf_counter() - t0
    log(f"parallel phase: {parallel['phase_s']:.1f} s")
    # Config 3's batched map (8 sequences x 8 frames): the kernel against its
    # plain version and the scipy oracle, bit for bit, then timed.
    name9 = "config3_" + "x".join(map(str, config3_map.shape))
    got = ccl.connected_components(config3_map)
    check(torch.equal(got, ccl.connected_components_plain(config3_map)), f"kernel != plain on the {name9} map")
    check(np.array_equal(got.cpu().numpy(), scipy_labels(config3_map.cpu().numpy())),
          f"kernel != scipy oracle on the {name9} map")
    log(f"ccl {name9}: kernel == plain == oracle")
    time_ccl_map(ccl_timing, name9, config3_map, card)
    ccl_timing[f"launch_ms_{name9}"] = launch_split(lambda: ccl.connected_components(config3_map))

    # ---- 10. the port's bench ----------------------------------------------
    t0 = time.perf_counter()
    bench = bench_phase(card, kind)
    bench["phase_s"] = time.perf_counter() - t0
    log(f"bench phase: {bench['phase_s']:.1f} s; headline {bench['first']['value']} fps, ATE "
        f"{bench['first']['ate_rmse_sim_units']} su, stages {bench['last']['stage_ms_per_frame']} [{card}]")

    # ---- 11. the measurement tools ----------------------------------------
    t0 = time.perf_counter()
    tools, launches_profile = tools_phase(card)
    tools["phase_s"] = time.perf_counter() - t0
    per_iter = {p: tools[f"kf_proc_{p}"]["summary"]["per_lm_iter_s"] for p in KF_PROC}
    log(f"tools phase: {tools['phase_s']:.1f} s; profile {tools['profile']['total_us_per_frame']:.1f} us of kernel "
        f"time per frame, busy {tools['profile']['busy_share']:.4f}; kf-proc s per LM iteration by processes "
        f"{per_iter['gpu']} (NCCL), {per_iter['cpu']} (gloo) [{card}]")

    # ---- 12. robustness and the ATE analyses --------------------------------
    t0 = time.perf_counter()
    robustness, launches_robustness, noisy_map = robustness_phase(card, cfg, cam, traj, outs, main_ba, ate)
    robustness["phase_s"] = time.perf_counter() - t0
    log(f"robustness phase: {robustness['phase_s']:.1f} s")
    time_ccl_map(ccl_timing, "degraded_noise0.10_3x512x512", noisy_map, card)

    # ---- 13. the loop-closure cost and quads probes -----------------------
    t0 = time.perf_counter()
    probes, launches_probes, quads_map = probes_phase(card, params, dev, config2, config2_frames)
    probes["phase_s"] = time.perf_counter() - t0
    log(f"probes phase: {probes['phase_s']:.1f} s")
    time_ccl_map(ccl_timing, "probes_32x500x500", quads_map, card)

    # ---- 14. report -------------------------------------------------------
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
        "config3_map": {"shape": list(config3_map.shape), "ms": ccl_timing["ms"][name9],
                        "device_ms": ccl_timing["device_ms"][name9], "bound_ms": ccl_timing["bound_ms"][name9]},
        "launches_bench": bench["ccl_launches"],
        "launches_profile": launches_profile,
        "launches_robustness": launches_robustness,
        "launches_probes": launches_probes,
        "max_abs_err": max_err,
        "match": max_err == 0,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "chain_graph",
        "route": "cuda",
        "source": "aprilslam_tpu_torch/csrc/chain_graph.cu",
        "replaces": None,
        "launches": chain_launches,
        "closure_chunks": closure_scan,
        "timing": chain_timing,
        "bound_by": "latency: the serial chain of B * D slot updates",
        "library_ms": None,
    }]
    log(json.dumps({"main_path": {
        "frames": args.frames, "pool": pool_label,
        "ate": ate, "valid_rate": vrate, "n_invalid": n_invalid,
        "confidence": conf, "fps": fps, "breakdown": breakdown, "card": card}}))
    log(json.dumps({"config2": config2}))
    log(json.dumps({"options": options, "card": card}))
    log(json.dumps({"apps": apps, "card": card}))
    log(json.dumps({"config4": config4}))
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"bench": bench, "card": card}))
    log(json.dumps({"profile": tools["profile"]}))
    log(json.dumps({"kf_proc": {"gpu": tools["kf_proc_gpu"], "cpu": tools["kf_proc_cpu"],
                                "phase_s": tools["phase_s"], "card": card}}))
    log(json.dumps({"robustness": robustness}))
    log(json.dumps({"probes": probes}))
    log(json.dumps({"ccl_timing": ccl_timing}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
