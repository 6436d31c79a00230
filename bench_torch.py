#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: the counterpart of ``bench.py``.

Run it from the root of the repo, which holds the package it imports::

    python3 bench_torch.py                     # on the CUDA device
    BENCH_DEVICE=cpu python3 bench_torch.py    # a small run on the CPU

or as ``aprilslam-torch-bench`` from the same directory.

PRINT-FIRST CONTRACT (as ``bench.py``): the headline JSON line

  {"metric": "frames_per_sec_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 2.69, "ate_rmse_sim_units": ..., "valid_pose_rate": ...}

is printed, flushed and mirrored to ``BENCH_partial_torch.json`` right
after the timed loop, before any extra leg. Each extra leg that lands
re-emits the line with its result merged in, and the last line (with
``total_s``) is a superset of the headline's keys. Progress, with each
leg's CCL kernel launches, goes to stderr.

Headline = BASELINE config 1: the default scene at BENCH_RES square,
uint8, rendered on the device in batches of 8, through the chunk-scheduled
BA step. At 512 frames the poses are the JAX bench's own
``monte_carlo(512, seed=3)`` (``trajectory.reference_pool()``), so the ATE
compares with the JAX bench's; other sizes draw ``monte_carlo(n, seed=3)``
with numpy. The ``pool`` key says which. A short sweep over the candidate
batches picks the batch, then an accuracy pass over the distinct chunks
from a fresh state and BENCH_PASSES timed passes. An ATE above
BENCH_ATE_MAX exits 3 after everything is emitted.

Extras, in bench.py's order, each started only while the budget
BENCH_BUDGET_S leaves it its minimum (else named in ``extras_skipped``):

  pgo_bench           config 2: randomized tags, a two-lap loop, pgo off and on
  video               config 4: a 640x480 Y4M replay, native reader -> detect -> PnP
  multiseq            config 3: 8 sequences through ``build_parallel_slam``
  stage_ms_per_frame  prefix ablation: thr+ccl / +quads / +decode+refine / the rest

Knobs (bench.py's, with its defaults): BENCH_DEVICE (cuda | cpu),
BENCH_BATCH (pins the batch), BENCH_RES, BENCH_FRAMES, BENCH_PASSES,
BENCH_BUDGET_S, BENCH_ATE_MAX, BENCH_GRAPH_CAP, BENCH_CHUNK_ITERS,
BENCH_PNP_ITERS, BENCH_SWEEP_BATCHES, BENCH_STAGES, BENCH_PGO,
BENCH_MULTISEQ, BENCH_VIDEO (=0 skips a leg), BENCH_ESTIMATOR,
BENCH_BA_SCHEDULE, BENCH_KF, BENCH_OBS, BENCH_FRAME_CACHE, BENCH_OBS_MIN.
BENCH_SWEEP has no effect, as in bench.py, which reads it and never uses it.
On the CPU the defaults shrink as bench.py's do: 8 frames, 2 passes,
batch 4, no extras, ATE ceiling 2.0.

Where it departs from bench.py:
- no orchestrator and no CPU fallback: without a GPU and without
  BENCH_DEVICE=cpu it exits 1 and prints no JSON line;
- ``device`` names the card and ``card`` adds its power limit (nvidia-smi);
  there is no ``device_fallback``;
- a leg that raises is named in ``extras_failed`` and the run exits 1
  after emitting (bench.py logs it and exits 0);
- no cold-compile-cache gate in the batch sweep (bench.py skips the other
  candidates after a first compile over 45 s; the port compiles no step);
- a stage difference below zero (timing noise) reads 0.0, as bench.py's
  back-end row already does;
- frame caches are ``aprilslam_torch_bench_*.npy`` in the temporary
  directory, never the JAX bench's files.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from aprilslam_tpu_torch.detect import DetectorParams, TagDetector, detect_fn, quad_candidates
from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
from aprilslam_tpu_torch.device import card_line, resolve_device
from aprilslam_tpu_torch.eval import ate_eval
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.ops import ccl
from aprilslam_tpu_torch.parallel import build_parallel_slam, make_mesh
from aprilslam_tpu_torch.pose import poses_from_detections
from aprilslam_tpu_torch.runtime import Y4MReader
from aprilslam_tpu_torch.sim import (DEFAULT_SCENE, SceneConfig, randomize_scene, render_frames,
                                     scene_tensors, trajectory)
from aprilslam_tpu_torch.slam import build_slam_step

PARTIAL_PATH = Path(__file__).resolve().parent / "BENCH_partial_torch.json"
# Frame pools are cached across runs here (the harness, not the benchmark).
CACHE_PREFIX = os.path.join(tempfile.gettempdir(), "aprilslam_torch_bench_")
BASELINE_FPS = 2.69  # the reference's CPU loop (BASELINE.md)
BASELINE_ATE = 1.797
# bench.py:400-405, the two-lap loop of config 2
PGO_WAYPOINTS = np.array([
    [0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [60.0, 2.0, 12.0],
    [0.0, 0.0, 10.0], [2.0, 1.0, 11.0], [60.0, 0.0, 10.0],
    [60.0, 2.0, 12.0], [0.0, 0.0, 10.0],
])
# bench.py:538-541, config 4's clip: width, height, frames and waypoints
VIDEO_SIZE = (640, 480, 64)
VIDEO_WAYPOINTS = np.array([[0.0, 0.0, 20.0], [8.0, 2.0, 5.0], [0.0, -2.0, 15.0]])


@dataclass(frozen=True)
class Knobs:
    """bench.py's environment knobs and its defaults (shrunk on the CPU)."""

    res: int
    n_frames: int
    passes: int
    pinned: int | None
    sweep_batches: tuple
    stages: bool
    pgo: bool
    multiseq: bool
    video: bool
    ate_max: float
    graph_cap: int
    chunk_iters: int
    pnp_iters: int
    estimator: str
    ba_schedule: str
    ba_keyframes: int
    ba_obs: int
    obs_min: float
    frame_cache: str | None
    budget_s: float

    @classmethod
    def from_env(cls, on_cpu: bool, env=None) -> "Knobs":
        """The knobs from ``env`` (``os.environ`` by default; ``{}`` gives
        the defaults)."""
        env = os.environ if env is None else env
        extra = "0" if on_cpu else "1"
        on = lambda name: env.get(name, extra) != "0"  # noqa: E731
        return cls(
            res=int(env.get("BENCH_RES", "1000")),
            n_frames=int(env.get("BENCH_FRAMES", "8" if on_cpu else "512")),
            passes=int(env.get("BENCH_PASSES", "2" if on_cpu else "1")),
            pinned=int(env["BENCH_BATCH"]) if env.get("BENCH_BATCH") else None,
            sweep_batches=tuple(int(x) for x in env.get("BENCH_SWEEP_BATCHES", "8,16").split(",")),
            stages=on("BENCH_STAGES"),
            pgo=on("BENCH_PGO"),
            multiseq=on("BENCH_MULTISEQ"),
            video=on("BENCH_VIDEO"),
            ate_max=float(env.get("BENCH_ATE_MAX", "2.0" if on_cpu else "0.45")),
            graph_cap=int(env.get("BENCH_GRAPH_CAP", "16")),
            chunk_iters=int(env.get("BENCH_CHUNK_ITERS", "4")),
            pnp_iters=int(env.get("BENCH_PNP_ITERS", "3")),
            estimator=env.get("BENCH_ESTIMATOR", "ba"),
            ba_schedule=env.get("BENCH_BA_SCHEDULE", "chunk"),
            ba_keyframes=int(env.get("BENCH_KF", "16")),
            ba_obs=int(env.get("BENCH_OBS", "512")),
            obs_min=float(env.get("BENCH_OBS_MIN", "0.25")),
            frame_cache=env.get("BENCH_FRAME_CACHE"),
            budget_s=float(env.get("BENCH_BUDGET_S", "500")),
        )

    def step_kwargs(self) -> dict:
        """``build_slam_step``'s keywords for the headline (bench.py:621-640)."""
        return dict(estimator=self.estimator, ba_schedule=self.ba_schedule, graph_capacity=self.graph_cap,
                    ba_keyframes=self.ba_keyframes, ba_obs=self.ba_obs, init_joint_iters=3,
                    ba_chunk_iters=self.chunk_iters, pnp_iters=self.pnp_iters)


class Run:
    """One bench run's clock, budget and output lines."""

    def __init__(self, budget_s: float):
        self.t0 = time.perf_counter()
        self.budget_s = budget_s

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def log(self, msg: str) -> None:
        """Progress on stderr (stdout carries only JSON lines)."""
        print(f"[bench_torch {self.elapsed():6.1f}s] {msg}", file=sys.stderr, flush=True)

    def emit(self, result: dict) -> None:
        """Print a JSON line now and mirror it to BENCH_partial_torch.json."""
        line = json.dumps(result)
        print(line, flush=True)
        try:
            PARTIAL_PATH.write_text(line + "\n")
        except OSError:
            pass


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _save_npy(path: str, arr: np.ndarray) -> None:
    """Best-effort cache write, atomic so a concurrent reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


def _cached_frames(key: str, render_fn) -> np.ndarray:
    """A rendered uint8 frame pool, cached on disk across runs."""
    path = f"{CACHE_PREFIX}{key}.npy"
    if os.path.exists(path):
        try:
            return np.load(path)
        except (OSError, ValueError):
            pass
    arr = render_fn()
    _save_npy(path, arr)
    return arr


def render_u8(scene, traj, cam: PinholeCamera, H: int, W: int, dev, batch: int = 8) -> torch.Tensor:
    """(N, H, W) uint8 frames of ``traj`` rendered on ``dev`` in batches."""
    return torch.cat([
        torch.clamp(render_frames(scene, traj.positions[i:i + batch], traj.rotations[i:i + batch],
                                  cam.inv_matrix, H, W, 2, device=dev) * 255.0, 0, 255).to(torch.uint8)
        for i in range(0, len(traj), batch)
    ])


def _time_fn(fn, args, reps: int, dev, warmup: int = 2) -> float:
    """Mean wall time of fn(*args): enqueue every rep, then synchronise once."""
    for _ in range(warmup):
        fn(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def headline_params() -> DetectorParams:
    """The headline's detector (bench.py:635-636)."""
    return DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)


def headline_poses(n_frames: int) -> tuple:
    """(trajectory, pool label): the JAX bench's own 512 poses at 512 frames,
    else ``monte_carlo(n_frames, seed=3)`` drawn with numpy."""
    if n_frames == 512:
        return trajectory.reference_pool(), "reference"
    return trajectory.monte_carlo(n_frames, seed=3), "monte_carlo_numpy"


def stage_breakdown(cfg, frames, params, full_ms_per_frame, dev, run: Run, reps=8, min_remaining=45.0):
    """Wall-clock prefix ablation (bench.py:267-331): time nested prefixes
    of the detector (thr+ccl, +quads, +decode+refine) and difference
    consecutive rows; the rest of the step is the back end. ms per frame."""
    p = params
    B = frames.shape[0]
    ms: dict[str, float] = {}
    skipped: list[str] = []

    def fits(name: str) -> bool:
        if run.remaining() > min_remaining:
            return True
        skipped.append(name)
        return False

    def thr(fr):
        dec = decimate(to_grayscale(fr), p.quad_decimate)
        trinary, level = adaptive_threshold_with_levels(dec, tile=p.tile, min_contrast=p.min_contrast)
        return dec, trinary, level

    def thrccl(fr):
        _dec, trinary, _level = thr(fr)
        return ccl.connected_components(trinary.contiguous())

    def front(fr):
        dec, trinary, level = thr(fr)
        labels = ccl.connected_components(trinary.contiguous())
        q = quad_candidates(
            trinary, labels, dec, p.quad_decimate, level,
            max_clusters=p.max_clusters, max_quads=p.max_quads,
            pts_per_quad=p.pts_per_quad, min_cluster_pts=p.min_cluster_pts,
            min_side=p.min_side, refine_iters=p.refine_iters,
            max_fit_err=p.max_fit_err, max_boundary=p.max_boundary)
        return q.corners, q.valid

    det = detect_fn(cfg.family, p, device=dev)
    per_frame = lambda fn: _time_fn(fn, (frames,), reps, dev) / B * 1e3  # noqa: E731
    t_thrccl = t_front = t_det = None
    if fits("thr_ccl"):
        t_thrccl = per_frame(thrccl)
        ms["thr_ccl"] = t_thrccl
    if t_thrccl is not None and fits("quads"):
        t_front = per_frame(front)
        ms["quads"] = max(0.0, t_front - t_thrccl)
    if t_front is not None and fits("decode_refine"):
        t_det = per_frame(lambda fr: det(fr).corners)
        ms["decode_refine"] = max(0.0, t_det - t_front)
    if t_det is not None:
        ms["backend_pnp_scan_ba_reloc"] = max(0.0, full_ms_per_frame - t_det)
    return ms, skipped


def pgo_frames(base_cfg_raw, res: int, batch: int, dev) -> tuple:
    """Config 2's scene, camera, two-lap trajectory and uint8 chunks
    (``96 // batch`` of them), rendered on ``dev`` and cached."""
    cfg = SceneConfig.from_dict(randomize_scene(base_cfg_raw, 0.1, seed=7))
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    n_frames = (96 // batch) * batch
    traj = trajectory.scripted_waypoints(n_frames, PGO_WAYPOINTS)
    scene = scene_tensors(cfg, device=dev)
    arr = _cached_frames(f"pgo_{res}_n{n_frames}_B{batch}_s7",
                         lambda: render_u8(scene, traj, cam, res, res, dev, batch).cpu().numpy())
    return cfg, cam, traj, [torch.as_tensor(arr[i:i + batch], device=dev) for i in range(0, n_frames, batch)]


def pgo_run(cfg, cam, chunks, params, pgo: bool, dev, graph_cap=16, chunk_iters=4, pnp_iters=3) -> tuple:
    """One side of config 2: an accuracy pass from a fresh state (also the
    warm-up), then the best of two timed passes. Returns (the accuracy
    pass's outputs, the best pass's seconds, the step, its last state)."""
    step, init = build_slam_step(
        cfg.family, cam, cfg.tag_size_inner, detector_params=params,
        estimator="ba", ba_schedule="chunk", init_joint_iters=3,
        ba_chunk_iters=chunk_iters, pnp_iters=pnp_iters, pgo=pgo,
        graph_capacity=graph_cap, device=dev,
    )
    state = init()
    all_outs = []
    for c in chunks:
        state, o = step(state, c)
        all_outs.append(o)
    _sync(dev)
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for c in chunks:
            state, o = step(state, c)
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)
    return all_outs, dt, step, state


def bench_pgo_leg(base_cfg_raw, params, res, batch, dev, run: Run, graph_cap=16, chunk_iters=4,
                  pnp_iters=3) -> dict:
    """BASELINE config 2 (bench.py:381-462): randomized tag placement and a
    two-lap loop, pgo off then on, each with an accuracy pass and the best
    of two timed passes."""
    cfg, cam, traj, chunks = pgo_frames(base_cfg_raw, res, batch, dev)
    n_frames = len(traj)
    out = {"frames": n_frames, "trajectory": "two-lap loop", "scene": "randomized(0.1, seed 7)"}
    for pgo in (False, True):
        all_outs, dt, _step, _state = pgo_run(cfg, cam, chunks, params, pgo, dev, graph_cap=graph_cap,
                                              chunk_iters=chunk_iters, pnp_iters=pnp_iters)
        ate, vrate, _ninv, _conf = ate_eval(cfg, traj.positions, traj.rotations, all_outs)
        tag = "pgo_on" if pgo else "pgo_off"
        out[f"fps_{tag}"] = round(n_frames / dt, 2)
        out[f"ate_{tag}"] = round(ate, 4)
        out[f"valid_{tag}"] = round(vrate, 4)
        if pgo:
            out["loop_edges"] = int(all_outs[-1].loop_closures[-1])
        run.log(f"pgo leg {tag}: {out[f'fps_{tag}']} fps ate {out[f'ate_{tag}']}")
    out["fps_on_over_off"] = round(out["fps_pgo_on"] / out["fps_pgo_off"], 3)
    return out


def multiseq_chunks(cfg, cam: PinholeCamera, res: int, dev, n_seq=8, batch=8) -> list:
    """Config 3's two chunks, each (n_seq, batch, res, res) uint8: sequence
    s's chunk k holds ``monte_carlo(batch, seed=100 + 10 s + k)``, rendered
    on ``dev`` and cached."""
    scene = scene_tensors(cfg, device=dev)

    def render_all():
        return np.stack([
            np.stack([render_u8(scene, trajectory.monte_carlo(batch, seed=100 + 10 * s + k), cam, res, res,
                                dev, batch).cpu().numpy() for s in range(n_seq)])
            for k in range(2)])

    arr = _cached_frames(f"multiseq_{res}_S{n_seq}_B{batch}", render_all)
    return [torch.as_tensor(arr[k], device=dev) for k in range(arr.shape[0])]


def bench_multiseq_leg(cfg, params, res, dev, run: Run, n_seq=8, batch=8, passes=4, graph_cap=16,
                       chunk_iters=4, pnp_iters=3) -> tuple:
    """BASELINE config 3 (bench.py:465-522): ``n_seq`` independent
    trajectories of 2 chunks each through ``build_parallel_slam`` on one
    device, one warm chunk, then ``passes`` timed passes. bench.py vmaps the
    step over the sequences; the port's parallel step runs the detector and
    PnP once per chunk over all ``n_seq * batch`` frames, then each
    sequence's back end (``parallel/sequences.py``).

    Returns (report, every step's outputs in order: the warm chunk's, then
    each timed pass's, each stacked (n_seq, batch, ...))."""
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    chunks = multiseq_chunks(cfg, cam, res, dev, n_seq, batch)
    pstep, init_states, _shard = build_parallel_slam(
        make_mesh(n_seq, axis="data", device=dev), cfg.family, cam, cfg.tag_size_inner,
        detector_params=params, estimator="ba", ba_schedule="chunk", init_joint_iters=3,
        ba_chunk_iters=chunk_iters, pnp_iters=pnp_iters, graph_capacity=graph_cap,
    )
    states, o = pstep(init_states(), chunks[0])
    outs = [o]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(passes):
        for c in chunks:
            states, o = pstep(states, c)
            outs.append(o)
    _sync(dev)
    dt = time.perf_counter() - t0
    frames = passes * len(chunks) * n_seq * batch
    fps = frames / dt
    run.log(f"multiseq leg: {fps:.1f} aggregate fps ({n_seq} sequences)")
    return {"sequences": n_seq, "batch_per_seq": batch, "resolution": res,
            "aggregate_fps": round(fps, 2), "frames_timed": frames,
            "valid_rate": round(float(o.valid.float().mean()), 4)}, outs


def video_clip(cfg, dev, path: str) -> tuple:
    """Config 4's 64-frame 640x480 clip (bench.py:538-556), rendered on
    ``dev`` (cached) and written to ``path`` as Y4M. Returns (camera,
    trajectory)."""
    W, H, n_frames = VIDEO_SIZE
    cam = PinholeCamera.from_fov(W, H, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    traj = trajectory.scripted_waypoints(n_frames, VIDEO_WAYPOINTS)
    y = _cached_frames(f"video_{W}x{H}_n{n_frames}",
                       lambda: render_u8(scene, traj, cam, H, W, dev).cpu().numpy())
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Cmono\n".encode())
        for fr in y:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
    return cam, traj


def video_replay(path: str, cfg, cam: PinholeCamera, dev, batch: int = 8) -> tuple:
    """(replay, detector, K): ``replay(keep=None)`` reads the clip at
    ``path`` through the native reader -> batched detect -> PnP
    (bench.py:563-581) and returns (frames, ok tag poses); ``keep``, if
    given, gets (first frame, detections, poses, ok) of each batch."""
    detector = TagDetector(cfg.family, DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16),
                           device=dev)
    K = torch.as_tensor(cam.matrix, device=dev)

    def replay(keep=None):
        n, dets = 0, 0
        with Y4MReader(path) as r:
            while True:
                b = r.read_batch(batch)
                if b.shape[0] == 0:
                    break
                det = detector.detect(torch.from_numpy(b).to(dev))
                T, okp, _rms, _seed, _alt = poses_from_detections(det, K, cfg.tag_size_inner)
                dets += int(okp.sum())
                if keep is not None:
                    keep.append((n, det, T, okp))
                n += int(b.shape[0])
        _sync(dev)
        return n, dets

    return replay, detector, K


def bench_video_leg(cfg, dev, run: Run) -> dict:
    """BASELINE config 4 (bench.py:525-584): a 64-frame 640x480 clip written
    as Y4M and replayed through the native reader -> batched detect -> PnP;
    one warm replay, then a timed one."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_clip.y4m")
        cam, _traj = video_clip(cfg, dev, path)
        replay, _det, _K = video_replay(path, cfg, cam, dev)
        replay()  # warm-up: the reader's library, the allocator, the file cache
        t0 = time.perf_counter()
        n, dets = replay()
        dt = time.perf_counter() - t0
    fps = n / dt
    run.log(f"video leg: {fps:.1f} fps over {n} frames ({dets} tag poses)")
    return {"resolution": "{}x{}".format(*VIDEO_SIZE[:2]), "frames": n, "fps": round(fps, 2),
            "vs_realtime_30fps": round(fps / 30.0, 2), "tag_poses": dets}


def _headline_pool(k: Knobs, traj, pool_label: str, scene, cam, dev, run: Run) -> np.ndarray:
    """The headline's distinct uint8 frames: the frame cache if it holds
    (n, H, W) frames, else rendered on the device (and cached)."""
    H = W = k.res
    path = k.frame_cache
    if path is None:
        path = f"{CACHE_PREFIX}frames_{W}x{H}_n{k.n_frames}_{pool_label}.npy"
    if path and os.path.exists(path):
        try:
            arr = np.load(path)
            if arr.shape == (k.n_frames, H, W):
                run.log(f"loading pre-rendered pool from {path}")
                return arr
        except (OSError, ValueError) as e:
            run.log(f"frame cache load failed ({e}); re-rendering")
    run.log("rendering frame pool")
    pool_np = render_u8(scene, traj, cam, H, W, dev).cpu().numpy()
    if path:
        _save_npy(path, pool_np)
    return pool_np


def bench_headline(k: Knobs, cfg, params, dev, run: Run, device_name: str, card) -> tuple:
    """BASELINE config 1 (bench.py:587-830). Returns (result, ate_ok, the
    batch, fps, one chunk kept for the stage split)."""
    H = W = k.res
    on_cpu = dev.type == "cpu"
    cam = PinholeCamera.from_fov(W, H, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    traj, pool_label = headline_poses(k.n_frames)

    def make_step():
        return build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=params, device=dev,
                               **k.step_kwargs())

    pool = torch.as_tensor(_headline_pool(k, traj, pool_label, scene, cam, dev, run), device=dev)
    _sync(dev)
    run.log("pool on device; selecting headline batch")

    if k.pinned:
        candidates = [k.pinned]
    elif on_cpu:
        candidates = [4]
    else:
        candidates = [b for b in k.sweep_batches if k.n_frames % b == 0] or [8]
    sweep: dict[str, float] = {}
    steps = {}
    compile_done_s = first_compile_cost = None
    for Bc in candidates:
        if steps and run.remaining() < 150.0:
            run.log(f"sweep batch {Bc}: skipped (budget)")
            continue
        nB = k.n_frames // Bc
        chunks_c = pool.reshape(nB, Bc, H, W)
        run.log(f"sweep batch {Bc}: first step")
        t_first = time.perf_counter()
        step_c, init_c = make_step()
        st, _o = step_c(init_c(), chunks_c[0])
        _sync(dev)
        if compile_done_s is None:
            compile_done_s = run.elapsed()
            first_compile_cost = time.perf_counter() - t_first
        reps = max(2, min(nB, 256 // Bc))
        t0 = time.perf_counter()
        for i in range(reps):
            st, _o = step_c(st, chunks_c[(i + 1) % nB])
        _sync(dev)
        fps_c = reps * Bc / (time.perf_counter() - t0)
        sweep[str(Bc)] = round(fps_c, 2)
        steps[Bc] = (step_c, init_c)
        run.log(f"sweep batch {Bc}: {fps_c:.1f} fps")
    B = int(max(sweep, key=sweep.get)) if sweep else candidates[0]
    step, init = steps[B] if B in steps else make_step()
    n_chunks = k.n_frames // B
    chunks = pool.reshape(n_chunks, B, H, W)
    run.log(f"headline batch {B} (sweep {sweep}); accuracy pass")

    state = init()
    all_outs = []
    for c in chunks:
        state, outs = step(state, c)
        all_outs.append(outs)
    _sync(dev)
    run.log("accuracy pass done; timed loop")

    t0 = time.perf_counter()
    for _ in range(k.passes):
        for c in chunks:
            state, outs = step(state, c)
    _sync(dev)
    dt = time.perf_counter() - t0
    frames_timed = k.passes * n_chunks * B
    fps = frames_timed / dt
    run.log(f"timed loop done: {fps:.1f} fps")
    sweep[str(B)] = round(fps, 2)

    ate, vrate, n_invalid, conf = ate_eval(cfg, traj.positions, traj.rotations, all_outs, obs_min=k.obs_min)
    ate_ok = bool(ate == ate and ate <= k.ate_max)
    result = {
        "metric": "frames_per_sec_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "ate_rmse_sim_units": round(ate, 4),
        "ate_rmse_baseline": BASELINE_ATE,
        "ate_gate": {"max": k.ate_max, "pass": ate_ok},
        "valid_pose_rate": round(vrate, 4),
        "invalid_frames": n_invalid,
        **({"ate_confidence_split": conf} if conf else {}),
        "batch": B,
        "batch_choice": "pinned" if k.pinned else "sweep_winner",
        "batch_sweep_fps": sweep,
        "resolution": f"{W}x{H}",
        "frames_timed": frames_timed,
        "frames_distinct": k.n_frames,
        "graph_capacity": k.graph_cap,
        # The first step's wall time: elapsed since the start, and the call
        # alone (the port compiles nothing but the CCL library on first use).
        "compile_s": round(compile_done_s or 0.0, 1),
        "compile_first_program_s": round(first_compile_cost or 0.0, 1),
        "device": device_name,
        "card": card,
        "pool": pool_label,
    }
    if not ate_ok:
        run.log(f"ATE GATE FAILED: {ate:.4f} > {k.ate_max}; the run exits 3 after emitting")
    # A copy, so that the pool's memory goes with the pool before the legs.
    return result, ate_ok, B, fps, chunks[0].clone()


def main() -> int:
    name = os.environ.get("BENCH_DEVICE", "cuda")
    if name not in ("cuda", "cpu"):
        print(f"bench_torch: BENCH_DEVICE must be cuda or cpu, not {name!r}", file=sys.stderr)
        return 2
    try:
        dev = resolve_device(name)
    except RuntimeError as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1
    on_cpu = dev.type == "cpu"
    k = Knobs.from_env(on_cpu)
    run = Run(k.budget_s)
    if on_cpu:
        run.log("running on the CPU (BENCH_DEVICE=cpu); shrunken defaults")
    device_name, card = ("cpu", None) if on_cpu else (torch.cuda.get_device_name(0), card_line())
    cfg = SceneConfig.from_file()
    params = headline_params()

    launches0 = ccl.ccl_launches
    result, ate_ok, B, fps, stage_chunk = bench_headline(k, cfg, params, dev, run, device_name, card)
    run.log(f"headline: {ccl.ccl_launches - launches0} CCL launches")
    run.emit(result)  # print-first: the headline goes out before any extra

    extras_skipped: list[str] = []
    extras_failed: list[str] = []

    def pgo_leg():
        with open(DEFAULT_SCENE) as f:
            raw = json.load(f)
        return bench_pgo_leg(raw, params, k.res, min(B, 8), dev, run, graph_cap=k.graph_cap,
                             chunk_iters=k.chunk_iters, pnp_iters=k.pnp_iters)

    def multiseq_leg():
        return bench_multiseq_leg(cfg, params, k.res, dev, run, graph_cap=k.graph_cap,
                                  chunk_iters=k.chunk_iters, pnp_iters=k.pnp_iters)[0]

    def stage_leg():
        run.log("stage breakdown (prefix ablation)")
        ms, skipped = stage_breakdown(cfg, stage_chunk, params, 1e3 / fps, dev, run)
        extras_skipped.extend(f"stage_{s}" for s in skipped)
        return {s: round(v, 3) for s, v in ms.items()}

    # (name in extras_skipped/extras_failed, result key, on, least budget left to start, leg)
    extras = [
        ("pgo_bench", "pgo_bench", k.pgo, 90.0, pgo_leg),
        ("video", "video", k.video, 40.0, lambda: bench_video_leg(cfg, dev, run)),
        ("multiseq", "multiseq", k.multiseq, 75.0, multiseq_leg),
        ("stage_breakdown", "stage_ms_per_frame", k.stages, 45.0, stage_leg),
    ]
    for leg_name, key, enabled, min_left, leg in extras:
        if not enabled:
            continue
        if run.remaining() <= min_left:
            extras_skipped.append(leg_name)
            continue
        launches0 = ccl.ccl_launches
        try:
            result[key] = leg()
        except Exception:  # noqa: BLE001 — a failed leg keeps the headline and fails the run
            run.log(f"{leg_name} leg failed:\n{traceback.format_exc()}")
            extras_failed.append(leg_name)
            continue
        run.log(f"{leg_name}: {ccl.ccl_launches - launches0} CCL launches")
        run.emit(result)

    if extras_skipped:
        result["extras_skipped"] = extras_skipped
    if extras_failed:
        result["extras_failed"] = extras_failed
    result["total_s"] = round(run.elapsed(), 1)
    run.emit(result)  # the enriched final line, a superset of the headline's keys
    if not ate_ok:
        return 3
    return 1 if extras_failed else 0


if __name__ == "__main__":
    sys.exit(main())
