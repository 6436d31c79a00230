"""BASELINE config 3's batched detection on the CPU: the port's parallel
step runs the front end (detection and PnP) once over every sequence's
frames, then each sequence's back end (``parallel/sequences.py``).

* The batched front end against the front end run sequence by sequence.
* The batched step at ``bench.py``'s config-3 settings against JAX's
  ``jax.jit(jax.vmap(step))`` as ``bench.py:499-507`` builds it, on the
  same JAX-rendered frames.
* The pose-graph composition (``pgo=True``) against each sequence's own
  step run alone.
* Two CPU processes joined by a gloo group, each holding two sequences of
  a 4-sequence ``data`` axis, against each sequence's own step.

The file is also the two-process test's worker: ``python
tests/test_torch_multiseq.py --rank R --world 2 --port P`` joins the group
and prints one JSON line.
"""

import json
import os
import socket
import subprocess
import sys
from dataclasses import fields, is_dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams as JaxDetectorParams
from aprilslam_tpu.geometry import PinholeCamera as JaxCamera
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu.slam import build_slam_step as jax_build_slam_step
from aprilslam_tpu_torch.detect import DetectorParams
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.parallel import build_parallel_slam, make_mesh
from aprilslam_tpu_torch.slam import SlamOutputs, build_slam_step
from aprilslam_tpu_torch.slam.pipeline import _step_halves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RES, S, B, N_CHUNKS = 256, 3, 4, 2
# bench.py's headline detector (bench.py:635-636) and its config-3 step
# (bench.py:500-505 at the leg's defaults).
HEADLINE = dict(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
CONFIG3 = dict(estimator="ba", ba_schedule="chunk", init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3,
               graph_capacity=16)
# The batched step's poses against JAX's vmapped step, on valid frames.
# Measured gap on the CPU: 0.0169 su, on sequence 1's first frame; every
# other frame within 0.0039. That frame sees one tag, 91 su away, at 256 px:
# both packages' re-localization (6 Gauss-Newton steps on 4 corners) stops
# about 1.5 su short of the tag's PnP pose along the weak lateral direction
# (ROADMAP.md, section 3), and the two stop 0.0169 apart while their PnP
# poses agree to 1e-5. The port's step run on that sequence alone gives the
# same pose bit for bit, so the gap is the back end's, not batching's.
POSE_TOL = 2e-2
JAX_INTS = ("det_ids", "det_ok", "valid", "coord_id", "n_nodes")
# The two-process test: 4 scripted lines at 128x128 (tests/test_torch_parallel.py's
# detector), 2 sequences per rank.
GLOO_RES, GLOO_SEQ, GLOO_B = 128, 4, 2
GLOO_DET = dict(quad_decimate=1, max_quads=16, max_detections=8, max_clusters=64, pts_per_quad=64,
                min_cluster_pts=8, min_side=2.0)
WALL_S = 120  # each worker's wall clock; init_process_group times out at 60 s


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """(cfg, port camera, frames (N_CHUNKS, S, B, RES, RES) uint8): sequence
    s's chunk k holds ``monte_carlo(B, seed=100 + 10 s + k)``, rendered by
    the JAX package as bench.py's config-3 leg renders it."""
    with jax.enable_x64(False):
        cfg = SceneConfig.from_file()
        cam = JaxCamera.from_fov(RES, RES, cfg.fov_y)
        sc = scene_tensors(cfg)
        chunks = []
        for k in range(N_CHUNKS):
            per_seq = []
            for s in range(S):
                tr = trajectory.monte_carlo(B, seed=100 + 10 * s + k)
                f = render_frames(sc, jnp.asarray(tr.positions), jnp.asarray(tr.rotations),
                                  jnp.asarray(cam.inv_matrix), RES, RES, 2)
                per_seq.append(np.asarray(jnp.clip(f * 255.0, 0, 255).astype(jnp.uint8)))
            chunks.append(np.stack(per_seq))
    return cfg, PinholeCamera.from_fov(RES, RES, cfg.fov_y), np.stack(chunks)


def _assert_same(a, b, what):
    """Exactly equal, NaN where NaN (the padding slots of a frame's
    detections carry NaN homographies and poses)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{what}: {m}")


def _leaves(x, path=()):
    """(path, tensor or number) for every leaf of a step state."""
    if is_dataclass(x):
        for f in fields(x):
            yield from _leaves(getattr(x, f.name), path + (f.name,))
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, path + (i,))
    else:
        yield path, x


def _equal_outputs(got, want, what):
    for f in fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), (what, f.name)


@pytest.mark.parametrize("variant", ["gray", "colour", "distorted"])
def test_batched_front_equals_per_sequence(scene, variant):
    """One front-end call over the S x B frames gives each sequence exactly
    what the front end gives its B frames alone: every Detections field and
    every PnP output (poses, ok, seed, the other branch) exactly equal.
    ``colour`` feeds (S, B, H, W, 3) frames, ``distorted`` undistorts the
    corners at the detect -> geometry boundary."""
    cfg, cam, frames = scene
    x = torch.as_tensor(frames[0])
    kw = {}
    if variant == "colour":
        x = torch.stack([x, x // 2 + 64, x], dim=-1)
    if variant == "distorted":
        kw["dist_coeffs"] = [-0.05, 0.01, 1e-4, -1e-4]
    step, _init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=DetectorParams(**HEADLINE),
                                  device="cpu", **CONFIG3, **kw)
    front, _back = _step_halves(step)
    det, *poses = front(x.reshape((S * B,) + x.shape[2:]))
    assert int(det.valid.sum()) >= S * B, "too few detections: the comparison is idle"
    for s in range(S):
        det_s, *poses_s = front(x[s])
        for f in fields(det_s):
            _assert_same(getattr(det, f.name)[s * B:(s + 1) * B], getattr(det_s, f.name), (s, f.name))
        for name, a, b in zip(("T", "ok", "seed", "T_alt"), poses, poses_s):
            _assert_same(a[s * B:(s + 1) * B], b, (s, name))


def test_batched_step_matches_jax_vmap(scene):
    """bench.py's config-3 step over 2 sequences x 2 chunks: the port's
    batched parallel step against ``jax.jit(jax.vmap(step))``. Integers
    equal, poses within POSE_TOL on valid frames, and each sequence equal to
    its own step run alone."""
    cfg, cam, frames = scene
    frames = frames[:, :2]
    with jax.enable_x64(False):
        jstep, jinit = jax_build_slam_step(cfg.family, JaxCamera.from_fov(RES, RES, cfg.fov_y), cfg.tag_size_inner,
                                           detector_params=JaxDetectorParams(**HEADLINE), **CONFIG3)
        step_v = jax.jit(jax.vmap(jstep))
        jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *[jinit() for _ in range(2)])
        j_outs = []
        for k in range(N_CHUNKS):
            jstates, o = step_v(jstates, jnp.asarray(frames[k]))
            j_outs.append(jax.device_get(o))
    pstep, init_states, shard = build_parallel_slam(make_mesh(2, device="cpu"), cfg.family, cam, cfg.tag_size_inner,
                                                    detector_params=DetectorParams(**HEADLINE), **CONFIG3)
    states, outs = init_states(), []
    for k in range(N_CHUNKS):
        states, o = pstep(states, shard(frames[k]))
        outs.append(o)
    gap = 0.0
    for got, want in zip(outs, j_outs):
        for name in JAX_INTS:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        v = got.valid.numpy()
        assert v.any()
        gap = max(gap, float(np.abs(got.poses.numpy() - np.asarray(want.poses))[v].max()))
    assert gap <= POSE_TOL, gap
    step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=DetectorParams(**HEADLINE),
                                 device="cpu", **CONFIG3)
    for s in range(2):
        st = init()
        for k in range(N_CHUNKS):
            st, one = step(st, torch.as_tensor(frames[k, s]))
            _equal_outputs(type(one)(**{f.name: getattr(outs[k], f.name)[s] for f in fields(one)}), one, (s, k))


def test_pgo_composition_equals_each_sequence_alone(scene):
    """pgo=True through the batched parallel step, 3 sequences x 2 chunks:
    every output and the pose-graph state of each sequence equal those of
    its own step run alone."""
    cfg, cam, frames = scene
    kw = dict(detector_params=DetectorParams(**HEADLINE), pgo=True, pgo_nodes=16, pgo_edges=48, **CONFIG3)
    pstep, init_states, shard = build_parallel_slam(make_mesh(S, device="cpu"), cfg.family, cam,
                                                    cfg.tag_size_inner, **kw)
    states, outs = init_states(), []
    for k in range(N_CHUNKS):
        states, o = pstep(states, shard(frames[k]))
        outs.append(o)
    step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, device="cpu", **kw)
    for s in range(S):
        st = init()
        for k in range(N_CHUNKS):
            st, one = step(st, torch.as_tensor(frames[k, s]))
            _equal_outputs(type(one)(**{f.name: getattr(outs[k], f.name)[s] for f in fields(one)}), one, (s, k))
        assert len(states[s]) == 4 and int(states[s][2].frame) == N_CHUNKS * B
        got, want = list(_leaves(states[s])), list(_leaves(st))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert torch.equal(a, b) if torch.is_tensor(b) else a == b, (s, path)


def _gloo_problem():
    """(step keywords, camera, frames (GLOO_SEQ, GLOO_B, R, R) uint8) of the
    two-process test, rendered by the port on the CPU."""
    from aprilslam_tpu_torch.sim import SceneConfig as TSceneConfig
    from aprilslam_tpu_torch.sim import render_frames as t_render
    from aprilslam_tpu_torch.sim import scene_tensors as t_scene
    from aprilslam_tpu_torch.sim import trajectory as t_traj

    cfg = TSceneConfig.from_file()
    cam = PinholeCamera.from_fov(GLOO_RES, GLOO_RES, cfg.fov_y)
    sc = t_scene(cfg, device="cpu")
    frames = []
    for s in range(GLOO_SEQ):
        tr = t_traj.scripted_line(GLOO_B, np.array([s * 1.0, 0, 22.0]), np.array([s * 1.0 + 2, 0, 15.0]))
        f = t_render(sc, tr.positions, tr.rotations, cam.inv_matrix, GLOO_RES, GLOO_RES, 1, device="cpu")
        frames.append(torch.clamp(f * 255.0, 0, 255).to(torch.uint8))
    kw = dict(family=cfg.family, camera=cam, tag_size=cfg.tag_size_inner,
              detector_params=DetectorParams(**GLOO_DET), **CONFIG3)
    return kw, torch.stack(frames)


def worker(rank: int, world: int, port: int) -> None:
    """Rank ``rank`` of ``world`` gloo processes: its GLOO_SEQ / world
    sequences of a ``data`` axis through the batched parallel step, every
    output printed as one JSON line."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from aprilslam_tpu_torch.parallel import initialize_distributed, make_mesh_2d

    initialize_distributed(f"localhost:{port}", num_processes=world, process_id=rank, platform="cpu")
    try:
        mesh = make_mesh_2d(n_data=GLOO_SEQ, n_lm=1, device="cpu")
        per = mesh.local_size("data")
        kw, frames = _gloo_problem()
        pstep, init_states, shard = build_parallel_slam(mesh, **kw)
        _states, o = pstep(init_states(), shard(frames[rank * per:(rank + 1) * per]))
        print(json.dumps({"rank": rank, "local": per, **{f.name: getattr(o, f.name).tolist() for f in fields(o)}}),
              flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def test_two_process_gloo_equals_each_sequence_alone():
    """Two gloo ranks of a 4-sequence data axis, two sequences each: the
    batched step's front end runs over a rank's own 2 x B frames, and every
    output of each sequence equals its own step's (tests/test_torch_multihost.py's
    process harness)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", "2",
                               "--port", str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WALL_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{out}"
    res = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]) for out in outs]
    kw, frames = _gloo_problem()
    step, init = build_slam_step(device="cpu", **kw)
    for r, got in enumerate(res):
        assert got["rank"] == r and got["local"] == GLOO_SEQ // 2
        for i in range(got["local"]):
            _st, one = step(init(), frames[r * got["local"] + i])
            assert one.valid.any()
            for f in fields(SlamOutputs):
                want = getattr(one, f.name)
                g = torch.tensor(got[f.name][i], dtype=want.dtype)
                assert torch.equal(g, want), (r, i, f.name)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    a = ap.parse_args()
    worker(a.rank, a.world, a.port)
