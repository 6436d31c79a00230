"""BASELINE config 3 as a camera fleet, on the CPU: S streams flying the
scripted loop from staggered phases (``perfbench/pools/fleet_loop.py``)
through the port's ``parallel_step`` (``parallel/sequences.py``).

* The fleet pool's layout: call k, stream s, frame b of the stream's chunk
  is loop frame ``(B k + b + P s) mod L``.
* ``parallel_step`` over the staggered loop against S separate
  ``SlamSystem`` sessions fed the same frames, and against the JAX
  package's ``jax.jit(jax.vmap(step))`` on the same frames.
* ``tools/probe_fleet_drift.py``, which judges one stream of the fleet
  deployment under both packages' steps, at a small size.
* The step's spans: one call opens ``slam.fleet``, ``slam.fleet.front``
  and ``slam.front`` once each and ``slam.back`` once a stream, and
  recording them changes no output.
"""

import importlib.util
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams as JaxDetectorParams
from aprilslam_tpu.geometry import PinholeCamera as JaxCamera
from aprilslam_tpu.slam import build_slam_step as jax_build_slam_step
from aprilslam_tpu_torch.detect import DetectorParams
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.parallel import build_parallel_slam, make_mesh
from aprilslam_tpu_torch.slam import SlamSystem
from aprilslam_tpu_torch.utils.profiling import SpanRecorder
from perfbench import harness
from perfbench.inputs import scene as scene_mod
from perfbench.inputs.render import render_u8

# tests/test_torch_multiseq.py's resolution and tolerance on poses, and
# bench.py's config-3 step with its headline detector.
RES, S, B, N_CALLS = 256, 3, 4, 2
POSE_TOL = 2e-2
# The port's step against the JAX package's on the loop. Measured: poses
# 0.0241 su, maps 0.0138 su in their lowest landmark's frame (each map's
# world frame differs by a gauge: 0.167 su elementwise). The cameras stand
# about 59 su from their tags, where one pixel at 256 px spans about 0.2 su;
# at 1000 px the two steps' poses differ by up to 0.031 su as well.
JAX_TOL = 5e-2
HEADLINE = dict(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
CONFIG3 = dict(estimator="ba", ba_schedule="chunk", init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3,
               graph_capacity=16)
POOL = {"kind": "fleet_loop", "frames": S * 96, "streams": S, "loop_frames": 96, "phase": 12, "chunk": B}
JAX_INTS = ("det_ids", "det_ok", "valid", "coord_id", "n_nodes")
INTS = ("det_ids", "det_ok", "valid", "coord_id", "n_nodes", "n_visible", "loop_closures", "loc_used")
POOLS = harness.load("pools", "fleet_loop")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("pool", [harness.traffic("fleet_loop")["pool"], POOL], ids=["cell", "small"])
def test_the_pool_staggers_each_stream_along_the_loop(pool):
    """Pool position ``S B k + B s + b`` holds loop frame ``(B k + b + P s)
    mod L``, with the loop's own pose; a call's S chunks do not overlap."""
    n, Sp, L, P, Bp = (pool[k] for k in ("frames", "streams", "loop_frames", "phase", "chunk"))
    pos, rot = POOLS.poses(pool, 2**31 + 5)
    loop_pos, loop_rot = scene_mod.scripted_waypoints(L, scene_mod.LOOP_WAYPOINTS)
    assert pos.shape == rot.shape == (n, 3)
    for k in range(L // Bp):
        for s in range(Sp):
            for b in range(Bp):
                p = Sp * Bp * k + Bp * s + b
                f = (Bp * k + b + P * s) % L
                np.testing.assert_array_equal(pos[p], loop_pos[f])
                np.testing.assert_array_equal(rot[p], loop_rot[f])
    per_call = POOLS.layout(pool).reshape(L // Bp, Sp * Bp)
    assert all(len(set(c)) == Sp * Bp for c in per_call)


def test_a_pool_that_does_not_hold_every_stream_whole_is_refused():
    with pytest.raises(ValueError):
        POOLS.layout({**POOL, "frames": S * 96 - 4})
    with pytest.raises(ValueError):
        POOLS.layout({**POOL, "chunk": 5})


@pytest.fixture(scope="module")
def fleet():
    """(camera, scene, frames (N_CALLS, S, B, RES, RES) uint8): the small
    pool's first calls, rendered by the benchmark's rasterizer."""
    raw = harness.load_json(harness.HERE / "inputs" / "default_scene.json")
    sc = scene_mod.Scene(raw)
    K = scene_mod.intrinsics(RES, RES, float(raw["fov_y"]))
    pos, rot = POOLS.poses(POOL, 0)
    n = N_CALLS * S * B
    frames = render_u8(sc, pos[:n], rot[:n], K, RES, RES, torch.device("cpu"))
    cam = PinholeCamera.from_fov(RES, RES, float(raw["fov_y"]))
    return cam, sc, frames.reshape(N_CALLS, S, B, RES, RES)


@pytest.fixture(scope="module")
def fleet_outputs(fleet):
    """The port's ``parallel_step`` outputs and states after each call."""
    cam, sc, frames = fleet
    pstep, init_states, shard = _parallel(cam, sc)
    states, outs = init_states(), []
    for k in range(N_CALLS):
        states, o = pstep(states, shard(frames[k]))
        outs.append((states, o))
    return outs


def _parallel(cam, sc):
    return build_parallel_slam(make_mesh(S, device="cpu"), sc.family, cam, sc.tag_size_inner,
                               detector_params=DetectorParams(**HEADLINE), **CONFIG3)


def test_parallel_step_equals_each_stream_alone(fleet, fleet_outputs):
    """S staggered streams, N_CALLS calls: every output of stream s equals
    its own ``SlamSystem`` session fed the same chunks (integers exactly,
    poses within POSE_TOL), and so does its state's landmark map."""
    cam, sc, frames = fleet
    states, outs = fleet_outputs[-1][0], [o for _, o in fleet_outputs]
    assert all(bool(o.valid.any()) for o in outs), "no valid pose: the comparison is idle"
    for s in range(S):
        system = SlamSystem(cam, sc.family, sc.tag_size_inner, detector_params=DetectorParams(**HEADLINE),
                            device="cpu", **CONFIG3)
        for k in range(N_CALLS):
            one = system.process(frames[k, s])
            for name in INTS:
                assert torch.equal(getattr(outs[k], name)[s], getattr(one, name)), (s, k, name)
            v = one.valid
            torch.testing.assert_close(outs[k].poses[s][v], one.poses[v], rtol=0, atol=POSE_TOL)
            for f in fields(one):
                assert getattr(outs[k], f.name)[s].shape == getattr(one, f.name).shape, (s, k, f.name)
        assert torch.equal(states[s][1].lm_active, system.ba_state.lm_active), s
        torch.testing.assert_close(states[s][1].lm_pose, system.ba_state.lm_pose, rtol=0, atol=POSE_TOL)


def test_parallel_step_matches_the_jax_step_on_the_staggered_loop(fleet, fleet_outputs):
    """The JAX package's config-3 step, ``jax.jit(jax.vmap(step))``, on the
    same staggered frames: integers equal, poses within JAX_TOL on valid
    frames, and each stream's landmark map, in the frame of its lowest
    active landmark (the gauge the benchmark's judge reads it in), within
    JAX_TOL."""
    cam, sc, frames = fleet
    with jax.enable_x64(False):
        jstep, jinit = jax_build_slam_step(sc.family, JaxCamera.from_fov(RES, RES, float(sc.raw["fov_y"])),
                                           sc.tag_size_inner, detector_params=JaxDetectorParams(**HEADLINE),
                                           **CONFIG3)
        step_v = jax.jit(jax.vmap(jstep))
        jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *[jinit() for _ in range(S)])
        want = []
        for k in range(N_CALLS):
            jstates, o = step_v(jstates, jnp.asarray(frames[k].numpy()))
            want.append((np.asarray(jstates[1].lm_active), np.asarray(jstates[1].lm_pose), jax.device_get(o)))
    for k, ((states, got), (lm_active, lm_pose, o)) in enumerate(zip(fleet_outputs, want)):
        for name in JAX_INTS:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(o, name)),
                                          err_msg=f"{k} {name}")
        v = got.valid.numpy()
        np.testing.assert_allclose(got.poses.numpy()[v], np.asarray(o.poses)[v], rtol=0, atol=JAX_TOL)
        active = np.stack([st[1].lm_active.numpy() for st in states])
        np.testing.assert_array_equal(active, lm_active, err_msg=f"{k} lm_active")
        mine = np.stack([st[1].lm_pose.numpy() for st in states])
        for s in range(S):
            a = np.flatnonzero(active[s])
            np.testing.assert_allclose(np.linalg.inv(mine[s, a[0]]) @ mine[s, a],
                                       np.linalg.inv(lm_pose[s, a[0]]) @ lm_pose[s, a], rtol=0, atol=JAX_TOL,
                                       err_msg=f"{k} stream {s}'s map")


def test_the_drift_probe_runs_both_steps_on_one_stream_and_judges_them_alike():
    """The probe at 256 px on the randomized scene: stream 1's first two
    chunks of 4 under the port's step and the JAX package's, with equal
    integers, poses within JAX_TOL and judged numbers within JAX_TOL."""
    spec = importlib.util.spec_from_file_location("probe_fleet_drift", ROOT / "tools" / "probe_fleet_drift.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    r = probe.compare(2**31 + 5, 1, RES, B, 2 * B)
    assert r["loop_frames"] == list(range(12, 12 + 2 * B))
    assert all(r["ints_equal"].values()), r["ints_equal"]
    assert r["port"]["valid"].any(), "no valid pose: the comparison is idle"
    assert r["pose_gap_su"] <= JAX_TOL
    for k in ("ate_su", "map_rms_su"):
        assert abs(r["port"]["nums"][k] - r["jax"]["nums"][k]) <= JAX_TOL, (k, r["port"]["nums"], r["jax"]["nums"])


def test_one_call_opens_the_fleet_spans_and_one_back_end_span_a_stream(fleet):
    cam, sc, frames = fleet
    pstep, init_states, shard = _parallel(cam, sc)
    with SpanRecorder() as rec:
        pstep(init_states(), shard(frames[0]))
    summary = rec.summary()
    calls = {name: v["calls"] for name, v in summary.items()}
    assert calls["slam.fleet"] == calls["slam.fleet.front"] == calls["slam.fleet.back"] == 1
    assert calls["slam.front"] == 1 and calls["slam.back"] == S
    assert summary["slam.fleet"]["parent"] is None
    assert summary["slam.fleet.front"]["parent"] == summary["slam.fleet.back"]["parent"] == "slam.fleet"
    assert summary["slam.front"]["parent"] == "slam.fleet.front"
    assert summary["slam.back"]["parent"] == "slam.fleet.back"
    assert "slam.step" not in calls


def test_recording_the_spans_changes_no_output(fleet):
    cam, sc, frames = fleet
    pstep, init_states, shard = _parallel(cam, sc)
    plain = [init_states(), None]
    recorded = [init_states(), None]
    for k in range(N_CALLS):
        plain[0], plain[1] = pstep(plain[0], shard(frames[k]))
        with SpanRecorder():
            recorded[0], recorded[1] = pstep(recorded[0], shard(frames[k]))
        for f in fields(plain[1]):
            torch.testing.assert_close(getattr(recorded[1], f.name), getattr(plain[1], f.name), rtol=0, atol=0,
                                       equal_nan=True, msg=lambda m, k=k, f=f: f"{k} {f.name}: {m}")
