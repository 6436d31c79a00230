"""Port parity: the SLAM step under every estimator and schedule, with and
without the loop-closure back end, against the JAX package.

Each configuration runs both packages over the same rendered chunks from
their initial states; the outputs are compared chunk by chunk as in
``test_torch_slam.py`` (integers and flags exactly, poses to a tolerance).
Every later chunk is also run by the port from the JAX package's own state
after the chunk before, carried across by ``convert.py``, so float drift
cannot compound. The pose-graph cases run an out-and-back trajectory on
which the JAX side mints loop edges (asserted, so the path is exercised).

The port's step is given the detections the JAX step itself made
(``det_ids``/``det_corners`` of its outputs). The detectors agree to 0.1 px
(``test_torch_detect.py``, ``test_torch_slam.py``), but on a small, distant
tag 0.1 px can swap the planar-PnP branch, and each back end trusts the PnP
branch somewhere (the chain estimators always, the loop edges when it is
"reliable"): a swap moves a pose by units. The back end is what these
options change, so it is held to the JAX one on the same detections. The
chain estimators run a camera that looks at the tags obliquely, where the
two PnP branches do not tie.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams
from aprilslam_tpu.geometry import PinholeCamera
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu.slam import build_slam_step
from aprilslam_tpu_torch import detect as TD
from aprilslam_tpu_torch import geometry as TG
from aprilslam_tpu_torch import slam as TS
from aprilslam_tpu_torch.convert import state_from_jax_numpy

RES, B = 384, 4
BASE = dict(graph_capacity=16, ba_keyframes=16, ba_obs=512, init_joint_iters=3, ba_chunk_iters=4,
            pnp_iters=3)
PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
OUT_INTS = ("valid", "coord_id", "n_visible", "n_nodes", "loc_used", "node_visible",
            "det_ids", "det_ok", "loop_closures")
# Out and back along the tag row: tags 0 and 1 drop out of view for more than
# pgo_loop_gap frames and are re-observed on the way back.
OUT_AND_BACK = np.array([[0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [0.0, 0.0, 10.0]])
OBLIQUE = [10.0, 15.0, 0.0]  # camera [pitch, yaw, roll], degrees
# case: (step options, trajectory, chunks, pose tolerance in scene units).
# The tolerance is what float32 allows where the pose comes from an LM:
# the joint estimator's 6 GN steps stop short along depth-coupled
# directions with tags ~100 units away (ROADMAP.md, section 3), and on the
# out-and-back path the JAX step itself moves 0.003 (chunk schedule) and
# 0.039 units (frame schedule) when the focal length changes by 1e-6 of
# itself.
CASES = {
    "reference_chain": (dict(estimator="reference_chain"), "oblique", 2, 2e-3),
    "chain_avg": (dict(estimator="chain_avg"), "oblique", 2, 2e-3),
    "joint": (dict(estimator="joint"), "oblique", 2, 2e-2),
    "ba_frame": (dict(estimator="ba", ba_schedule="frame"), "out_and_back", 3, 5e-2),
    "ba_chunk_pgo": (dict(estimator="ba", ba_schedule="chunk", pgo=True, pgo_loop_gap=4),
                     "out_and_back", 6, 1e-2),
    "ba_frame_pgo": (dict(estimator="ba", ba_schedule="frame", pgo=True, pgo_loop_gap=4),
                     "out_and_back", 6, 5e-2),
}


def jax_to_numpy(state):
    """A JAX step state as the numpy dicts ``convert.py`` takes."""
    if dataclasses.is_dataclass(state):
        return {f.name: jax_to_numpy(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, tuple):
        return tuple(jax_to_numpy(s) for s in state)
    return np.asarray(state)


def carried(state_np):
    if isinstance(state_np, tuple):
        return state_from_jax_numpy(*state_np, device="cpu")
    return state_from_jax_numpy(state_np, device="cpu")


@pytest.fixture(scope="module")
def frames():
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    back = trajectory.scripted_waypoints(6 * B, OUT_AND_BACK)
    line = trajectory.scripted_line(2 * B, np.array([0.0, 0.0, 20.0]), np.array([8.0, 2.0, -10.0]))
    trajs = {
        "out_and_back": (back.positions, back.rotations),
        "oblique": (line.positions, np.tile(np.array(OBLIQUE, np.float32), (2 * B, 1))),
    }
    u8 = {}
    with jax.enable_x64(False):
        for name, (pos, rot) in trajs.items():
            f = render_frames(scene_tensors(cfg), jnp.asarray(pos), jnp.asarray(rot),
                              jnp.asarray(cam.inv_matrix), RES, RES, 2)
            u8[name] = np.asarray(jnp.clip(f * 255.0, 0, 255).astype(jnp.uint8))
    return SimpleNamespace(cfg=cfg, cam=cam, u8=u8)


def replayed_detector(j_outs, u8):
    """A stand-in for the port's ``detect_fn`` that returns, for each chunk
    of ``u8``, the detections the JAX step made on it."""
    by_chunk = {}
    for c, o in enumerate(j_outs):
        ids = torch.as_tensor(np.asarray(o.det_ids))
        by_chunk[u8[c * B:(c + 1) * B].tobytes()] = TD.Detections(
            ids=ids, corners=torch.as_tensor(np.asarray(o.det_corners)), valid=ids >= 0,
            hamming=torch.zeros_like(ids), margin=torch.zeros(ids.shape),
            homography=torch.zeros(ids.shape + (3, 3)))

    def make(*_args, **_kwargs):
        return lambda frames: by_chunk[frames.numpy().tobytes()]

    return make


def run_both(frames, kwargs, traj, n_chunks, monkeypatch):
    cfg, cam, u8 = frames.cfg, frames.cam, frames.u8[traj]
    with jax.enable_x64(False):
        step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=PARAMS,
                                     **BASE, **kwargs)
        step = jax.jit(step)
        state = init()
        j_outs, j_states = [], []
        for c in range(n_chunks):
            state, o = step(state, jnp.asarray(u8[c * B:(c + 1) * B]))
            j_outs.append(jax.device_get(o))
            j_states.append(jax_to_numpy(state))
    monkeypatch.setattr(TS.pipeline, "detect_fn", replayed_detector(j_outs, u8))
    tstep, tinit = TS.build_slam_step(cfg.family, TG.PinholeCamera(**cam.__dict__), cfg.tag_size_inner,
                                      detector_params=TD.DetectorParams(**PARAMS.__dict__),
                                      device="cpu", **BASE, **kwargs)
    tstate, t_outs, t_carried = tinit(), [], [None]
    for c in range(n_chunks):
        chunk = torch.from_numpy(u8[c * B:(c + 1) * B].copy())
        tstate, o = tstep(tstate, chunk)
        t_outs.append(o)
        if c:
            t_carried.append(tstep(carried(j_states[c - 1]), chunk))
    return SimpleNamespace(j_outs=j_outs, j_states=j_states, t_outs=t_outs, t_carried=t_carried,
                           t_state=tstate)


def compare_outputs(got, want, atol, frames_after_closure=False):
    """Integers and flags exactly; poses, rms and observability to a
    tolerance. With ``frames_after_closure`` (the frame schedule's inline
    pose-graph solve), frames after the first loop closure are held to the
    integers and to finite poses only: each inline solve re-solves the whole
    graph from PnP loop edges, and a PnP branch tie that the reference
    counts as reliable swaps an edge by units on round-off (ROADMAP.md,
    section 3)."""
    for k in OUT_INTS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    m = np.ones(len(want.poses), bool)
    if frames_after_closure:
        m = np.asarray(want.loop_closures) == 0
        assert np.isfinite(got.poses.numpy()[np.asarray(want.valid)]).all()
    np.testing.assert_allclose(got.poses.numpy()[m], want.poses[m], atol=atol, rtol=2e-4)
    np.testing.assert_allclose(got.reproj_rms.numpy()[m], want.reproj_rms[m], atol=5e-3)
    # float32 eigvalsh resolves sigma_min only to ~eps * lambda_max
    # (ROADMAP.md, section 3), a few hundredths here.
    np.testing.assert_allclose(got.pose_obs.numpy()[m], want.pose_obs[m], rtol=0.1, atol=5e-2)
    np.testing.assert_allclose(got.avg_node_distance.numpy(), want.avg_node_distance, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_options_parity(frames, case, monkeypatch):
    kwargs, traj, n_chunks, atol = CASES[case]
    r = run_both(frames, kwargs, traj, n_chunks, monkeypatch)
    inline_solve = kwargs.get("pgo", False) and kwargs.get("ba_schedule") == "frame"
    for c in range(n_chunks):
        compare_outputs(r.t_outs[c], r.j_outs[c], atol, inline_solve)
        if c:
            state, out = r.t_carried[c]
            compare_outputs(out, r.j_outs[c], atol, inline_solve)
            want = r.j_states[c]
            if isinstance(want, tuple):
                for k in ("kf_active", "kf_ptr", "lm_active", "obs_ok", "anchor", "frame_count"):
                    np.testing.assert_array_equal(getattr(state[1], k).numpy(), want[1][k], err_msg=k)
            if kwargs.get("pgo"):
                for k in ("node_active", "node_ptr", "edge_ptr", "kf_node", "lm_node", "lm_ref",
                          "n_loops", "n_solved"):
                    np.testing.assert_array_equal(getattr(state[2], k).numpy(), want[2][k], err_msg=k)
                np.testing.assert_array_equal(state[3].count.numpy(), want[3]["count"])
    if kwargs.get("pgo"):
        assert int(np.asarray(r.j_outs[-1].loop_closures)[-1]) >= 1, "no loop edge: the path is idle"
    if kwargs["estimator"] == "ba":
        assert len(r.t_state) == (4 if kwargs.get("pgo") else 2)
    else:
        assert isinstance(r.t_state, TS.GraphState)


def test_zero_distortion_is_the_pinhole_step(frames):
    """dist_coeffs of zeros leave every output of the step unchanged."""
    cfg, cam = frames.cfg, TG.PinholeCamera(**frames.cam.__dict__)
    tparams = TD.DetectorParams(**PARAMS.__dict__)
    chunk = torch.from_numpy(frames.u8["out_and_back"][:B].copy())
    outs = []
    for dist in (None, np.zeros(5, np.float32)):
        step, init = TS.build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=tparams,
                                        device="cpu", estimator="ba", ba_schedule="chunk",
                                        dist_coeffs=dist, **BASE)
        outs.append(step(init(), chunk)[1])
    for k in ("det_ids", "det_corners", "poses", "valid", "reproj_rms"):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k


def test_defaults_match_the_jax_package():
    import inspect

    from aprilslam_tpu.slam import pipeline as JP

    want = inspect.signature(JP.build_slam_step).parameters
    got = inspect.signature(TS.build_slam_step).parameters
    assert set(want) <= set(got)
    for name, p in want.items():
        assert got[name].default == p.default, name
    want_sys = inspect.signature(JP.SlamSystem.__init__).parameters
    got_sys = inspect.signature(TS.SlamSystem.__init__).parameters
    for name, p in want_sys.items():
        assert name in got_sys and got_sys[name].default == p.default, name
