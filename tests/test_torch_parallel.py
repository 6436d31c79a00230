"""The port's landmark-sharded BA, meshes and multi-sequence SLAM against
the JAX package's, on tests/test_parallel.py's inputs carried across as
numpy."""

import os
import sys
import warnings
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams as JaxDetectorParams
from aprilslam_tpu.geometry import PinholeCamera as JaxCamera
from aprilslam_tpu.parallel import build_distributed_ba as jax_build
from aprilslam_tpu.parallel import build_parallel_slam as jax_parallel_slam
from aprilslam_tpu.parallel import make_mesh as jax_mesh
from aprilslam_tpu.parallel import make_mesh_2d as jax_mesh_2d
from aprilslam_tpu.parallel import shard_observations_by_owner as jax_shard
from aprilslam_tpu.parallel import stack_ba_states as jax_stack
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu.slam.ba import ba_cost as jax_ba_cost
from aprilslam_tpu_torch.convert import ba_state_from_jax_numpy
from aprilslam_tpu_torch.detect import DetectorParams
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.parallel import (
    build_distributed_ba,
    build_parallel_slam,
    make_mesh,
    make_mesh_2d,
    replicated,
    shard_leading,
    shard_observations_by_owner,
    stack_ba_states,
)
from aprilslam_tpu_torch.slam import build_slam_step
from aprilslam_tpu_torch.slam.ba import BAState, ba_cost

sys.path.insert(0, os.path.dirname(__file__))
from test_ba import build_state, world  # noqa: E402,F401  (fixtures)

TAG = 10.0
DET = dict(quad_decimate=1, max_quads=16, max_detections=8, max_clusters=64,
           pts_per_quad=64, min_cluster_pts=8, min_side=2.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy(state) -> dict:
    return {f.name: np.array(getattr(state, f.name)) for f in fields(state)}


def _port(state) -> BAState:
    return ba_state_from_jax_numpy(_numpy(state), device="cpu")


@pytest.fixture(scope="module")
def jax_states(world):  # noqa: F811
    """tests/test_parallel.py's noisy states, built by JAX (seeds 0 and 1)."""
    with jax.enable_x64(False):
        return [build_state(world, noise=0.5, pose_noise=0.02, seed=s) for s in range(2)]


@pytest.fixture(scope="module")
def Kmat(world):  # noqa: F811
    return np.array(world[0].matrix, np.float32)


@pytest.mark.parametrize("n_shards,fit", [(8, False), (8, True), (4, False), (2, True)])
def test_shard_observations_match_jax(jax_states, n_shards, fit):
    with jax.enable_x64(False):
        want = _numpy(jax_shard(jax_states[0], n_shards, fit=fit))
    got = shard_observations_by_owner(_port(jax_states[0]), n_shards, fit=fit)
    for name in ("obs_kf", "obs_lm", "obs_uv", "obs_ok"):
        g = getattr(got, name).numpy()
        assert g.dtype == want[name].dtype, name
        np.testing.assert_array_equal(g, want[name], err_msg=name)


def test_overflow_emits_warning(jax_states):
    """tests/test_parallel.py's overflow: every observation on landmark 0's
    shard; the port warns with JAX's message and the dropped count."""
    st = _port(jax_states[0])
    st_bad = replace(st, obs_lm=torch.zeros_like(st.obs_lm))
    n_valid, per = int(st_bad.obs_ok.sum()), st.n_obs_capacity // 8
    assert n_valid > per
    with jax.enable_x64(False), warnings.catch_warnings(record=True) as rec_j:
        warnings.simplefilter("always")
        jax_shard(replace(jax_states[0], obs_lm=jnp.zeros_like(jax_states[0].obs_lm)), 8)
    with warnings.catch_warnings(record=True) as rec_t:
        warnings.simplefilter("always")
        shard_observations_by_owner(st_bad, 8)
    got = [str(r.message) for r in rec_t if r.category is RuntimeWarning]
    want = [str(r.message) for r in rec_j if r.category is RuntimeWarning]
    assert got == want and len(got) == 1, (got, want)
    assert "DROPPED" in got[0] and str(n_valid - per) in got[0]


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_distributed_matches_jax(jax_states, Kmat, n_shards):
    """10 iterations landmark-sharded: the port's cost lands within 5 % of
    JAX's 8-device cost (and of every other shard count), below half the
    start, and the returned cost is the last candidate's."""
    with jax.enable_x64(False):
        st = jax_states[0]
        c0 = float(jax_ba_cost(st, jnp.asarray(Kmat), TAG))
        out_j, _ = jax_build(jax_mesh(8, axis="lm"), 8, 8, 128, TAG, iters=10)(jax_shard(st, 8), jnp.asarray(Kmat))
        c_jax = float(jax_ba_cost(out_j, jnp.asarray(Kmat), TAG))
    K = torch.as_tensor(Kmat)
    st_t = shard_observations_by_owner(_port(st), n_shards)
    assert abs(float(ba_cost(st_t, K, TAG)) - c0) <= 1e-3 * c0  # same obs, reordered
    out, cost = build_distributed_ba(make_mesh(n_shards, axis="lm", device="cpu"), 8, 8, 128, TAG,
                                     iters=10)(st_t, K)
    c1 = float(ba_cost(out, K, TAG))
    assert np.isfinite(out.kf_pose.numpy()).all() and np.isfinite(out.lm_pose.numpy()).all()
    assert c1 < 0.5 * c0, (c0, c1)
    assert abs(c1 - c_jax) <= 0.05 * c_jax, (c1, c_jax)
    assert isinstance(cost, float) and abs(cost - c1) <= 0.05 * c1, (cost, c1)


def test_data_by_lm_mesh(jax_states, Kmat):
    """2-D mesh, 2 sequences x 4 landmark shards: each sequence converges,
    and its cost is within 5 % of JAX's on the same mesh shape."""
    K = torch.as_tensor(Kmat)
    with jax.enable_x64(False):
        stacked = jax_stack([jax_shard(s, 4) for s in jax_states])
        run_j = jax_build(jax_mesh_2d(n_data=2, n_lm=4), 8, 8, 128, TAG, axis="lm", iters=10, data_axis="data")
        _out_j, costs_j = run_j(stacked, jnp.asarray(Kmat))
    stacked_t = stack_ba_states([shard_observations_by_owner(_port(s), 4) for s in jax_states])
    # The stacked JAX state carried across equals the port's own stacking.
    carried = ba_state_from_jax_numpy(_numpy(stacked), device="cpu")
    for f in fields(BAState):
        np.testing.assert_array_equal(getattr(carried, f.name).numpy(), getattr(stacked_t, f.name).numpy())
    mesh = make_mesh_2d(n_data=2, n_lm=4, device="cpu")
    assert mesh.shape == {"data": 2, "lm": 4} and mesh.local_size("data") == 2
    out, costs = build_distributed_ba(mesh, 8, 8, 128, TAG, axis="lm", iters=10, data_axis="data")(stacked_t, K)
    assert costs.shape == (2,)
    np.testing.assert_allclose(costs, np.asarray(costs_j), rtol=0.05)
    for s in range(2):
        one = BAState(**{f.name: getattr(out, f.name)[s] for f in fields(BAState)})
        c0 = float(ba_cost(_port(jax_states[s]), K, TAG))
        assert float(ba_cost(one, K, TAG)) < 0.5 * c0


def test_mesh_helpers():
    mesh = make_mesh(4, axis="kf", device="cpu")
    assert mesh.shape == {"kf": 4} and mesh.backend == "stacked" and mesh.local_size("kf") == 4
    x = shard_leading(mesh, np.arange(8).reshape(8, 1), axis="kf")
    assert tuple(x.shape) == (4, 2, 1) and x.device.type == "cpu"
    assert replicated(mesh, np.ones(3)).device.type == "cpu"
    assert make_mesh(device="cpu").shape == {"data": 1}  # one shard per visible device
    with pytest.raises(ValueError):
        shard_leading(mesh, np.zeros((6, 2)), axis="kf")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)


def _line_frames(ends):
    """JAX-rendered 128x128 frames of one scripted line per sequence;
    ``ends`` lists each sequence's (start, end, frames)."""
    with jax.enable_x64(False):
        cfg = SceneConfig.from_file()
        cam = JaxCamera.from_fov(128, 128, cfg.fov_y)
        scene = scene_tensors(cfg)
        frames = []
        for a, b, n in ends:
            tr = trajectory.scripted_line(n, np.array(a), np.array(b))
            frames.append(np.asarray(render_frames(scene, jnp.asarray(tr.positions), jnp.asarray(tr.rotations),
                                                   jnp.asarray(cam.inv_matrix), 128, 128, 1)))
    return cfg, np.stack(frames)


def test_independent_sequences():
    """tests/test_parallel.py:68-106: 8 sequences x 2 frames at 128x128,
    chain_avg. The parallel step equals each sequence's own step exactly;
    against JAX's build_parallel_slam its integers are equal and its poses
    within 0.05 su (refined corners agree to 0.1 px, ROADMAP § 3)."""
    S, B = 8, 2
    cfg, frames = _line_frames([([s * 1.0, 0, 22.0], [s * 1.0 + 2, 0, 15.0], B) for s in range(S)])
    with jax.enable_x64(False):
        jstep, jinit, jshard = jax_parallel_slam(
            jax_mesh(8, axis="data"), cfg.family, JaxCamera.from_fov(128, 128, cfg.fov_y), cfg.tag_size_inner,
            detector_params=JaxDetectorParams(**DET), estimator="chain_avg", graph_capacity=16)
        _jst, jo = jstep(jinit(), jshard(jnp.asarray(frames)))
    cam = PinholeCamera.from_fov(128, 128, cfg.fov_y)
    kw = dict(detector_params=DetectorParams(**DET), estimator="chain_avg", graph_capacity=16)
    pstep, init_states, shard = build_parallel_slam(make_mesh(S, device="cpu"), cfg.family, cam,
                                                    cfg.tag_size_inner, **kw)
    states, outs = pstep(init_states(), shard(frames))
    assert tuple(outs.n_nodes.shape) == (S, B) and len(states) == S
    step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, device="cpu", **kw)
    for s in range(S):
        _st, one = step(init(), torch.as_tensor(frames[s]))
        for f in fields(one):
            assert torch.equal(getattr(outs, f.name)[s], getattr(one, f.name)), (s, f.name)
    for name in ("n_nodes", "valid", "coord_id", "det_ids", "det_ok"):
        np.testing.assert_array_equal(getattr(outs, name).numpy(), np.asarray(getattr(jo, name)), err_msg=name)
    assert (outs.n_nodes[:, -1] >= 1).all() and outs.valid.any(1).all()
    v = outs.valid.numpy()
    assert np.abs(outs.poses.numpy() - np.asarray(jo.poses))[v].max() <= 0.05


def test_production_composition_pgo():
    """The production step (chunk BA, camera and landmark pose graphs,
    pgo=True) per sequence: two sequences, two chunks each, so the
    chunk-boundary solve runs; poses finite and each sequence's pose-graph
    frame counter at 2 chunks x B."""
    S, B = 2, 2
    cfg, frames = _line_frames([([s * 0.5, 0, 24.0], [s * 0.5 + 2, 1, 17.0], B) for s in range(S)])
    cam = PinholeCamera.from_fov(128, 128, cfg.fov_y)
    pstep, init_states, shard = build_parallel_slam(
        make_mesh(S, device="cpu"), cfg.family, cam, cfg.tag_size_inner,
        detector_params=DetectorParams(**DET), estimator="ba", graph_capacity=16, ba_schedule="chunk",
        ba_chunk_iters=2, init_joint_iters=2, pnp_iters=3, pgo=True, pgo_nodes=16, pgo_edges=48)
    states = init_states()
    fr = shard(frames)
    for _ in range(2):
        states, outs = pstep(states, fr)
    assert torch.isfinite(outs.poses).all()
    assert (outs.n_nodes[:, -1] >= 1).all()
    assert [int(st[2].frame) for st in states] == [2 * B] * S
    with pytest.raises(ValueError, match="expected 2"):
        pstep(states[:1], fr)
