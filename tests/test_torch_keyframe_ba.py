"""The port's keyframe-axis sharded BA against the JAX package's, on the
same problem built by the JAX synthesizer and carried across as numpy."""

from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

from aprilslam_tpu.parallel import build_keyframe_ba as jax_build
from aprilslam_tpu.parallel import keyframe_ba_cost as jax_cost
from aprilslam_tpu.parallel import make_mesh as jax_mesh
from aprilslam_tpu.parallel import partition_obs_by_keyframe as jax_partition
from aprilslam_tpu.parallel import synthesize_trajectory_problem as jax_synth
from aprilslam_tpu_torch.convert import keyframe_problem_from_jax_numpy, problem_to_numpy
from aprilslam_tpu_torch.parallel import (
    KeyframeBAProblem,
    build_keyframe_ba,
    keyframe_ba_cost,
    make_mesh,
    partition_obs_by_keyframe,
    synthesize_trajectory_problem,
)
from aprilslam_tpu_torch.parallel.collectives import StackedAxis, gather, segment_sum

TAG = 10.0
ITERS, CG = 6, 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_numpy(prob) -> dict:
    return {f.name: np.asarray(getattr(prob, f.name)) for f in fields(KeyframeBAProblem)}


def _ate(poses, gt) -> float:
    e = np.asarray(poses)[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(e * e, axis=-1))))


@pytest.fixture(scope="module")
def problem():
    """tests/test_keyframe_ba.py's problem (256 keyframes, 16 tags, seed 3,
    partitioned for 8 shards), built by JAX, with JAX's 8-device solve."""
    with jax.enable_x64(False):
        jp, kf_gt, jK = jax_synth(n_keyframes=256, n_landmarks=16, n_shards=8, seed=3)
        O = int(jp.obs_kf.shape[0])
        j8, _ = jax_build(jax_mesh(8, axis="kf"), 256, 16, O, TAG, iters=ITERS, cg_iters=CG)(jp, jK)
        jax_costs = {"initial": float(jax_cost(jp, jK, TAG)), "refined8": float(jax_cost(j8, jK, TAG))}
    arrays = _jax_numpy(jp)
    return {"arrays": arrays, "refined8": _jax_numpy(j8), "gt": kf_gt, "K": np.array(jK),
            "jax_costs": jax_costs, "O": O}


@pytest.fixture(scope="module")
def solved(problem):
    prob = keyframe_problem_from_jax_numpy(problem["arrays"], device="cpu")
    K = torch.as_tensor(problem["K"])
    out = {}
    for n in (1, 8):
        run = build_keyframe_ba(make_mesh(n, axis="kf", device="cpu"), 256, 16, problem["O"], TAG,
                                iters=ITERS, cg_iters=CG)
        p, cost = run(prob, K)
        out[n] = (p, cost, float(keyframe_ba_cost(p, K, TAG)))
    return prob, K, out


def test_cost_matches_jax(problem):
    """keyframe_ba_cost on the JAX problem, initial and JAX-refined, equals
    JAX's to 1e-4 relative."""
    K = torch.as_tensor(problem["K"])
    for arrays, want in ((problem["arrays"], problem["jax_costs"]["initial"]),
                         (problem["refined8"], problem["jax_costs"]["refined8"])):
        got = float(keyframe_ba_cost(keyframe_problem_from_jax_numpy(arrays, device="cpu"), K, TAG))
        assert abs(got - want) <= 1e-4 * want, (got, want)


def test_sharded_cost_parity(problem, solved):
    """The 8-shard solve lands within 5 % of the port's 1-shard solve and
    of JAX's 8-device solve; both fall far below the drifted start; the
    returned cost is the refined problem's."""
    _prob, _K, out = solved
    c1, c8 = out[1][2], out[8][2]
    c0, j8 = problem["jax_costs"]["initial"], problem["jax_costs"]["refined8"]
    assert c1 < 0.05 * c0 and c8 < 0.05 * c0, (c0, c1, c8)
    assert abs(c8 - c1) <= 0.05 * c1, (c1, c8)
    assert abs(c8 - j8) <= 0.05 * j8, (c8, j8)
    for n in (1, 8):
        assert abs(out[n][1] - out[n][2]) <= 1e-4 * out[n][2], out[n][1:]


@pytest.mark.parametrize("n", [1, 8])
def test_removes_dead_reckoning_drift(problem, solved, n):
    """tests/test_keyframe_ba.py's bars on the drift the solve removes."""
    prob, _K, out = solved
    est = out[n][0].kf_pose.numpy()
    assert np.isfinite(est).all()
    ate_init, ate_opt = _ate(prob.kf_pose, problem["gt"]), _ate(est, problem["gt"])
    assert ate_init > 0.5, ate_init
    assert ate_opt < 0.3 * ate_init, (ate_init, ate_opt)
    assert ate_opt < 0.5, ate_opt


@pytest.mark.parametrize("n", [1, 8])
def test_gauge_keyframe_pinned(solved, n):
    prob, _K, out = solved
    d0 = (out[n][0].kf_pose[0] - prob.kf_pose[0]).abs().max().item()
    assert d0 < 1e-3, d0


def test_synthesizer_matches_jax(problem):
    """The port's synthesizer draws the JAX function's numbers in its order:
    integers and pixels equal; poses composed with the float32 se3_exp of
    each package agree to 1e-4 absolute."""
    prob, kf_gt, K = synthesize_trajectory_problem(256, 16, 8, seed=3, device="cpu")
    got = problem_to_numpy(prob)
    np.testing.assert_array_equal(kf_gt, problem["gt"])
    np.testing.assert_array_equal(K.numpy(), problem["K"])
    for name, want in problem["arrays"].items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        if name in ("kf_pose", "lm_pose", "odom_T"):
            np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("seed,n_shards", [(0, 1), (1, 4), (2, 8), (3, 3)])
def test_partition_matches_jax(seed, n_shards):
    rng = np.random.default_rng(seed)
    K, O = 24, 100
    obs = (rng.integers(0, K, O).astype(np.int32), rng.integers(0, 9, O).astype(np.int32),
           rng.normal(size=(O, 4, 2)).astype(np.float32), rng.random(O) < 0.8)
    want = jax_partition(*obs, K, n_shards)
    got = partition_obs_by_keyframe(*obs, K, n_shards)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_partition_ragged_split_raises():
    obs = (np.zeros(4, np.int32), np.zeros(4, np.int32), np.zeros((4, 4, 2), np.float32), np.ones(4, bool))
    with pytest.raises(ValueError) as want:
        jax_partition(*obs, 10, 4)
    with pytest.raises(ValueError) as got:
        partition_obs_by_keyframe(*obs, 10, 4)
    assert str(got.value) == str(want.value)
    assert "ragged split" in str(got.value)


def test_build_rejects_uneven_shards():
    with pytest.raises(ValueError, match="must divide"):
        build_keyframe_ba(make_mesh(3, axis="kf", device="cpu"), 256, 16, 1536, TAG)


def test_stacked_axis_collectives():
    """psum, the ring exchange and axis_index of two stacked problems of
    three shards each never mix the problems."""
    ax = StackedAxis(3, batch=2)
    x = torch.arange(6.0)[:, None] * torch.ones(1, 2)
    np.testing.assert_array_equal(ax.psum(x)[:, 0], [3, 3, 3, 12, 12, 12])
    np.testing.assert_array_equal(ax.from_right(x)[:, 0], [1, 2, 0, 4, 5, 3])
    np.testing.assert_array_equal(ax.from_left(x)[:, 0], [2, 0, 1, 5, 3, 4])
    np.testing.assert_array_equal(ax.axis_index(), [0, 1, 2, 0, 1, 2])
    idx = torch.tensor([[0, 2, 2], [1, 1, 0]])
    vals = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    np.testing.assert_array_equal(segment_sum(vals, idx, 3), [[1, 0, 5], [6, 9, 0]])
    np.testing.assert_array_equal(gather(torch.tensor([[7.0, 8.0, 9.0], [1.0, 2.0, 3.0]]), idx),
                                  [[7, 9, 9], [2, 2, 1]])
