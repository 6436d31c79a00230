"""Port parity: the rest of the simulator (orbit and random-walk trajectories,
ground-truth helpers, the corner oracle, render_sequence, degradations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.geometry import PinholeCamera
from aprilslam_tpu.sim import SceneConfig, degrade, ground_truth, project_border_corners, scene_tensors
from aprilslam_tpu.sim import trajectory
from aprilslam_tpu_torch import sim as TS
from aprilslam_tpu_torch.geometry import PinholeCamera as TCam
from aprilslam_tpu_torch.sim import degrade as TDG


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n,seed", [(1, 0), (17, 0), (64, 3), (200, 11)])
def test_orbit_and_random_walk_bit_equal(n, seed):
    for kw in ({}, {"yaw_tracking": False, "radius": 12.5, "sweep_deg": 270.0}):
        a, b = trajectory.orbit(n, **kw), TS.trajectory.orbit(n, **kw)
        np.testing.assert_array_equal(b.positions, a.positions)
        np.testing.assert_array_equal(b.rotations, a.rotations)
    a = trajectory.smooth_random_walk(n, seed=seed)
    b = TS.trajectory.smooth_random_walk(n, seed=seed)
    assert b.positions.dtype == a.positions.dtype == np.float32
    np.testing.assert_array_equal(b.positions, a.positions)
    np.testing.assert_array_equal(b.rotations, a.rotations)


def test_distance_helpers():
    rng = np.random.default_rng(1)
    tag_pos = rng.uniform(-40, 40, (7, 3)).astype(np.float32)
    cam_pos = rng.uniform(-40, 40, (3, 5, 3)).astype(np.float32)
    tp, cp = torch.as_tensor(tag_pos), torch.as_tensor(cam_pos)
    with jax.enable_x64(False):
        jtp, jcp = jnp.asarray(tag_pos), jnp.asarray(cam_pos)
        want = {
            "dist": np.asarray(ground_truth.tag_distances_from_camera(jtp, jcp)),
            "pair": float(ground_truth.tag_to_tag_distance(jtp, 2, 5)),
            "closest": [np.asarray(x) for x in ground_truth.closest_tag(jtp, jcp)],
            "visible": np.asarray(ground_truth.visibility_by_distance(jtp, jcp, 35.0)),
        }
    np.testing.assert_allclose(TS.tag_distances_from_camera(tp, cp).numpy(), want["dist"], rtol=1e-5)
    assert float(TS.tag_to_tag_distance(tp, 2, 5)) == pytest.approx(want["pair"], rel=1e-5)
    idx, d = TS.closest_tag(tp, cp)
    np.testing.assert_array_equal(idx.numpy(), want["closest"][0])
    np.testing.assert_allclose(d.numpy(), want["closest"][1], rtol=1e-5)
    np.testing.assert_array_equal(TS.visibility_by_distance(tp, cp, 35.0).numpy(), want["visible"])


def _occlusion_scene(seed):
    """The random scene of tests/test_sim.py's brute-force occlusion test."""
    rng = np.random.default_rng(seed)
    T, B = 6, 4
    tag_pos = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    tag_pos[:, 2] = rng.uniform(-5, 5, T)
    tag_rot = rng.uniform(-60, 60, (T, 3)).astype(np.float32)
    cam_pos = rng.uniform(-10, 10, (B, 3)).astype(np.float32)
    cam_pos[:, 2] += 40
    return tag_pos, tag_rot, cam_pos


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tags_unoccluded_exact(seed):
    tag_pos, tag_rot, cam_pos = _occlusion_scene(seed)
    with jax.enable_x64(False):
        want = np.asarray(ground_truth.tags_unoccluded(
            jnp.asarray(tag_pos), jnp.asarray(tag_rot), jnp.asarray(cam_pos), 5.0, 4.5))
    got = TS.tags_unoccluded(torch.as_tensor(tag_pos), torch.as_tensor(tag_rot),
                             torch.as_tensor(cam_pos), 5.0, 4.5)
    assert got.dtype == torch.bool and got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    if seed == 0:
        assert not want.all()  # the scene does hide a tag


def test_project_border_corners():
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(320, 240, cfg.fov_y)
    pos = np.array([[0.0, 0.0, 10.0], [10.0, 2.0, -20.0], [30.0, -3.0, -30.0]], np.float32)
    rot = np.array([[0.0, 0.0, 0.0], [5.0, -10.0, 3.0], [-4.0, 12.0, 0.0]], np.float32)
    with jax.enable_x64(False):
        uv, valid = project_border_corners(scene_tensors(cfg), jnp.asarray(pos), jnp.asarray(rot),
                                           jnp.asarray(cam.matrix))
        uv, valid = np.asarray(uv), np.asarray(valid)
    tuv, tvalid = TS.project_border_corners(
        TS.scene_tensors(TS.SceneConfig.from_file(), device="cpu"), pos, rot, cam.matrix)
    assert tuv.shape == (3, 5, 4, 2)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    np.testing.assert_allclose(tuv.numpy()[valid], uv[valid], atol=1e-3)


def test_render_sequence_is_render_frames_by_batch():
    cfg = TS.SceneConfig.from_file()
    cam = TCam.from_fov(96, 80, cfg.fov_y)
    traj = TS.trajectory.scripted_line(7, np.array([0.0, 0.0, 20.0]), np.array([8.0, 2.0, -10.0]))
    scene = TS.scene_tensors(cfg, device="cpu")
    got = list(TS.render_sequence(cfg, traj.positions, traj.rotations, camera=cam, batch=3,
                                  supersample=1, device="cpu"))
    assert len(got) == 2  # the trailing partial batch is dropped
    for k, frames in enumerate(got):
        want = TS.render_frames(scene, traj.positions[3 * k:3 * k + 3], traj.rotations[3 * k:3 * k + 3],
                                cam.inv_matrix, 80, 96, 1, device="cpu")
        assert frames.device.type == "cpu" and frames.shape == (3, 80, 96)
        assert torch.equal(frames, want)


def _frames(seed=0, B=2, H=40, W=56):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (B, H, W)).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("gaussian_blur", (1.3,)),
    ("gaussian_blur", (0.4,)),
    ("gaussian_blur", (0.0,)),
    ("brightness_gradient", (0.3, True)),
    ("brightness_gradient", (0.5, False)),
    ("gamma_correct", (2.2,)),
    ("vignette", (0.6,)),
])
def test_degradations(name, args):
    x = _frames()
    with jax.enable_x64(False):
        want = np.asarray(getattr(degrade, name)(jnp.asarray(x), *args))
    got = getattr(TDG, name)(torch.as_tensor(x), *args)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_lens_distortion():
    x = _frames(1, H=48, W=64)
    cam = PinholeCamera.from_fov(64, 48, 60.0)
    dist = np.array([-0.25, 0.08, 0.001, -0.002, 0.01], np.float32)
    with jax.enable_x64(False):
        want = np.asarray(degrade.apply_lens_distortion(jnp.asarray(x), jnp.asarray(cam.matrix),
                                                        jnp.asarray(dist)))
    got = TDG.apply_lens_distortion(torch.as_tensor(x), cam.matrix, dist).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got - x).max() > 0.1  # the warp moved pixels


def test_gaussian_noise_statistics():
    """The draws differ from jax.random's by design; the distribution is held."""
    x = torch.full((4, 128, 128), 0.5)
    gen = torch.Generator().manual_seed(0)
    y = TDG.gaussian_noise(x, 0.05, gen)
    n = y - x
    assert abs(float(n.mean())) < 2e-3
    assert float(n.std()) == pytest.approx(0.05, rel=0.05)
    assert torch.equal(y, TDG.gaussian_noise(x, 0.05, torch.Generator().manual_seed(0)))
    clipped = TDG.gaussian_noise(torch.full((2, 64, 64), 0.98), 0.2, gen)
    assert float(clipped.min()) >= 0.0 and float(clipped.max()) <= 1.0
    assert bool((clipped == 1.0).any())
