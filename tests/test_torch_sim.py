"""Port parity: simulator (scene config, trajectories, ground truth, rasterizer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.geometry import PinholeCamera
from aprilslam_tpu.sim import (
    SceneConfig, camera_in_tag_frames, camera_to_tag_transforms, render_frames, scene_tensors,
    trajectory,
)
from aprilslam_tpu_torch import sim as TS


def test_scene_config():
    a, b = SceneConfig.from_file(), TS.SceneConfig.from_file()
    np.testing.assert_array_equal(b.tag_ids(), a.tag_ids())
    np.testing.assert_array_equal(b.tag_positions(), a.tag_positions())
    np.testing.assert_array_equal(b.tag_rotations(), a.tag_rotations())
    for k in ("display_width", "fov_y", "tag_size_inner", "tag_size_outer", "family", "background"):
        assert getattr(b, k) == getattr(a, k), k


def test_trajectories():
    way = np.array([[0.0, 0.0, 10.0], [6.0, 1.0, 4.0], [2.0, -1.0, 12.0]])
    for ja, tb in [(trajectory.scripted_line(17), TS.trajectory.scripted_line(17)),
                   (trajectory.scripted_waypoints(23, way), TS.trajectory.scripted_waypoints(23, way))]:
        np.testing.assert_array_equal(tb.positions, ja.positions)
        np.testing.assert_array_equal(tb.rotations, ja.rotations)
    # monte_carlo draws from numpy, not jax.random: same bounds, not the same bits.
    mc = TS.trajectory.monte_carlo(256, seed=3)
    b = TS.trajectory.REFERENCE_BOUNDS
    assert mc.positions.dtype == np.float32 and mc.positions.shape == (256, 3)
    assert np.all((mc.positions >= b[:, 0]) & (mc.positions <= b[:, 1]))
    np.testing.assert_array_equal(mc.positions, TS.trajectory.monte_carlo(256, seed=3).positions)
    assert not np.allclose(mc.positions, TS.trajectory.monte_carlo(256, seed=4).positions)


def test_reference_pool_is_the_jax_headline_pool():
    with jax.enable_x64(False):
        want = trajectory.monte_carlo(512, seed=3)
    got = TS.trajectory.reference_pool()
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.rotations, want.rotations)
    assert got.positions.dtype == want.positions.dtype


@pytest.mark.parametrize("rotated", [False, True])
def test_ground_truth(rotated):
    rng = np.random.default_rng(7)
    cfg = SceneConfig.from_file()
    cam_pos = rng.uniform(-20, 20, size=(16, 3)).astype(np.float32)
    cam_rot = rng.uniform(-30, 30, size=(16, 3)).astype(np.float32) if rotated else None
    args = [cfg.tag_positions(), cfg.tag_rotations(), cam_pos] + ([cam_rot] if rotated else [])
    for fj, ft in [(camera_to_tag_transforms, TS.camera_to_tag_transforms),
                   (camera_in_tag_frames, TS.camera_in_tag_frames)]:
        with jax.enable_x64(False):
            a = np.asarray(fj(*[jnp.asarray(x) for x in args]))
        b = ft(*[torch.as_tensor(x) for x in args]).numpy()
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-6)


def test_render_frames_match():
    """Same scene and poses, rendered by both: the cell lookup is a floor of
    a float32 ratio, so a pixel can only differ where a sample point falls
    on a cell edge within round-off; bound the share and the mean."""
    cfg = SceneConfig.from_file()
    H, W = 120, 160
    cam = PinholeCamera.from_fov(W, H, cfg.fov_y)
    traj = trajectory.scripted_waypoints(3, np.array([[0.0, 0.0, 10.0], [10.0, 2.0, -20.0]]))
    rot = np.array([[0.0, 0.0, 0.0], [5.0, -10.0, 3.0], [-4.0, 12.0, 0.0]], np.float32)
    with jax.enable_x64(False):
        a = np.asarray(render_frames(scene_tensors(cfg), jnp.asarray(traj.positions),
                                     jnp.asarray(rot), jnp.asarray(cam.inv_matrix), H, W, 2))
    b = TS.render_frames(TS.scene_tensors(TS.SceneConfig.from_file(), device="cpu"),
                         traj.positions, rot, cam.inv_matrix, H, W, 2, device="cpu").numpy()
    assert b.shape == a.shape == (3, H, W) and b.dtype == np.float32
    assert np.abs(a - b).mean() < 1e-3
    assert (a != b).mean() < 0.01
    assert len(np.unique(b)) > 2  # the tags are in view
