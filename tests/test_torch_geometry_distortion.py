"""Port parity: the Brown-Conrady helpers, ``se3_compose`` and
``randomize_scene`` against the JAX package; the distortion round trip and
PnP on distorted corners."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.geometry import PinholeCamera, se3_exp
from aprilslam_tpu.geometry import camera as JC
from aprilslam_tpu.geometry.se3 import se3_compose as j_se3_compose
from aprilslam_tpu.sim import config as JConf
from aprilslam_tpu_torch import geometry as TG
from aprilslam_tpu_torch.detect.decode import Detections
from aprilslam_tpu_torch.pose import poses_from_detections
from aprilslam_tpu_torch.sim import DEFAULT_SCENE, randomize_scene

# A typical webcam barrel lens (radial + mild tangential), a 4-vector with
# no k3, a 2-vector (zero-padded), and zeros.
COEFFS = {
    "barrel5": [-0.15, 0.03, 0.0008, -0.0005, 0.0],
    "pincushion5": [0.12, -0.02, -0.0006, 0.0004, 0.004],
    "four": [-0.1, 0.01, 0.0005, 0.0003],
    "two": [-0.08, 0.005],
    "zero": [0.0, 0.0, 0.0, 0.0, 0.0],
}
K = PinholeCamera.from_fov(800, 800, 45.0).matrix


@pytest.mark.parametrize("name", sorted(COEFFS))
def test_distortion_matches_jax(name):
    rng = np.random.default_rng(0)
    dist = np.asarray(COEFFS[name], np.float32)
    xn = rng.uniform(-0.45, 0.45, size=(256, 2)).astype(np.float32)
    px = rng.uniform(60, 740, size=(3, 40, 2)).astype(np.float32)
    with jax.enable_x64(False):
        jd = np.asarray(JC.distort_normalized(jnp.asarray(xn), jnp.asarray(dist)))
        ju = np.asarray(JC.undistort_normalized(jnp.asarray(xn), jnp.asarray(dist)))
        jdp = np.asarray(JC.distort_pixels(jnp.asarray(px), jnp.asarray(K), jnp.asarray(dist)))
        jup = np.asarray(JC.undistort_pixels(jnp.asarray(px), jnp.asarray(K), jnp.asarray(dist)))
    t, tK = torch.as_tensor, torch.as_tensor(K)
    np.testing.assert_allclose(TG.distort_normalized(t(xn), dist).numpy(), jd, atol=1e-6)
    np.testing.assert_allclose(TG.undistort_normalized(t(xn), dist).numpy(), ju, atol=1e-6)
    np.testing.assert_allclose(TG.distort_pixels(t(px), tK, dist).numpy(), jdp, atol=1e-4)
    np.testing.assert_allclose(TG.undistort_pixels(t(px), tK, dist).numpy(), jup, atol=1e-4)
    # round trip, in pixels
    back = TG.undistort_pixels(TG.distort_pixels(t(px), tK, dist), tK, dist)
    np.testing.assert_allclose(back.numpy(), px, atol=1e-4 if name != "zero" else 0)


def test_zero_coefficients_return_the_pixels_bit_for_bit():
    px = torch.as_tensor(np.random.default_rng(1).uniform(0, 800, size=(64, 2)).astype(np.float32))
    assert torch.equal(TG.undistort_pixels(px, torch.as_tensor(K), np.zeros(5, np.float32)), px)
    assert torch.equal(TG.distort_pixels(px, torch.as_tensor(K), np.zeros(5, np.float32)), px)


def test_pnp_undistorts_distorted_corners():
    """Corners projected through a distorting lens: PnP with dist_coeffs
    recovers the pose that PnP without distortion finds on the ideal corners."""
    dist = np.asarray(COEFFS["barrel5"], np.float32)
    rng = np.random.default_rng(2)
    with jax.enable_x64(False):
        T = np.array(se3_exp(jnp.asarray(np.concatenate([rng.normal(scale=0.2, size=(3, 3)),
                                                         rng.normal(scale=3.0, size=(3, 3))], -1),
                                         jnp.float32)))
    T[:, 2, 3] += 60.0
    obj = TG.tag_object_corners(10.0).numpy()
    p = np.einsum("dij,cj->dci", T[:, :3, :3], obj) + T[:, None, :3, 3]
    ideal = (p[..., :2] / p[..., 2:3]) * K[0, 0] + K[:2, 2]
    tK = torch.as_tensor(K)
    distorted = TG.distort_pixels(torch.as_tensor(ideal, dtype=torch.float32), tK, dist)
    ids = torch.arange(3, dtype=torch.int32)[None]

    def det(c):
        return Detections(ids=ids, corners=c[None].to(torch.float32), valid=torch.ones((1, 3), dtype=torch.bool),
                          hamming=torch.zeros((1, 3), dtype=torch.int32), margin=torch.zeros((1, 3)),
                          homography=torch.zeros((1, 3, 3, 3)))

    T_ideal = poses_from_detections(det(torch.as_tensor(ideal)), tK, 10.0)[0]
    T_dist = poses_from_detections(det(distorted), tK, 10.0, dist_coeffs=dist)[0]
    T_raw = poses_from_detections(det(distorted), tK, 10.0)[0]
    np.testing.assert_allclose(T_dist.numpy(), T_ideal.numpy(), atol=2e-3)
    assert np.abs(T_raw.numpy() - T_ideal.numpy()).max() > 10 * np.abs(T_dist.numpy() - T_ideal.numpy()).max()


def test_se3_compose_matches_jax():
    rng = np.random.default_rng(3)
    with jax.enable_x64(False):
        A = np.array(se3_exp(jnp.asarray(rng.normal(size=(5, 6)), jnp.float32)))
        Bm = np.array(se3_exp(jnp.asarray(rng.normal(size=(1, 6)), jnp.float32)))
        want = np.asarray(j_se3_compose(jnp.asarray(A), jnp.asarray(Bm)))
    np.testing.assert_allclose(TG.se3_compose(torch.as_tensor(A), torch.as_tensor(Bm)).numpy(), want,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 5, 7, 123])
def test_randomize_scene_matches_jax(seed):
    with open(DEFAULT_SCENE) as f:
        raw = json.load(f)
    before = json.dumps(raw)
    for pct in (0.1, 0.25):
        assert randomize_scene(raw, pct, seed=seed) == JConf.randomize_scene(raw, pct, seed=seed)
    assert json.dumps(raw) == before  # the input is not modified
