"""Port parity: planar PnP on the JAX detector's detections.

ok / seed_ok are compared exactly; poses to a tolerance: the LM steps solve
6x6 systems in float32 with a Jacobian from reverse mode here and forward
mode there, so poses agree to float32 round-off amplified by the solve.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams, detect_fn
from aprilslam_tpu.geometry import PinholeCamera
from aprilslam_tpu.pose import pnp as JP
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu_torch.detect.decode import Detections
from aprilslam_tpu_torch.pose import pnp as TP

RES = 384


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def ref():
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    traj = trajectory.scripted_line(4, np.array([0.0, 0.0, 20.0]), np.array([8.0, 2.0, -10.0]))
    params = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
    with jax.enable_x64(False):
        frames = render_frames(scene_tensors(cfg), jnp.asarray(traj.positions),
                               jnp.asarray(traj.rotations), jnp.asarray(cam.inv_matrix), RES, RES, 2)
        u8 = jnp.clip(frames * 255.0, 0, 255).astype(jnp.uint8)
        det = jax.jit(detect_fn(cfg.family, params))(u8)
        K = jnp.asarray(cam.matrix)
        poses = {it: jax.device_get(JP.poses_from_detections(det, K, cfg.tag_size_inner, iters=it))
                 for it in (3, 8)}
        det = jax.device_get(det)
    tdet = Detections(**{k: t(getattr(det, k)) for k in
                         ("ids", "corners", "valid", "hamming", "margin", "homography")})
    return SimpleNamespace(cfg=cfg, K=cam.matrix, det=det, tdet=tdet, poses=poses)


@pytest.mark.parametrize("iters", [3, 8])
def test_poses_from_detections(ref, iters):
    T, ok, rms, seed, T_alt = TP.poses_from_detections(ref.tdet, t(ref.K), ref.cfg.tag_size_inner,
                                                      iters=iters)
    jT, jok, jrms, jseed, jT_alt = ref.poses[iters]
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(seed.numpy(), jseed)
    assert jok.sum() >= 8
    m = jok
    # A near-frontal tag's two branches lie within ~1e-3 rad of each other
    # and round-off decides which fits better, so each pose must match one of
    # the reference's two branches, and the other one must match the other.
    Tt, Ta = T.numpy()[m], T_alt.numpy()[m]
    jb, ja = jT[m], jT_alt[m]

    def err(a, b):
        return np.abs(a - b).max(axis=(-2, -1))

    same = np.maximum(err(Tt, jb), err(Ta, ja))
    swapped = np.maximum(err(Tt, ja), err(Ta, jb))
    assert np.all(np.minimum(same, swapped) < 2e-3), (same, swapped)
    assert np.all(err(Tt[:, :3, :3], jb[:, :3, :3]) < 2e-3)
    np.testing.assert_allclose(rms.numpy()[m], jrms[m], atol=2e-3)


def test_ippe_and_translation_random():
    """IPPE candidates and least-squares translations on homographies of
    random tilted tag poses."""
    rng = np.random.default_rng(0)
    cam = PinholeCamera.from_fov(640, 480, 45.0)
    K = cam.matrix
    obj = np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]], np.float32)
    with jax.enable_x64(False):
        from aprilslam_tpu.geometry import so3_exp
        R = np.asarray(so3_exp(jnp.asarray(rng.normal(scale=0.4, size=(32, 3)).astype(np.float32))))
    tt = np.concatenate([rng.uniform(-8, 8, (32, 2)), rng.uniform(40, 90, (32, 1))], -1).astype(np.float32)
    p = obj @ R.transpose(0, 2, 1) + tt[:, None]
    corners = (p[..., :2] / p[..., 2:3]) * K[0, 0] + K[:2, 2]
    corners = corners.astype(np.float32)
    res_t = TP.solve_planar_pnp_dual(t(corners), t(K), 10.0, iters=3)
    with jax.enable_x64(False):
        res_j = jax.device_get(JP.solve_planar_pnp_dual(jnp.asarray(corners), jnp.asarray(K), 10.0, iters=3))
        Kinv = np.linalg.inv(K).astype(np.float32)
        from aprilslam_tpu.detect.decode import homography_from_corners as jh
        Hq = jh(jnp.asarray(corners))
        S = jnp.asarray([[0.2, 0, 0], [0, -0.2, 0], [0, 0, 1]], jnp.float32)
        jR2 = np.asarray(JP._ippe_rotations(Hq @ S, jnp.asarray(Kinv)))
        jt = np.asarray(JP._translation_for_rotation(jnp.asarray(jR2), jnp.asarray(obj),
                                                     jnp.asarray(corners)[:, None].repeat(2, 1),
                                                     jnp.asarray(Kinv)))
    from aprilslam_tpu_torch.detect.decode import homography_from_corners as th
    tR2 = TP._ippe_rotations(th(t(corners)) @ t(np.asarray(S)), t(Kinv))
    np.testing.assert_allclose(tR2.numpy(), jR2, atol=1e-4)
    tt2 = TP._translation_for_rotation(tR2, t(obj), t(corners)[:, None].expand(32, 2, 4, 2), t(Kinv))
    np.testing.assert_allclose(tt2.numpy(), jt, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res_t.T.numpy(), res_j.T, rtol=1e-3, atol=1e-3)
    # Exact corners: both branches fit to sub-millipixel rms, the truth wins.
    np.testing.assert_allclose(res_t.T.numpy()[:, :3, 3], tt, rtol=1e-3)
