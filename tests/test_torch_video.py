"""The port's video replay against the JAX package's: the video app on the
JAX test's Y4M scenario, the config-4 replay (Y4M -> batched detect -> PnP)
on JAX-rendered 640x480 frames, and the app on a calibration file with
non-zero distortion.

Tolerances: ids and ok flags equal; app report translations within 1e-3
(the log's own precision) and angles within 0.1 degree; replay poses within
1e-3 in rotation and 1e-3 relative in translation."""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu import sim as JSIM
from aprilslam_tpu.apps import video_detection as JVIDEO
from aprilslam_tpu.detect import DetectorParams as JParams
from aprilslam_tpu.detect import TagDetector as JDetector
from aprilslam_tpu.geometry import PinholeCamera
from aprilslam_tpu.pose import poses_from_detections as j_poses
from aprilslam_tpu_torch.apps import video_detection as TVIDEO
from aprilslam_tpu_torch.calib import board_points, calibrate_camera
from aprilslam_tpu_torch.detect import DetectorParams, TagDetector
from aprilslam_tpu_torch.ops import ccl
from aprilslam_tpu_torch.pose import poses_from_detections
from aprilslam_tpu_torch.runtime import Y4MReader
from aprilslam_tpu_torch.sim import SceneConfig

TAG_LINE = re.compile(r"tag (-?\d+): dist (\S+) m  xyz \[(\S+) (\S+) (\S+)\]  rpy \[\s*(\S+)\s+(\S+)\s+(\S+)\]")
# bench.py's config-4 clip: 640x480, waypoints, supersample 2.
CLIP_WAYPOINTS = np.array([[0.0, 0.0, 20.0], [8.0, 2.0, 5.0], [0.0, -2.0, 15.0]])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _write_y4m(path, frames):
    n, H, W = frames.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F25:1 Cmono\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
    return str(path)


def _jax_frames(cfg, cam, positions, rotations, ss=2):
    frames = np.asarray(JSIM.render_frames(
        JSIM.scene_tensors(cfg), jnp.asarray(positions), jnp.asarray(rotations),
        jnp.asarray(cam.inv_matrix), cam.height, cam.width, ss))
    return np.clip(frames * 255.0, 0, 255).astype(np.uint8)


def _tag_lines(caplog):
    rows = []
    for r in caplog.records:
        m = TAG_LINE.fullmatch(r.getMessage())
        if m:
            rows.append((int(m.group(1)), np.array([float(x) for x in m.groups()[1:]])))
    return rows


@pytest.fixture(scope="module")
def app_scenario(tmp_path_factory):
    """tests/test_apps.py's video scenario: the default scene at 256x256,
    four frames of a scripted line, an all-zero calibration."""
    tmp = tmp_path_factory.mktemp("video")
    cfg = JSIM.SceneConfig.from_file()
    cam = PinholeCamera.from_fov(256, 256, cfg.fov_y)
    traj = JSIM.trajectory.scripted_line(4, np.array([0.0, 0.0, 20.0]), np.array([4.0, 1.0, 10.0]))
    y4m = _write_y4m(tmp / "seq.y4m", _jax_frames(cfg, cam, traj.positions, traj.rotations))
    calib = tmp / "cal.npz"
    np.savez(calib, camera_matrix=cam.matrix, dist_coeffs=np.zeros(5, np.float32))
    return cfg, cam, tmp, y4m, calib


def _argv(app_scenario, calib=None, batch=4, max_frames=4):
    cfg, _cam, _tmp, y4m, default_calib = app_scenario
    return ["--source", y4m, "--calibration", str(calib or default_calib), "--family", cfg.family,
            "--tag-size", str(cfg.tag_size_inner), "--batch", str(batch),
            "--max-frames", str(max_frames), "--device", "cpu", "--decimate", "1"]


def test_video_app_reports_what_the_jax_app_reports(app_scenario, caplog):
    argv = _argv(app_scenario)
    with caplog.at_level(logging.INFO):
        assert TVIDEO.main(argv) == 0
    ours = _tag_lines(caplog)
    assert "Processed 4 frames" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert JVIDEO.main(argv) == 0
    ref = _tag_lines(caplog)
    assert len(ours) >= 4, ours
    # Lines come frame by frame, each frame's tags in id order.
    assert [i for i, _ in ours] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        np.testing.assert_allclose(a[:4], b[:4], atol=1e-3 + 1e-9)  # dist and xyz, 3 decimals
        # rpy, 1 decimal; a roll of +180.0 and one of -180.0 are the same angle.
        np.testing.assert_allclose((a[4:] - b[4:] + 180.0) % 360.0 - 180.0, 0.0, atol=0.1 + 1e-9)


def test_video_app_leaves_a_partial_last_batch_undetected(app_scenario, caplog):
    """As in the JAX app: 4 frames at batch 3 detect the first 3 only."""
    argv = _argv(app_scenario, batch=3, max_frames=0)
    with caplog.at_level(logging.INFO):
        assert TVIDEO.main(argv) == 0
    n_three = len(_tag_lines(caplog))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert JVIDEO.main(argv) == 0
    assert len(_tag_lines(caplog)) == n_three > 0
    assert "Processed 4 frames" in caplog.text


def test_video_app_runs_on_a_calibration_with_distortion(app_scenario, caplog):
    """A calibration file written by the port's ``calibrate_camera`` with
    non-zero distortion ((1, 5) coefficients): the port's app undistorts the
    corners and reports poses. The JAX app raises on the same file, since
    its ``undistort_pixels`` does not broadcast (1, 5) coefficients."""
    _cfg, cam, tmp, _y4m, _calib = app_scenario
    K = cam.matrix.astype(np.float64)
    obj = board_points(10, 7, 5.0)
    rng = np.random.default_rng(5)
    views = []
    for _ in range(6):
        w = rng.normal(scale=0.2, size=3)
        R = torch.linalg.matrix_exp(torch.tensor([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])).numpy()
        p = obj @ R.T + [-22.0, -15.0, rng.uniform(150, 200)]
        xy = p[:, :2] / p[:, 2:3]
        xy = xy * (1 + 0.01 * np.sum(xy**2, axis=-1, keepdims=True))
        views.append((xy * [K[0, 0], K[1, 1]] + K[:2, 2]).astype(np.float32))
    res = calibrate_camera(obj, views, device="cpu")
    assert abs(res.dist_coeffs[0]) > 1e-3
    calib = tmp / "distorted.npz"
    res.save_npz(str(calib))
    argv = _argv(app_scenario, calib=calib)
    loaded_K, dist = TVIDEO.load_camera_calibration(str(calib))
    assert loaded_K.shape == (3, 3) and dist.shape == (1, 5)
    with caplog.at_level(logging.INFO):
        assert TVIDEO.main(argv) == 0
    rows = _tag_lines(caplog)
    assert len(rows) >= 4 and all(np.isfinite(r).all() for _, r in rows)
    with pytest.raises(ValueError):
        JVIDEO.main(argv)


def test_video_app_missing_y4m_raises(tmp_path):
    """A missing ``.y4m`` file is an error of the native reader, not of cv2."""
    with pytest.raises(OSError):
        TVIDEO.main(["--source", str(tmp_path / "none.y4m"), "--device", "cpu"])


def test_config4_replay_matches_jax(tmp_path):
    """16 frames of the config-4 clip (bench.py's video leg), JAX-rendered,
    through each package's replay: read by 8, detect, PnP."""
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(640, 480, cfg.fov_y)
    traj = JSIM.trajectory.scripted_waypoints(64, CLIP_WAYPOINTS)
    frames = _jax_frames(JSIM.SceneConfig.from_file(), cam, traj.positions[:16], traj.rotations[:16])
    path = _write_y4m(tmp_path / "clip.y4m", frames)

    jdet = JDetector(cfg.family, JParams(quad_decimate=2, min_cluster_pts=12, max_detections=16))
    tdet = TagDetector(cfg.family, DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16),
                       device="cpu")
    K = torch.as_tensor(cam.matrix)
    ours, ref = {}, {}
    before = ccl.ccl_launches
    with Y4MReader(path) as r:
        k = 0
        while (b := r.read_batch(8)).shape[0]:
            np.testing.assert_array_equal(b, frames[k:k + 8])
            det = tdet.detect(torch.from_numpy(b))
            T, ok = poses_from_detections(det, K, cfg.tag_size_inner)[:2]
            jd = jdet.detect(jnp.asarray(b))
            jT, jok = j_poses(jd, jnp.asarray(cam.matrix), cfg.tag_size_inner)[:2]
            for side, (ids, Ts, oks) in ((ours, (det.ids.numpy(), T.numpy(), ok.numpy())),
                                         (ref, (np.asarray(jd.ids), np.asarray(jT), np.asarray(jok)))):
                for f, d in zip(*np.nonzero(oks)):
                    side[(k + f, int(ids[f, d]))] = Ts[f, d]
            k += b.shape[0]
    assert k == 16 and ccl.ccl_launches == before  # CPU tensors take the plain CCL
    assert set(ours) == set(ref) and len(ours) >= 16
    for key, T in ours.items():
        np.testing.assert_allclose(T[:3, :3], ref[key][:3, :3], atol=1e-3)
        np.testing.assert_allclose(T[:3, 3], ref[key][:3, 3], rtol=1e-3, atol=1e-3)
